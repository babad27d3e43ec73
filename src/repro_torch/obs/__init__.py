"""Observability: tracing, metrics, their export, the flight recorder and
drift detection.

Five small modules with one guard discipline (``enabled()`` stacks, as in
``planner.telemetry``: nothing is recorded and nothing costs more than a
list check when no sink is active):

- :mod:`repro_torch.obs.trace` -- a context-propagated span tree (serving
  lifecycle, live-index WAL ops and replay, checkpoints, ring steps through
  ``StepTicker``), on host clocks;
- :mod:`repro_torch.obs.metrics` -- counters, gauges and exponential
  histograms, absorbing the ``telemetry.incr`` namespace;
- :mod:`repro_torch.obs.export` -- Chrome trace-event JSON (Perfetto) and
  metrics snapshots (JSON or Prometheus text);
- :mod:`repro_torch.obs.recorder` -- a bounded flight recorder dumped when
  a fault fires, the serving ladder drops a tier, or a checkpoint restore
  falls back past a corrupt step;
- :mod:`repro_torch.obs.drift` -- predicted-vs-measured residuals of the
  planner's records against their spans, and stale-calibration flagging.

They are the reference's ``repro.obs`` modules of the same names. Its
``compile`` and ``audit`` modules (jit retrace contracts and the
model-vs-HLO audit) rest on XLA and are ROADMAP queue 1 item 7b.
"""

from repro_torch.obs import drift, export, metrics, recorder, trace  # noqa: F401
from repro_torch.obs.drift import DriftReport, Residual, drift_report  # noqa: F401
from repro_torch.obs.export import write_chrome_trace, write_metrics  # noqa: F401
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: F401
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401
from repro_torch.obs.trace import Span, Tracer, annotate, event, span  # noqa: F401

__all__ = [
    "trace", "metrics", "export", "recorder", "drift",
    "Tracer", "Span", "span", "event", "annotate",
    "MetricsRegistry", "Histogram",
    "FlightRecorder",
    "DriftReport", "Residual", "drift_report",
    "write_chrome_trace", "write_metrics",
]
