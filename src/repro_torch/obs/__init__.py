"""Observability: tracing, metrics, their export and the flight recorder.

Four small modules with one guard discipline (``enabled()`` stacks, as in
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
  falls back past a corrupt step.

They are the reference's ``repro.obs`` modules of the same names. Its
``compile`` (jit retrace contracts, which eager PyTorch has no counterpart
of), ``audit`` and ``drift`` modules are not ported here.
"""

from repro_torch.obs import export, metrics, recorder, trace  # noqa: F401
from repro_torch.obs.export import write_chrome_trace, write_metrics  # noqa: F401
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: F401
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401
from repro_torch.obs.trace import Span, Tracer, annotate, event, span  # noqa: F401

__all__ = [
    "trace", "metrics", "export", "recorder",
    "Tracer", "Span", "span", "event", "annotate",
    "MetricsRegistry", "Histogram",
    "FlightRecorder",
    "write_chrome_trace", "write_metrics",
]
