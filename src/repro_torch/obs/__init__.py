"""Observability: tracing, metrics, their export, the flight recorder,
drift detection, the build/load monitor and the model-vs-program audit.

Seven small modules with one guard discipline (``enabled()`` stacks, as in
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
  planner's records against their spans, and stale-calibration flagging;
- :mod:`repro_torch.obs.compile` -- the kernel libraries' build/load
  registry (``CompileMonitor``), ``assert_no_retrace`` contracts, measured
  calls under the op census (``measure``) and call-site capture;
- :mod:`repro_torch.obs.audit` -- the model-vs-program audit over every
  plannable variant family.

They are the reference's ``repro.obs`` modules of the same names; where
the reference's ``compile`` and ``audit`` rest on XLA (jit retraces, HLO),
the port's count library builds and loads and an eager op census (each
module's doc says how). ``compile`` and ``audit`` are imported on first
use (``obs.compile``, ``obs.audit``): the audit pulls in the planner and
serving layers, which the runtime hot paths must not.
"""

from repro_torch.obs import drift, export, metrics, recorder, trace  # noqa: F401
from repro_torch.obs.drift import DriftReport, Residual, drift_report  # noqa: F401
from repro_torch.obs.export import write_chrome_trace, write_metrics  # noqa: F401
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: F401
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401
from repro_torch.obs.trace import Span, Tracer, annotate, event, span  # noqa: F401

__all__ = [
    "trace", "metrics", "export", "recorder", "drift", "compile", "audit",
    "Tracer", "Span", "span", "event", "annotate",
    "MetricsRegistry", "Histogram",
    "FlightRecorder",
    "CompileMonitor", "CompileRecord", "RetraceError", "assert_no_retrace",
    "DriftReport", "Residual", "drift_report",
    "write_chrome_trace", "write_metrics",
]


_COMPILE_NAMES = ("CompileMonitor", "CompileRecord", "RetraceError", "assert_no_retrace")


def __getattr__(name):
    import importlib

    if name in ("compile", "audit"):
        return importlib.import_module(f"repro_torch.obs.{name}")
    if name in _COMPILE_NAMES:
        return getattr(importlib.import_module("repro_torch.obs.compile"), name)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
