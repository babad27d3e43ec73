"""Execution planner + telemetry (the port of ``repro.planner``).

- ``planner.telemetry`` — :class:`CommLog` counter seam: per-call
  :class:`ApssStats` records (collective bytes per hop, modeled FLOPs,
  live-tile fraction/imbalance) emitted by every APSS entry point.
- ``planner.costmodel`` — closed-form per-variant cost models sharing the
  telemetry hop formulas, parameterized by a :class:`CalibrationProfile`.
- ``planner.calibrate`` — one-shot microbenchmark on this machine's device,
  cached to JSON keyed by device kind.
- ``planner.plan`` — :func:`plan_apss` ranks every valid
  ``(variant, block_rows, use_kernel)`` configuration by modeled cost;
  ``similarity_topk(..., variant="auto")``, ``apss(...,
  distribution="auto")``, ``build_index(..., plan=...)`` and
  ``query_topk(..., plan=...)`` dispatch through it.

Exports resolve lazily so that ``core``/``serving`` modules can import
``planner.telemetry`` without pulling the planner (and its ``core``
imports) into every start.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "CommLog": ".telemetry",
    "ApssStats": ".telemetry",
    "CalibrationProfile": ".costmodel",
    "CorpusSummary": ".costmodel",
    "CostEstimate": ".costmodel",
    "QueryPlan": ".costmodel",
    "VariantConfig": ".costmodel",
    "default_profile": ".costmodel",
    "estimate_cost": ".costmodel",
    "mesh_sizes": ".costmodel",
    "plan_query_topk": ".costmodel",
    "Plan": ".plan",
    "plan_apss": ".plan",
    "execute": ".plan",
    "summarize_corpus": ".plan",
    "candidate_configs": ".plan",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        mod = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod, __name__), name)
