"""Robustness: deterministic fault injection (:mod:`repro_torch.robust.faults`,
the seams the servers, the live index and the sweep call) and resumable,
elastic sweeps (:mod:`repro_torch.robust.sweep`: ``ResumableSweep``, a
checkpointed block ring on K4, and ``mesh_after_eviction``)."""

from repro_torch.robust.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    InjectedFault,
    SweepKilled,
)
from repro_torch.robust.sweep import (  # noqa: F401
    ResumableSweep,
    mesh_after_eviction,
)
