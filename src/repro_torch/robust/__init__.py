"""Deterministic fault injection (:mod:`repro_torch.robust.faults`): the
seams the servers and the live index call, and the faults tests arm.

The reference's ``robust.sweep`` (resumable sweeps, eviction) is not
ported here."""

from repro_torch.robust.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    InjectedFault,
    SweepKilled,
)
