"""A resumable sweep (``robust.sweep``) over ranks, killed, a straggler
evicted, and resumed on the survivors.

:func:`run_ranks` is a rank function for ``launch.mesh.spawn``. Every rank
loads the corpus (a ``.npy``, memory-mapped), builds a 1-D mesh over every
rank and runs :class:`~repro_torch.robust.ResumableSweep` with its own
``StepTimer`` and a ``FaultPlan`` of ``faults`` (a kill at a step, a delay
on one rank). When the sweep is killed, every rank takes the gathered
ledger's report, shrinks the mesh with ``mesh_after_eviction`` and
resumes on the survivors, with no faults and a fresh timer. Per rank it
returns what it saw (``killed``, ``evict``, ``rank_ema``, ``fired``, the
blocks it scored before and after, ``resumed_from``, seconds per part)
and, on rank 0 of the last mesh, the global ``Matches`` as numpy.

A run of 4 ranks on one card, killed at step 27 with rank 1 slowed by
0.2 s at every step (the corpus saved as ``corpus.npy``):

    from repro_torch.launch.mesh import spawn
    from repro_torch.robust import Fault

    outs = spawn("repro_torch.launch.sweep:run_ranks", 4, "corpus.npy", "ckpt",
                 dict(threshold=0.2, k=32, block_rows=128),
                 [Fault("kill", step=27), Fault("delay", rank=1, seconds=0.2, times=-1)])
    values, indices, counts = outs[0]["matches"]

(``device="cpu"`` runs the ranks on the CPU over gloo.) A script that
calls ``spawn`` needs an ``if __name__ == "__main__"`` guard.
"""

from __future__ import annotations

import time

import numpy as np


def run_ranks(rank, world, dev, corpus_path: str, directory: str, kw: dict,
              faults: list) -> dict:
    """Rank function (``launch.mesh.spawn``); see the module docstring."""
    from repro_torch.distributed.straggler import StepTimer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.robust import FaultPlan, ResumableSweep, SweepKilled, mesh_after_eviction

    D = np.load(corpus_path, mmap_mode="r")
    mesh = make_mesh((world,), ("data",))
    plan = FaultPlan(list(faults))
    t0 = time.perf_counter()
    sweep = ResumableSweep(D, directory=directory, mesh=mesh, fault_plan=plan,
                           timer=StepTimer(), device=dev, **kw)
    out = dict(rank=rank, sharded=sweep.sharded, blocks=sweep.blocks.tolist(),
               setup_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    try:
        got = sweep.run()
        out["killed"] = False
    except SweepKilled:
        got = None
        out["killed"] = True
    out["run_s"] = time.perf_counter() - t0
    report = sweep.timer.report()
    out.update(evict=list(report.evict), rank_ema=dict(report.rank_ema), fired=dict(plan.fired))
    if got is None:
        t0 = time.perf_counter()
        resumed = sweep.resume_on(mesh_after_eviction(mesh, report))
        resumed.fault_plan, resumed.timer = None, StepTimer()
        got = resumed.run()
        out.update(resumed=resumed.member, resumed_from=resumed.resumed_from,
                   resume_s=time.perf_counter() - t0)
        if resumed.member:
            out.update(resumed_ranks=resumed.p, resumed_sharded=resumed.sharded,
                       resumed_blocks=resumed.blocks.tolist())
            sweep = resumed
    if got is not None and sweep.rank == 0:
        out["matches"] = tuple(x.cpu().numpy() for x in got)
    return out
