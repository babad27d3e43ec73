"""A cell on several cards: one rank a card, each a process of its own.

:func:`run_cell_ranks` (``run.py``) and :func:`control_readings`
(``control.py``) take a cell whose ``chips`` is more than 1. :func:`launch`
starts ``chips`` ranks with ``torch.multiprocessing`` (the spawn method,
since CUDA does not survive a fork). Rank ``r`` takes card ``r``
(``torch.cuda.set_device``), joins the default process group (NCCL on
cards, gloo on the CPU) through a ``file://`` store in a fresh temporary
directory, so that the port's ``launch.mesh.make_mesh`` works inside a
driver, and joins one gloo side group that carries only the harness's own
barriers, the window's go-on signal and the records. Every collective of
both groups times out after ``timeout_s`` seconds.

The ranks then run :func:`harness.run_cell` (or ``control.readings``) with a
:class:`Lockstep`: the same phases on every rank, a barrier between them;
after each step of the window rank 0 tells every rank whether the window
goes on; once it closes, each rank sends rank 0 its :class:`harness.Card`
(peak, trace, spans), frees its state and ends, and rank 0 reports and
judges. So a driver's step gathers the answer to rank 0 itself, and its
``free`` and ``judge`` call no collective.

A rank that raises or exits non-zero ends the run: the others are stopped
and :func:`launch` raises. A rank that hangs leaves the others waiting in a
collective, which times out, and ends the run the same way. No rank
outlives the process that launched it: each asks the kernel for SIGKILL
when its parent dies. Each rank lists the JAX modules it holds once its
part has ended, and :func:`launch` returns them with rank 0's result.
"""

from __future__ import annotations

import ctypes
import json
import os
import pickle
import shutil
import signal
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from apssbench import harness

COLLECTIVE_TIMEOUT_S = 180.0  # a collective that waits longer raises instead of hanging
JOIN_TIMEOUT_S = 1800.0       # the ranks' whole run, a checkout's first (compiling) run too
GRACE_S = 2.0                 # a failed run's other ranks, to end before they are killed


class Lockstep:
    """A rank's place in a run of several: its number, the world, its
    device, and the gloo side group of the harness's own messages."""

    def __init__(self, rank: int, world: int, device: str, side):
        self.rank, self.world, self.device, self.side = rank, world, device, side

    def barrier(self) -> None:
        """Wait until every rank's card and every rank are here."""
        if self.device.startswith("cuda"):
            torch.cuda.synchronize(self.device)
        dist.barrier(group=self.side)

    def go_on(self, go: bool) -> bool:
        """Rank 0's ``go`` on every rank."""
        flag = torch.tensor([int(go)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.side)
        return bool(flag.item())

    def gather(self, record) -> list | None:
        """Every rank's ``record`` in rank order on rank 0; ``None`` on the others."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(record, out, dst=0, group=self.side)
        return out


def run_cell_ranks(root, workload: str, *, seed: int, seconds: float, trace: bool,
                   device: str = "cuda", t_start: float | None = None,
                   timeout_s: float = COLLECTIVE_TIMEOUT_S) -> tuple[dict, list[str]]:
    """One run of a cell on its ``chips`` ranks: rank 0's result line
    object, and the JAX modules that any rank held at its end. ``t_start``
    is this process's ``time.perf_counter()`` at its start: on Linux the
    system-wide monotonic clock, so rank 0's ``setup_s`` counts the ranks'
    start too."""
    cell = harness.load_cell(root, workload)
    cell.driver()  # a driver that does not take ranks is refused before any rank starts
    t_start = time.perf_counter() if t_start is None else t_start
    return launch(_cell_rank, cell.chips, str(root), workload, seed, seconds, trace, t_start,
                  device=device, timeout_s=timeout_s)


def control_readings(root, workload: str, seed: int, *, device: str, control: bool) -> dict:
    """``control.readings`` of one seed on the cell's ranks: the program on
    every rank, the judge and the control on rank 0."""
    cell = harness.load_cell(root, workload)
    cell.driver()
    return launch(_control_rank, cell.chips, str(root), workload, seed, control, device=device)[0]


def _cell_rank(me: Lockstep, root, workload, seed, seconds, trace, t_start):
    return harness.run_cell(Path(root), workload, seed=seed, seconds=seconds, trace=trace,
                            device=me.device, t_start=t_start, lockstep=me)


def _control_rank(me: Lockstep, root, workload, seed, control):
    from apssbench.control import readings

    return readings(Path(root), workload, seed, device=me.device, control=control, lockstep=me)


def launch(fn, chips: int, *args, device: str, timeout_s: float = COLLECTIVE_TIMEOUT_S):
    """``fn(lockstep, *args)`` on ``chips`` spawned ranks (``fn`` a
    module-level function): rank 0's return value, and the sorted JAX
    modules that any rank held at its end. Raises where a rank raises,
    exits non-zero or dies, and ``TimeoutError`` after
    ``JOIN_TIMEOUT_S``; no rank is left running either way."""
    import torch.multiprocessing as mp

    run_dir = Path(tempfile.mkdtemp(prefix="apssbench-ranks-"))
    try:
        ctx = mp.start_processes(
            _rank_main, args=(chips, str(run_dir), os.getpid(), device, timeout_s, fn, args),
            nprocs=chips, join=False, start_method="spawn")
        try:
            deadline = time.monotonic() + JOIN_TIMEOUT_S
            while not ctx.join(timeout=1.0, grace_period=GRACE_S):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {JOIN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=30)
        with open(run_dir / "result.pkl", "rb") as f:  # written by rank 0 of this run
            result = pickle.load(f)
        found = set()
        for rank in range(chips):
            found |= set(json.loads((run_dir / f"modules-{rank}.json").read_text()))
        return result, sorted(found)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _die_with(parent: int) -> None:
    """SIGKILL for this process when its parent dies (Linux ``prctl``)."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong, ctypes.c_ulong,
                           ctypes.c_ulong]
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(1, signal.SIGKILL, 0, 0, 0) != 0:  # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != parent:  # the parent died before the request
        os._exit(1)


def _rank_main(rank, world, run_dir, parent, device, timeout_s, fn, args):
    _die_with(parent)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"file://{run_dir}/store",
                            world_size=world, rank=rank, timeout=timeout)
    try:
        side = dist.new_group(backend="gloo", timeout=timeout)
        out = fn(Lockstep(rank, world, f"cuda:{rank}" if on_card else device, side), *args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(Path(run_dir) / "result.pkl", "wb") as f:
            pickle.dump(out, f)
    found = harness.forbidden_modules()
    (Path(run_dir) / f"modules-{rank}.json").write_text(json.dumps(found))
