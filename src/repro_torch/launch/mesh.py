"""Meshes of ranks over ``torch.distributed``: the port's counterpart of
``repro/launch/mesh.py`` and ``repro.compat.make_mesh``.

A JAX mesh is one program over many devices. Here every rank of a process
group runs the same program, and a ``DeviceMesh`` with named axes gives
each axis its process group (``mesh.get_group(axis)``) and this rank's
place on it (``mesh.get_local_rank(axis)``, the counterpart of
``lax.axis_index``).

:func:`spawn` starts ``p`` ranks on one host and runs one function in each:

    results = spawn("mypkg.jobs:job", 4, "corpus.npy", device="cpu")

calls ``job(rank, world, device, "corpus.npy")`` in 4 processes (started
with the ``spawn`` method, since CUDA does not survive a fork) and returns
their return values in rank order. The function is named by import path so
that a fresh interpreter can find it. Each rank's device is
``cuda:(rank % device_count)`` for ``device="cuda"``, so 4 ranks share one
card; NCCL takes no two ranks on one card, so they then run over gloo.

Nothing here runs at import time.
"""

from __future__ import annotations

import importlib
import os
import pickle
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Sequence

import torch
import torch.distributed as dist

PG_TIMEOUT_S = 120.0    # a collective that waits longer raises instead of hanging
JOIN_TIMEOUT_S = 900.0  # the whole run of the ranks


def make_mesh(shape: Sequence[int], names: Sequence[str], *, ranks: Sequence[int] | None = None):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the initialised
    process group (row-major over the ranks, as ``jax.make_mesh`` lays out
    devices). Its groups use the default group's backend; under gloo the
    mesh is a CPU mesh and the collectives stage CUDA tensors through host
    memory (``core.distributed``). With ``ranks`` (global ranks, row-major)
    it is a mesh over those ranks only, smaller than the group: every rank
    of the group calls this all the same (making its groups is collective),
    and on a rank outside it ``get_coordinate()`` is ``None``."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (see spawn)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if ranks is None:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
    return DeviceMesh(device_type, torch.tensor(list(ranks)).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The production mesh as a ``{axis: size}`` mapping: 16 × 16 (256
    ranks) or 2 × 16 × 16 (512). Axes: ``pod`` (between pods), ``data``
    (data parallel: batch, APSS rows), ``model`` (tensor and expert
    parallel: APSS dims). ``launch.dryrun`` builds a ``DeviceMesh`` of this
    shape over a fake process group; cells build on the mapping itself."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_debug_mesh(shape=(2, 2), names=("data", "model")):
    """Small mesh for multi-rank tests."""
    return make_mesh(shape, names)


def rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:(rank % device_count)`` for a CUDA
    device, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return torch.device("cuda", rank % torch.cuda.device_count())


def default_backend(device: str, world: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def spawn(
    target: str,
    nprocs: int,
    *args,
    device: str = "cuda",
    threads: int | None = None,
    run_dir: str | os.PathLike | None = None,
    pg_timeout: float = PG_TIMEOUT_S,
    join_timeout: float = JOIN_TIMEOUT_S,
) -> list:
    """Run ``target(rank, world, device, *args)`` in ``nprocs`` spawned ranks.

    ``target`` is ``"module:function"``. Each rank joins a process group
    (``default_backend``) through a ``file://`` store in a fresh directory
    under ``run_dir`` (the
    system's temporary directory by default) with ``pg_timeout`` seconds for
    every collective, and sets ``torch.set_num_threads(threads)`` if given.
    Returns the ranks' return values (pickled through ``run_dir``) in rank
    order. Raises if a rank raises or exits non-zero (the others are
    stopped), and ``TimeoutError`` if the ranks have not all ended within
    ``join_timeout`` seconds.
    """
    import torch.multiprocessing as mp

    rank_device(device, 0)  # a CUDA device without a card raises here, not in the ranks
    backend = default_backend(device, nprocs)
    run = Path(tempfile.mkdtemp(prefix="ranks-", dir=run_dir))
    ctx = mp.start_processes(
        _rank_main,
        args=(target, nprocs, str(run), backend, pg_timeout, device, threads, args),
        nprocs=nprocs, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + join_timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{target}: ranks still running after {join_timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10)
    out = []
    for rank in range(nprocs):
        with open(run / f"result-{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, target, world, run, backend, pg_timeout, device, threads, args):
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{run}/store", world_size=world, rank=rank,
        timeout=timedelta(seconds=pg_timeout),
    )
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(run) / f"result-{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
