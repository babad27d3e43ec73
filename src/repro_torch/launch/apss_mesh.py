"""Run the paper's distributions (``core.distributed``) in spawned ranks and
report each run per rank.

:func:`run_variants` is a rank function for ``launch.mesh.spawn``: every
rank loads the global corpus from disk (a dense ``.npy``, opened memory-
mapped so a rank reads only its shard, or a sparse ``.npz`` of ``indices``,
``values``, ``nnz`` and ``m``), runs each variant through ``apss`` on its
mesh and returns, per variant:

- ``wall_ms``: host-clock ms of each run, from a barrier and a synchronize
  to a synchronize and a barrier;
- ``wire_ms`` and ``wire_bytes``: the time inside the collective helpers and
  the bytes this rank sent, per run, by collective (``WIRE_SECONDS``,
  ``WIRE_BYTES``);
- ``launches``: the kernels' launch counts during the first run;
- ``device_ms``, ``copy_ms`` and ``k1_ms`` (on a card): the device time
  of the first run under ``torch.profiler`` (CUDA
  activity only), its memcpy part and K1's part; ``None`` where the
  profiler saw no device time. Ranks that share a card are time-sliced
  on it, and a kernel's device time then takes in the slices of the
  others: their sum can pass the wall;
- ``overflow_rows`` where the variant returns stats;
- ``records``: this rank's telemetry records of the first run, which runs
  under a ``planner.telemetry.CommLog``, as plain dicts (every field but
  the ticker, the hops as dicts, and ``wire_bytes``, ``hop_count`` and
  ``step_times``);
- ``ticks`` for a variant with ``ticks`` set (a 2-D or hierarchical one):
  the sorted ``(rank, step)`` pairs of every rank's ``StepTicker`` in the
  first run, the ticker that telemetry created for the record;
- ``chosen`` for ``distribution="auto"``: the planned config's name on
  every rank, in rank order;
- ``matches`` (rank 0 only): the global ``Matches`` of the first run
  (``core.distributed.gather_matches``) as numpy ``(values, indices,
  counts)``;
- ``residuals`` where a ``profile`` is given: the first run also runs
  under an ``obs.Tracer``, and these are its
  ``obs.drift.residuals_from_trace`` against that profile, as dicts (one
  per record of this rank, measured by the span it was pinned to).

A variant is a dict: ``name``; ``distribution``; ``mesh`` as ``(shape,
names)``; ``corpus``, ``"dense"`` or ``"sparse"``; ``gather``, the axes
the result's rows are sharded over (``None`` if replicated), and
``scatter``; ``kwargs`` for the entry point; and optionally ``threshold``
in place of the run's and ``ticks``. A variant with ``distribution=
"auto"`` is planned once on every rank (``planner.plan_apss``, its
``kwargs`` the planner's), outside the timed runs, after
``calibrate(mesh, **v["calibrate"])`` where the variant has that key (the
agreed profile is returned as ``profile``); each run is ``Plan.run()``,
and the result is gathered by the plan's ``result_layout()`` in place of
``gather`` and ``scatter``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as dd
from repro_torch.core.sparse import SparseCorpus
from repro_torch.distributed.straggler import StepTicker
from repro_torch.kernels.apss_block.fused import LAUNCHES
from repro_torch.launch.mesh import make_mesh
from repro_torch.planner import telemetry


def load_corpus(path: str):
    """A dense corpus (memory-mapped numpy) from ``.npy`` or a CPU
    ``SparseCorpus`` from ``.npz``."""
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    with np.load(path) as f:
        return SparseCorpus(torch.from_numpy(f["indices"]), torch.from_numpy(f["values"]),
                            torch.from_numpy(f["nnz"]), int(f["m"]))


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset() -> None:
    for counts in (LAUNCHES, dd.WIRE_BYTES, dd.WIRE_SECONDS):
        for key in counts:
            counts[key] = 0


def _device_ms(prof) -> dict:
    """Device ms of a profiled run: all of it, the memcpy part and K1's."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if e.device_type == cuda and e.self_device_time_total > 0]
    if not events:
        return dict(device_ms=None, copy_ms=None, k1_ms=None)

    def ms(key=""):
        return sum(e.self_device_time_total for e in events if key in e.key.lower()) / 1e3

    return dict(device_ms=ms(), copy_ms=ms("memcpy"), k1_ms=ms("apss::fused"))


def _all_ticks(ticker: StepTicker) -> list:
    """Every rank's ``(rank, step)`` ticks, gathered to each rank, sorted."""
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [(r, s) for r, s, _ in ticker.tick_log()])
    return sorted(tick for ticks in per_rank for tick in ticks)


def record_dict(r: telemetry.ApssStats) -> dict:
    """A telemetry record as plain, picklable values (no ticker)."""
    out = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
           if f.name != "step_ticker"}
    out["hops"] = [dataclasses.asdict(h) for h in r.hops]
    times = r.step_times
    out.update(wire_bytes=r.wire_bytes, hop_count=r.hop_count,
               step_times=None if times is None else list(times))
    return out


def run_variants(rank, world, dev, corpora: dict, variants: list, threshold: float, k: int,
                 reps: int = 1, profile=None, audit: dict | None = None) -> dict:
    """Rank function (``launch.mesh.spawn``): run every variant ``reps``
    times on this rank; see the module docstring for what it returns. With
    ``audit`` (``obs.audit.run_audit`` options) the ranks then audit every
    plannable family on their meshes, and ``out["audit"]`` is rank 0's
    ``AuditReport`` (None on the others)."""
    from repro_torch.obs import Tracer, drift

    loaded = {name: load_corpus(path) for name, path in corpora.items()}
    meshes = {}
    out = {}
    for v in variants:
        key = (tuple(v["mesh"][0]), tuple(v["mesh"][1]))
        if key not in meshes:  # every rank builds the same meshes in the same order
            meshes[key] = make_mesh(*key)
        mesh = meshes[key]
        kw = dict(v.get("kwargs", {}), device=dev)
        corpus, t = loaded[v["corpus"]], v.get("threshold", threshold)
        rec = {"wall_ms": [], "wire_ms": [], "wire_bytes": [],
               "device_ms": None, "copy_ms": None, "k1_ms": None}
        layout = v.get("gather"), v.get("scatter", False)
        if v["distribution"] == "auto":
            from repro_torch.planner.calibrate import calibrate
            from repro_torch.planner.plan import plan_apss

            if "calibrate" in v:  # measured on this mesh; every rank takes rank 0's
                kw["profile"] = calibrate(mesh, device=dev, save=False, **v["calibrate"])
                rec["profile"] = dataclasses.asdict(kw["profile"])
            plan = plan_apss(corpus, t, k, mesh, **kw)
            rec["chosen"] = [None] * dist.get_world_size()
            dist.all_gather_object(rec["chosen"], plan.config.name)
            layout = plan.result_layout()
            call = plan.run
        else:
            def call():
                return dd.apss(corpus, t, k, mesh, distribution=v["distribution"], **kw)

        for rep in range(reps):
            traced = rep == 0 and dev.type == "cuda"
            _reset()
            dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                prof = stack.enter_context(_profile()) if traced else None
                log = stack.enter_context(telemetry.CommLog()) if rep == 0 else None
                tracer = (stack.enter_context(Tracer())
                          if rep == 0 and profile is not None else None)
                got = call()
                _sync(dev)
            dist.barrier()
            rec["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["wire_ms"].append(sum(dd.WIRE_SECONDS.values()) * 1e3)
            rec["wire_bytes"].append(dict(dd.WIRE_BYTES))
            if traced:
                rec.update(_device_ms(prof))
            if rep == 0:
                rec["launches"] = dict(LAUNCHES)
                rec["records"] = [record_dict(r) for r in log.records]
                if tracer is not None:
                    rec["residuals"] = [dataclasses.asdict(r) for r in
                                        drift.residuals_from_trace(tracer, profile)]
                first = got
                if v.get("ticks"):
                    ticker = next(r.step_ticker for r in reversed(log.records)
                                  if r.step_ticker is not None)
                    rec["ticks"] = _all_ticks(ticker)
        m = first
        if isinstance(first, tuple) and not isinstance(first, dd.Matches):
            m, stats = first
            rec["overflow_rows"] = int(stats.overflow_rows)
        m = dd.gather_matches(m, mesh, layout[0], scatter=layout[1])
        if rank == 0:
            rec["matches"] = tuple(x.cpu().numpy() for x in m)
        out[v["name"]] = rec
        del got, first, m
        if dev.type == "cuda":  # hand cached blocks back: the ranks may share a card
            torch.cuda.empty_cache()
    if audit is not None:
        from repro_torch.obs.audit import audit_ranks

        out["audit"] = audit_ranks(rank, world, dev, audit)
    return out


def run_cells(rank, world, dev, cells: list, config: dict, mesh_shape=(2, 2)) -> dict:
    """Rank function (``launch.mesh.spawn``): the paper's own cells
    (``configs.apss_paper``, the ``apss`` arch) on this rank. ``cells`` is a
    list of ``(cell, corpus path)``; each cell is built from ``config`` on a
    ``mesh_shape`` ``("data", "model")`` mesh and its ``fn`` run once on the
    corpus: a dense ``.npy`` as it is, a sparse ``.npz`` as a
    ``core.sparse.DenseView``, so that each rank densifies only its own
    cell on its device. Returns per cell ``wall_s`` (host clock, from a
    barrier and a synchronize to a synchronize and a barrier), the bytes
    this rank sent, and on rank 0 ``matches``, the global ``Matches`` as
    numpy ``(values, indices, counts)``."""
    from repro_torch.configs import get_arch
    from repro_torch.core.sparse import DenseView

    mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
    arch = get_arch("apss")
    out = {}
    for name, path in cells:
        corpus = load_corpus(path)
        if isinstance(corpus, SparseCorpus):
            corpus = DenseView(corpus)
        fn = arch.cell(name).build(config, mesh).fn
        _reset()
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        got = fn(corpus, device=dev)
        _sync(dev)
        dist.barrier()
        out[name] = {"wall_s": time.perf_counter() - t0, "wire_bytes": dict(dd.WIRE_BYTES),
                     "wire_s": sum(dd.WIRE_SECONDS.values()),
                     "matches": tuple(x.cpu().numpy() for x in got) if rank == 0 else None}
        del got, corpus
        if dev.type == "cuda":  # hand cached blocks back: the ranks may share a card
            torch.cuda.empty_cache()
    return out
