"""One-shot calibration of the planner's cost models on this machine's device.

Measures the constants the cost models need — dense matmul throughput,
sparse gather-dot throughput, and, under a mesh of ranks, the per-rank
throughput when every rank computes at once and the ring's bandwidth and
latency — and caches them to a JSON profile keyed by device kind, so
calibration runs once per machine, not once per plan.

The calls timed are the reference's: ``similarity_topk`` (the plain
blocked join) at depths ``m`` and ``m/8`` and ``sparse_similarity_topk``;
under a mesh, a row-block matmul alone and on every rank at once, and 8
ring hops of 1 MiB and of one scalar through the port's ``_ppermute``.
Each is timed by the host clock around work that ends in
``torch.cuda.synchronize()`` on the card.

``get_profile()`` never benchmarks: it returns the cached profile if one
exists, else the deterministic :func:`~repro_torch.planner.costmodel.default_profile`.
Run :func:`calibrate` explicitly (or ``launch/serve.py --mode auto``) to
measure.

Cache location: ``$REPRO_CALIB_DIR`` or ``~/.cache/repro_apss/``, as the
reference's; the port's files are named ``calibration_torch_<kind>.json``
so that neither package reads the other's measurements of the same device
kind.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.planner.costmodel import CalibrationProfile, default_profile, mesh_sizes

_MEMO: dict[str, CalibrationProfile] = {}


def device_kind() -> str:
    """Cache key: the card's name (spaces and slashes replaced) × the
    number of cards, or ``cpu_x1`` on a machine without one."""
    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name().replace(" ", "_").replace("/", "_")
        return f"{kind}_x{torch.cuda.device_count()}"
    return "cpu_x1"


def profile_path(kind: Optional[str] = None) -> Path:
    base = Path(
        os.environ.get("REPRO_CALIB_DIR", Path.home() / ".cache" / "repro_apss")
    )
    return base / f"calibration_torch_{kind or device_kind()}.json"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_time(fn, dev: torch.device, iters: int = 3) -> float:
    fn()  # warm: kernel builds, allocator
    _sync(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def mesh_group(mesh):
    """The process group over every rank of ``mesh``: its axis's group for
    a 1-D mesh, else the default group (which the mesh must span)."""
    names = tuple(mesh.mesh_dim_names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    size = int(np.prod(tuple(mesh.shape)))
    if size != dist.get_world_size():
        raise ValueError(
            f"a {len(names)}-axis mesh of {size} ranks must span all "
            f"{dist.get_world_size()} ranks"
        )
    return dist.group.WORLD


def mesh_root(mesh) -> int:
    """Global rank of the mesh's first rank (row-major)."""
    return int(mesh.mesh.flatten()[0])


def calibrate(
    mesh=None,
    *,
    n: int = 512,
    m: int = 512,
    cap: int = 32,
    m_sparse: int = 4096,
    iters: int = 3,
    save: bool = True,
    device=None,
) -> CalibrationProfile:
    """Run the microbenchmarks and (by default) cache the resulting profile.

    ``device`` defaults to this machine's device kind: the current card
    where there is one, else the CPU. ``mesh`` (a ``DeviceMesh`` of the
    ranks, each calling this) adds the sharded and collective
    measurements over its first axis; every rank measures, and every rank
    then takes rank 0's profile (one ``broadcast_object_list`` over the
    mesh's group), so all ranks plan alike. Without a mesh those constants
    keep their defaults: no variant with collectives is reachable.
    """
    from repro_torch.core.apss import similarity_topk
    from repro_torch.core.sparse import SparseCorpus, sparse_similarity_topk
    from repro_torch.interop import device_of

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = device_of(device)
    prof = default_profile()
    prof.device_kind = device_kind()

    # Achieved cost of the plain blocked scoring path = per-FLOP
    # contraction cost + per-SCORE extraction cost (threshold + top-k,
    # depth-independent). Timing the same join at depths m and m/8
    # separates the two. Threshold 2.0 > any cosine keeps the match
    # buffers empty without changing the work done.
    A = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, m)).astype(np.float32)
    ).to(dev)
    m2 = max(32, m // 8)
    A2 = A[:, :m2].contiguous()

    def mm(x):
        return similarity_topk(x, x, 2.0, 32, block_rows=128, device=dev)

    t1 = _median_time(lambda: mm(A), dev, iters)
    t2 = _median_time(lambda: mm(A2), dev, iters)
    per_flop = max((t1 - t2) / (2.0 * n * n * (m - m2)), 1e-15)
    prof.matmul_gflops = 1.0 / per_flop / 1e9
    score_cost = max(0.0, (t2 - 2.0 * n * n * m2 * per_flop) / (n * n))
    prof.score_cost_ns = score_cost * 1e9

    # Sparse blocked join (densify_rows + gather_dot + extract) at
    # ``m_sparse`` dimensions, less the extraction cost just measured, so
    # gather_gflops prices only the CSR contraction.
    rng = np.random.default_rng(1)
    sp = SparseCorpus(
        torch.from_numpy(rng.integers(0, m_sparse, size=(n, cap)).astype(np.int32)),
        torch.from_numpy(rng.standard_normal((n, cap)).astype(np.float32)),
        torch.full((n,), cap, dtype=torch.int32),
        m_sparse,
    ).to(dev)
    t_g = _median_time(
        lambda: sparse_similarity_topk(sp, sp, 2.0, 32, block_rows=128), dev, iters
    )
    denom = max(t_g - n * n * score_cost, 0.1 * t_g)
    prof.gather_gflops = 2.0 * n * n * cap / denom / 1e9

    if mesh is not None and int(np.prod(tuple(mesh.shape))) > 1:
        _calibrate_mesh(prof, mesh, dev, n=n, m=m, iters=iters)
        obj = [prof]
        dist.broadcast_object_list(obj, src=mesh_root(mesh), group=mesh_group(mesh))
        prof = obj[0]

    _MEMO[prof.device_kind] = prof
    if save:
        path = profile_path(prof.device_kind)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(prof.to_json())
    return prof


def _calibrate_mesh(prof, mesh, dev, *, n, m, iters) -> None:
    """The mesh's constants, measured on this rank over the first axis."""
    from repro_torch.core import distributed as dd
    from repro_torch.core.precision import dot_f32

    axis = next(iter(mesh_sizes(mesh)))
    p = mesh_sizes(mesh)[axis]
    group = mesh_group(mesh)
    me = dist.get_rank(group)

    # Per-rank throughput when every rank computes at once, as a ratio of
    # the same bare matmul alone (ranks in turn) and all together; applied
    # to the end-to-end constants so both stay in the same units.
    rows = max(8, n // p)
    base = torch.from_numpy(
        np.random.default_rng(2).standard_normal((rows, m)).astype(np.float32)
    ).to(dev)
    t_one = 0.0
    for r in range(dist.get_world_size(group)):
        dist.barrier(group=group)
        if r == me:
            t_one = _median_time(lambda: dot_f32(base, base), dev, iters)
    dist.barrier(group=group)
    t_all = _median_time(lambda: dot_f32(base, base), dev, iters)
    scale = max(1e-3, min(1.5, t_one / t_all))
    prof.sharded_matmul_gflops = prof.matmul_gflops * scale
    prof.sharded_gather_gflops = prof.gather_gflops * scale

    # Interconnect: `hops` ring hops of a 1 MiB block (bandwidth) and of
    # a 4-byte scalar (latency). The wire counters are left as they were.
    saved = dict(dd.WIRE_BYTES), dict(dd.WIRE_SECONDS)
    hops = 8
    perm = dd._ring_perm(p)

    def ring(x):
        for _ in range(hops):
            (x,) = dd._ppermute((x,), mesh, axis, perm)
        return x

    words = max(1, (1 << 20) // 4)
    buf = torch.from_numpy(
        np.random.default_rng(3).standard_normal(words).astype(np.float32)
    ).to(dev)
    t = _median_time(lambda: ring(buf), dev, iters)
    prof.collective_gbps = hops * words * 4 / t / 1e9
    tiny = torch.zeros(1, dtype=torch.float32, device=dev)
    t = _median_time(lambda: ring(tiny), dev, iters)
    prof.collective_latency_us = t / hops * 1e6
    dd.WIRE_BYTES.update(saved[0])
    dd.WIRE_SECONDS.update(saved[1])


def get_profile(*, refresh: bool = False) -> CalibrationProfile:
    """Cached profile for this device kind, else deterministic defaults.

    Never runs a microbenchmark (planning must be cheap and deterministic);
    ``refresh=True`` only bypasses the in-process memo and re-reads the
    JSON cache.
    """
    kind = device_kind()
    if not refresh and kind in _MEMO:
        return _MEMO[kind]
    path = profile_path(kind)
    if path.exists():
        try:
            prof = CalibrationProfile.from_json(path.read_text())
        except (ValueError, KeyError, TypeError):
            prof = default_profile()
            prof.device_kind = kind
    else:
        prof = default_profile()
        prof.device_kind = kind
    _MEMO[kind] = prof
    return prof
