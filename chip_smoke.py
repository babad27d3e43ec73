#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``: fails unless CUDA is available; the card's name and the
   ``nvidia-smi`` name and power limit.
2. ``build``: compiles every kernel source (one ``nvcc`` per source, all
   started together) into ``build/repro_torch/``; build seconds and each
   kernel's registers, shared memory and spills from ``-Xptxas -v``.
3. ``edge_probes``: n=130 m=100; t=-0.1 with padded zero columns; k > n;
   bf16 input; an all-pruned mask (t=1.5), through both dense kernel
   paths, against the port's oracle on the card.
4. ``sparse_edge_probes``: the sparse path (``apss_blocked`` on a
   ``SparseCorpus``, K3) on n=130 m=100 via ``from_dense``, t=-0.1 with
   padded rows, k > n, duplicate coordinates concentrated in one dimension
   across two blocks, and t=1.5 (all pruned); K7 with an explicit mask
   holding dead tiles, whose output must be zeros.
5. ``clustered_65k``: ``clustered_corpus(65536, 768, 8)``, t=0.5, k=32: the
   pruning-friendly regime (most tiles provably dead), K1 and K2.
6. ``radikal_full``: the paper's radikal dataset at full scale
   (n=6883, m=136447, 155.8 nnz/row), t=0.2, k=32: nearly every tile live,
   the unpruned worst case with a 267-chunk feature loop, K1 and K2.
7. ``k7_radikal_full``: ``apss_block_matmul`` (K7) with the auto mask on the
   same corpus, held against ``apss_block_plain`` element by element.
8. ``sparse_radikal_full``: the same corpus in CSR (``from_dense``) through
   ``apss_blocked(sp, use_kernel=True)`` (K3), held against the plain sparse
   path and against phase 6's K2 result (counts exactly equal: both sum
   the same nonzero products in the same order).
9. ``sparse_clustered_65k``: ``sparse_clustered_corpus(65536, 8192, 16,
   n_clusters=32)``, t=0.5, k=32 (the serving benchmark's corpus), K3.
10. ``kernels``: per kernel and main-path shape, launches on the main path,
    median kernel / plain / library time from CUDA events, the bound, and
    the largest value difference from the plain version.

The main-path phases (5, 6, 7, 8, 9) drive the port's entry points
(``apss_blocked(use_kernel=True)`` for K1, ``apss_fused_compacted`` for K2,
``apss_block_matmul`` for K7, ``apss_blocked(sp, use_kernel=True)`` for K3)
with the launch counts set to 0 just before and read just after, and hold
the results against the plain paths on the card. Comparison rule (the
kernels, cuBLAS and the CPU add in different orders): pairs with
|s - t| > 1e-5 agree exactly in membership, count and order by (value
desc, id asc); values agree to 1e-5; pairs within 1e-5 of t may differ, and
the number of such pairs is printed. Two entries whose values differ by at
most 1e-5 may trade places (a near tie). K7's matrix: values agree to 1e-5
and the zero pattern is equal wherever |s - t| > 1e-5.

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
REPS = 5
PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 without tensor cores (TF32 off)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
KERNEL_INFO = {
    "apss_fused": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/apss_fused.cu",
        replaces="src/repro/kernels/apss_block/fused.py:316",
    ),
    "apss_tile_candidates": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/tile_candidates.cu",
        replaces="src/repro/kernels/apss_block/fused.py:739",
    ),
    "sparse_tile_candidates": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/sparse_tile_candidates.cu",
        replaces="src/repro/kernels/apss_block/sparse.py:198",
    ),
    "apss_block": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/apss_block.cu",
        replaces="src/repro/kernels/apss_block/apss_block.py:98",
    ),
}


class PhaseFailed(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch  # noqa: F401  (fails when run outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit("device", kind=kind, nvidia_smi=smi, capability=list(cap),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    check(cap == (9, 0), f"kernels are built for sm_90a; card is sm_{cap[0]}{cap[1]}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: _build.ptxas_report(name) for name in _build.sources()})

    from repro_torch.core.sparse import from_dense
    from repro_torch.data.sparse import sparse_clustered_corpus
    from repro_torch.data.synthetic import clustered_corpus, synthetic_corpus

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    edge_probes(np, torch)
    sparse_edge_probes(np, torch)
    D, gen_s = generated(torch, lambda: torch.from_numpy(
        clustered_corpus(65536, 768, 8, n_clusters=32, seed=0)).cuda())
    rows, _ = main_path_phase(np, torch, "clustered_65k", D, gen_s, threshold=0.5, k=32)
    del D
    D, gen_s = generated(torch, lambda: torch.from_numpy(
        synthetic_corpus(6883, 136447, 1072472 / 6883, seed=0)).cuda())
    more, dense = main_path_phase(np, torch, "radikal_full", D, gen_s, threshold=0.2, k=32)
    rows += more
    rows.append(k7_phase(np, torch, "k7_radikal_full", D, threshold=0.2))
    sp, conv_s = generated(torch, lambda: from_dense(D))
    del D
    torch.cuda.empty_cache()
    rows.append(sparse_phase(np, torch, "sparse_radikal_full", sp, conv_s,
                             threshold=0.2, k=32, dense=dense))
    del sp, dense
    sp, gen_s = generated(torch, lambda: sparse_clustered_corpus(
        65536, 8192, 16.0, n_clusters=32, seed=0))
    rows.append(sparse_phase(np, torch, "sparse_clustered_65k", sp, gen_s,
                             threshold=0.5, k=32))
    emit("kernels", kernels=rows)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def near_threshold_counts(torch, D, t: float, rows: int = 512):
    """Per row of ``D``, the pairs (no self-pair) with |s - t| <= TOL."""
    from repro_torch.core.precision import dot_f32

    n = D.shape[0]
    out = []
    for b in range(0, n, rows):
        s = dot_f32(D[b:b + rows], D)
        near = (s - t).abs() <= TOL
        r = torch.arange(b, min(b + rows, n), device=D.device)
        near[r - b, r] = False
        out.append(near.sum(dim=1))
    return torch.cat(out).cpu().numpy()


def compare(np, got, ref, t: float, near) -> dict:
    """Hold ``got`` against ``ref`` (each ``(values, indices, counts)`` numpy,
    ``-inf``/``-1`` empties) under the comparison rule of the module."""
    with np.errstate(invalid="ignore"):
        return _compare(np, got, ref, t, near)


def _compare(np, got, ref, t, near) -> dict:
    gv, gi, gc = got
    rv, ri, rc = ref
    k = gv.shape[1]
    count_bad = int((np.abs(gc.astype(np.int64) - rc) > near).sum())

    def far_first(v, i):
        far = (i >= 0) & (np.abs(v - t) > TOL)
        order = np.argsort(~far, axis=1, kind="stable")
        return (np.take_along_axis(v, order, 1), np.take_along_axis(i, order, 1),
                far.sum(axis=1))

    gv2, gi2, ng = far_first(gv, gi)
    rv2, ri2, nr = far_first(rv, ri)
    common = np.arange(k)[None, :] < np.minimum(ng, nr)[:, None]
    diff = np.where(common, np.abs(gv2 - rv2), 0.0)
    same_id = common & (gi2 == ri2)
    swapped = common & (gi2 != ri2)
    order_bad = int((swapped & (diff > TOL)).sum())
    longer = (np.arange(k)[None, :] >= np.minimum(ng, nr)[:, None]) & (
        np.arange(k)[None, :] < np.maximum(ng, nr)[:, None]
    )
    tail_v = np.where(ng[:, None] > nr[:, None], gv2, rv2)
    length_bad = int((longer & (np.abs(tail_v - t) > 2 * TOL)).sum())
    max_err = float(np.where(same_id, diff, 0.0).max()) if gv.size else 0.0
    return dict(
        count_mismatch_rows=count_bad,
        order_mismatches=order_bad,
        length_mismatches=length_bad,
        near_tie_swaps=int(swapped.sum() - order_bad),
        near_threshold_pairs=int(near.sum()),
        max_abs_err=max_err,
        ok=count_bad == 0 and order_bad == 0 and length_bad == 0 and max_err <= TOL,
    )


def as_rows(np, values, indices, counts):
    """Kernel outputs (any leading shape, ``NEG_LARGE`` empties) as host
    ``(values (rows, k), indices, counts (rows,))`` with ``-inf`` empties."""
    v = values.reshape(-1, values.shape[-1]).cpu().numpy()
    i = indices.reshape(-1, indices.shape[-1]).cpu().numpy()
    c = counts.reshape(-1).cpu().numpy()
    return np.where(i >= 0, v, -np.inf).astype(np.float32), i, c


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def time_ms(np, torch, fn) -> float:
    """Median of REPS timed calls (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def timed(torch, fn):
    """``(fn(), host-clock ms)`` of one call that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def wall_ms(np, torch, fn, reps: int = REPS) -> dict:
    """Median, min and max host-clock ms of ``reps`` more calls of one path."""
    times = [timed(torch, fn)[1] for _ in range(reps)]
    return dict(median=float(np.median(times)), min=min(times), max=max(times))


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def library_topk(torch, D, t: float, k: int, rows: int = 512):
    """Yardstick: f32 ``torch.matmul`` in 512-row blocks plus a stable top-k
    (no tile masks, no self-exclusion). The port never calls it."""
    out = []
    for b in range(0, D.shape[0], rows):
        s = torch.matmul(D[b:b + rows], D.T)
        cnt = (s >= t).sum(dim=1)
        s = torch.where(s >= t, s, float("-inf"))
        v, i = torch.sort(s, dim=1, descending=True, stable=True)
        out.append((v[:, :k], i[:, :k], cnt))
    return out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def edge_probes(np, torch) -> None:
    from repro_torch import (
        apss_blocked,
        apss_fused,
        apss_fused_compacted,
        apss_reference,
    )
    from repro_torch.core.precision import dot_f32
    from repro_torch.interop import matches_to_numpy

    def corpus(n, m, seed, density=0.3):
        rng = np.random.default_rng(seed)
        D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
        D *= rng.random((n, m)) < density
        D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(D).cuda()

    probes = {
        "n130_m100": (corpus(130, 100, 1), 0.35, 16),
        "negative_t_padded": (corpus(130, 100, 2), -0.1, 16),
        "k_gt_n": (corpus(100, 64, 3), 0.2, 160),
        "bf16": (corpus(300, 200, 4).bfloat16(), 0.3, 16),
        "all_pruned_t1.5": (corpus(200, 96, 5), 1.5, 16),
    }
    results = {}
    for name, (D, t, k) in probes.items():
        ref = apss_reference(D, t, k)
        S = dot_f32(D, D)
        S.fill_diagonal_(float("nan"))
        near = ((S - t).abs() <= TOL).sum(dim=1).cpu().numpy()
        r = {}
        for path, fn in (
            ("apss_blocked_kernel", lambda: apss_blocked(D, t, k, use_kernel=True)),
            ("apss_fused_compacted", lambda: apss_fused_compacted(D, t, k)),
        ):
            got = fn()
            torch.cuda.synchronize()
            r[path] = compare(np, matches_to_numpy(got), matches_to_numpy(ref), t, near)
            check(r[path]["ok"], f"edge probe {name} via {path}: {r[path]}")
        if t > 1.0:
            check(int(ref.counts.sum()) == 0, "t=1.5 oracle has matches")
        results[name] = dict(matches=int(ref.counts.sum()), **{
            p: {key: v for key, v in c.items() if key != "ok"} for p, c in r.items()})
    # An explicitly dead mask yields nothing even though every score passes t=0.
    D = corpus(256, 96, 6)
    got = apss_fused(D, D, 0.0, 16, block_mask=torch.zeros((1, 1), dtype=torch.int32))
    check(int(got.counts.sum()) == 0 and bool((got.indices == -1).all()),
          "explicit all-zero mask produced matches")
    results["explicit_zero_mask"] = dict(matches=0)
    emit("edge_probes", probes=results)


def sparse_edge_probes(np, torch) -> None:
    from repro_torch import apss_block_matmul, apss_blocked, apss_reference
    from repro_torch.core.precision import dot_f32
    from repro_torch.core.sparse import SparseCorpus, from_dense, to_dense
    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block.apss_block import apss_block_plain
    from repro_torch.kernels.apss_block.sparse import apss_sparse_compacted

    def corpus(n, m, seed, density=0.3):
        rng = np.random.default_rng(seed)
        D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
        D *= rng.random((n, m)) < density
        D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(D).cuda()

    # Two 64-row blocks; row 0 stores dim 3 as two 0.5 slots (effective 1.0),
    # row 64 holds dim 3 at 1.0: a per-slot bound would prune their tile.
    idx = torch.zeros((128, 2), dtype=torch.int32)
    val = torch.zeros((128, 2))
    idx[0], val[0] = torch.tensor([3, 3]), torch.tensor([0.5, 0.5])
    idx[64], val[64] = torch.tensor([3, 0]), torch.tensor([1.0, 0.0])
    nnz = torch.zeros(128, dtype=torch.int32)
    nnz[0], nnz[64] = 2, 1
    dup = SparseCorpus(idx, val, nnz, 8).to("cuda")

    probes = {
        "n130_m100": (from_dense(corpus(130, 100, 1)), 0.35, 16, None),
        "negative_t_padded": (from_dense(corpus(130, 100, 2)), -0.1, 16, None),
        "k_gt_n": (from_dense(corpus(100, 64, 3)), 0.2, 160, None),
        "duplicate_concentration": (dup, 0.8, 4, 64),
        "all_pruned_t1.5": (from_dense(corpus(200, 96, 5)), 1.5, 16, None),
    }
    results = {}
    for name, (sp, t, k, block) in probes.items():
        D = to_dense(sp)
        ref = apss_reference(D, t, k)
        S = dot_f32(D, D)
        S.fill_diagonal_(float("nan"))
        near = ((S - t).abs() <= TOL).sum(dim=1).cpu().numpy()
        reset_launches()
        if block is None:
            got = apss_blocked(sp, t, k, use_kernel=True)
        else:
            got = apss_sparse_compacted(sp, t, k, block_m=block)
        torch.cuda.synchronize()
        launches = launches_now()["sparse_tile_candidates"]
        r = compare(np, matches_to_numpy(got), matches_to_numpy(ref), t, near)
        check(r["ok"], f"sparse edge probe {name}: {r}")
        if t > 1.0:
            check(int(ref.counts.sum()) == 0, "t=1.5 oracle has matches")
        else:
            check(launches > 0, f"sparse edge probe {name}: K3 never ran")
        if name == "duplicate_concentration":
            check(int(got.counts.sum()) == 2, "duplicate-concentration match dropped")
        if name == "negative_t_padded":
            check(bool((got.counts == sp.n - 1).all()), "padded rows matched at t < 0")
        results[name] = dict(matches=int(ref.counts.sum()), k3_launches=launches,
                             **{key: v for key, v in r.items() if key != "ok"})

    # K7 with an explicit mask: dead tiles are zeros, even at t < 0.
    x = corpus(300, 200, 6)
    mask = torch.ones((3, 3), dtype=torch.int32)
    mask[0, 2] = mask[1, 0] = mask[2, 1] = 0
    for t in (0.3, -0.5):
        reset_launches()
        got = apss_block_matmul(x, x, t, block_mask=mask, block_m=128, block_n=128,
                                block_k=256)
        torch.cuda.synchronize()
        check(launches_now()["apss_block"] == 1, "K7 probe did not launch once")
        xp = torch.nn.functional.pad(x, (0, 56, 0, 84))
        want = apss_block_plain(xp, xp, t, block_mask=mask, block_m=128,
                                block_n=128)[:300, :300]
        band = (dot_f32(x, x) - t).abs() <= TOL
        c = dense_compare(torch, got, want, band)
        dead = torch.repeat_interleave(torch.repeat_interleave(
            mask.cuda() == 0, 128, 0), 128, 1)[:300, :300]
        check(c["ok"], f"K7 explicit-mask probe at t={t}: {c}")
        check(not bool(got[dead].any()), f"K7 wrote nonzeros in a dead tile at t={t}")
        results[f"k7_dead_tiles_t{t}"] = dict(
            dead_entries=int(dead.sum()), nonzero=int((got != 0).sum()),
            **{key: v for key, v in c.items() if key != "ok"})
    emit("sparse_edge_probes", probes=results)


def generated(torch, make):
    """``(make(), seconds)`` for a corpus made on the host or the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = make()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def reset_launches():
    from repro_torch.kernels.apss_block import fused

    for key in fused.LAUNCHES:
        fused.LAUNCHES[key] = 0


def launches_now() -> dict:
    from repro_torch.kernels.apss_block import fused

    return dict(fused.LAUNCHES)


def packet_compare(np, phase, name, pk, pp, ij, *, grid, bm, k, t, near_p):
    """Forward, mirror and folded packets of a worklist kernel against its
    plain version (``near_p``: near-threshold pairs per padded row)."""
    from repro_torch.kernels.apss_block.ops import fold_packets

    wl = ij.cpu().numpy().astype(np.int64)
    fwd_rows = (wl[0][:, None] * bm + np.arange(bm)[None, :]).reshape(-1)
    mir_rows = (wl[1][:, None] * bm + np.arange(bm)[None, :]).reshape(-1)
    cf = compare(np, as_rows(np, *pk[:3]), as_rows(np, *pp[:3]), t, near_p[fwd_rows])
    cb = compare(np, as_rows(np, *pk[3:]), as_rows(np, *pp[3:]), t, near_p[mir_rows])

    def folded(p):
        return as_rows(np, *fold_packets(
            ij, p[0], p[1], p[2][..., 0], p[3], p[4], p[5][..., 0],
            grid_m=grid, block_m=bm, k=k,
        ))

    cfold = compare(np, folded(pk), folded(pp), t, near_p)
    for part, c in (("forward", cf), ("mirror", cb), ("folded", cfold)):
        check(c["ok"], f"{phase}: {name} {part} packets disagree with plain: {c}")
    return dict(cf, max_abs_err=max(cf["max_abs_err"], cb["max_abs_err"]),
                mirror=cb, folded=cfold)


def main_path_phase(np, torch, phase, D, gen_s, *, threshold, k):
    """K1 and K2 on a dense corpus on the card. Returns the kernel rows and,
    for the sparse phase on the same data, K2's result and the
    near-threshold counts."""
    from repro_torch import apss_blocked, apss_fused_compacted
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block import fused
    from repro_torch.kernels.apss_block.ops import _pad_to, _pick_bk, compact_worklist

    n, m = D.shape
    t, bm = threshold, 256

    paths = {
        "apss_blocked_kernel": lambda: apss_blocked(D, t, k, use_kernel=True),
        "apss_fused_compacted": lambda: apss_fused_compacted(D, t, k),
        "apss_blocked_plain": lambda: apss_blocked(D, t, k, use_kernel=False),
    }
    # Main path through the entry points, counted.
    reset_launches()
    first_ms = {}
    m_k1, first_ms["apss_blocked_kernel"] = timed(torch, paths["apss_blocked_kernel"])
    m_k2, first_ms["apss_fused_compacted"] = timed(torch, paths["apss_fused_compacted"])
    launches = launches_now()
    check(launches["apss_fused"] > 0 and launches["apss_tile_candidates"] > 0,
          f"{phase}: a kernel never ran: {launches}")

    ref, first_ms["apss_blocked_plain"] = timed(torch, paths["apss_blocked_plain"])
    wall = {name: wall_ms(np, torch, fn) for name, fn in paths.items()}
    near = near_threshold_counts(torch, D, t)
    ref_np = matches_to_numpy(ref)
    k2_np = matches_to_numpy(m_k2)
    c1 = compare(np, matches_to_numpy(m_k1), ref_np, t, near)
    c2 = compare(np, k2_np, ref_np, t, near)

    # The kernels' own inputs, as the main path builds them.
    bk = _pick_bk(m, 512)
    Dp = _pad_to(D, bm, bk)
    grid = Dp.shape[0] // bm
    mask1 = block_prune_mask(Dp, Dp, t, bm, bm, use_minsize=False)
    mask2, ub = block_prune_mask(Dp, Dp, t, bm, bm, return_ub=True)
    wl = compact_worklist(mask2, ub)
    ij = torch.as_tensor(wl).cuda()
    T = ij.shape[1]
    emit(phase, n=n, m=m, threshold=t, k=k, corpus_seconds=gen_s,
         live_tiles_k1=int(mask1.sum()), live_tiles_k2=int(mask2.sum()),
         total_tiles=grid * grid, worklist_T=T,
         total_matches=int(ref.counts.sum()),
         overflowed_rows=int(ref.overflowed().sum()),
         launches=launches,
         first_call_ms=first_ms, wall_ms=wall,
         k1_vs_plain=c1, k2_vs_plain=c2)
    check(c1["ok"], f"{phase}: K1 path disagrees with the plain path: {c1}")
    check(c2["ok"], f"{phase}: K2 path disagrees with the plain path: {c2}")

    near_p = np.concatenate([near, np.zeros(Dp.shape[0] - n, near.dtype)])
    valid = np.minimum(bm, n - np.arange(grid) * bm)  # valid rows per block
    rows = []

    # K1 against its plain version on the same padded inputs.
    kw1 = dict(block_m=bm, block_n=bm, n_valid_cols=n, exclude_self=True)
    out_k = fused.apss_fused_kernel(Dp, Dp, mask1, t, k, **kw1)
    out_p = fused.apss_fused_plain(Dp, Dp, mask1, t, k, **kw1)
    cmp1 = compare(np, as_rows(np, *out_k), as_rows(np, *out_p), t, near_p)
    check(cmp1["ok"], f"{phase}: K1 disagrees with its plain version: {cmp1}")
    mk = mask1.cpu().numpy()
    flop1 = 2.0 * m * float((mk * np.outer(valid, valid)).sum())
    bytes1 = 4.0 * n * m + n * (8 * k + 4) + mk.size
    rows.append(kernel_row(
        np, torch, "apss_fused", phase, launches, cmp1,
        lambda: fused.apss_fused_kernel(Dp, Dp, mask1, t, k, **kw1),
        lambda: fused.apss_fused_plain(Dp, Dp, mask1, t, k, **kw1),
        lambda: library_topk(torch, D, t, k), flop1, bytes1,
    ))

    # K2 against its plain version on the same padded inputs and worklist.
    kw2 = dict(block_m=bm, block_n=bm, n_valid=n)
    pk = fused.apss_tile_candidates_kernel(Dp, ij, t, k, **kw2)
    pp = fused.apss_tile_candidates_plain(Dp, ij, t, k, **kw2)
    cmp2 = packet_compare(np, phase, "K2", pk, pp, ij, grid=grid, bm=bm, k=k,
                          t=t, near_p=near_p)
    flop2 = 2.0 * m * float((valid[wl[0]] * valid[wl[1]]).sum())
    bytes2 = 4.0 * n * m + 8 * T + T * 2 * bm * (8 * k + 4)
    rows.append(kernel_row(
        np, torch, "apss_tile_candidates", phase, launches, cmp2,
        lambda: fused.apss_tile_candidates_kernel(Dp, ij, t, k, **kw2),
        lambda: fused.apss_tile_candidates_plain(Dp, ij, t, k, **kw2),
        lambda: library_topk(torch, D, t, k), flop2, bytes2,
    ))
    del Dp, m_k1, m_k2, ref, out_k, out_p, pk, pp
    torch.cuda.empty_cache()
    return rows, dict(k2=k2_np, near=near)


def k7_phase(np, torch, phase, D, *, threshold) -> dict:
    """K7 through ``apss_block_matmul`` (auto mask) on a dense corpus on the
    card, held against ``apss_block_plain`` element by element."""
    from repro_torch import apss_block_matmul
    from repro_torch.core.precision import dot_f32
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.kernels.apss_block import apss_block
    from repro_torch.kernels.apss_block.ops import _pad_to

    n, m = D.shape
    t, bm = threshold, 256
    reset_launches()
    out, first_ms = timed(torch, lambda: apss_block_matmul(D, D, t))
    launches = launches_now()
    check(launches["apss_block"] > 0, f"{phase}: K7 never ran: {launches}")
    wall = wall_ms(np, torch, lambda: apss_block_matmul(D, D, t))

    Dp = _pad_to(D, bm, 512)
    mask = block_prune_mask(Dp, Dp, t, bm, bm, use_minsize=False)
    kw = dict(block_m=bm, block_n=bm)
    pk = apss_block.apss_block_kernel(Dp, Dp, mask, t, **kw)
    pp = apss_block.apss_block_plain(Dp, Dp, t, block_mask=mask, **kw)
    band = (dot_f32(Dp, Dp) - t).abs() <= TOL
    cmp = dense_compare(torch, pk, pp, band)
    main = dense_compare(torch, out, pp[:n, :n], band[:n, :n])
    del band
    emit(phase, n=n, m=m, threshold=t, live_tiles=int(mask.sum()),
         total_tiles=mask.numel(), launches=launches, first_call_ms=first_ms,
         wall_ms=wall, nonzero=int((pp != 0).sum()), main_vs_plain=main,
         kernel_vs_plain=cmp)
    check(main["ok"] and cmp["ok"], f"{phase}: K7 disagrees with plain: {main} {cmp}")
    mk = mask.cpu().numpy()
    grid = Dp.shape[0] // bm
    valid = np.minimum(bm, n - np.arange(grid) * bm)
    flop = 2.0 * m * float((mk * np.outer(valid, valid)).sum())
    nbytes = 4.0 * n * m + 4.0 * Dp.shape[0] ** 2 + mk.size

    def library():
        s = torch.matmul(D, D.T)
        return torch.where(s >= t, s, 0.0)

    row = kernel_row(
        np, torch, "apss_block", phase, launches, cmp,
        lambda: apss_block.apss_block_kernel(Dp, Dp, mask, t, **kw),
        lambda: apss_block.apss_block_plain(Dp, Dp, t, block_mask=mask, **kw),
        library, flop, nbytes,
    )
    del Dp, out, pk, pp
    torch.cuda.empty_cache()
    return row


def dense_compare(torch, got, ref, band) -> dict:
    """K7's rule: values within TOL, zero pattern equal off the band."""
    zero_bad = int((((got != 0) != (ref != 0)) & ~band).sum())
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    return dict(zero_pattern_mismatches=zero_bad, max_abs_err=err,
                band_entries=int(band.sum()), ok=zero_bad == 0 and err <= TOL)


def sparse_phase(np, torch, phase, sp, gen_s, *, threshold, k, dense=None) -> dict:
    """The sparse self-join (K3) through ``apss_blocked(sp, use_kernel=True)``
    on a CSR corpus on the card, against the plain sparse path and, with
    ``dense``, against K2's result on the same data."""
    from repro_torch import apss_blocked
    from repro_torch.core.pruning import live_tile_mask, sparse_block_stats
    from repro_torch.core.sparse import pad_rows_sparse, to_dense
    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block import sparse
    from repro_torch.kernels.apss_block.fused import _tile_packets
    from repro_torch.kernels.apss_block.ops import compact_worklist, fold_packets

    n, m = sp.shape
    t, bm = threshold, 256
    kernel_path = lambda: apss_blocked(sp, t, k, use_kernel=True)  # noqa: E731
    plain_path = lambda: apss_blocked(sp, t, k, use_kernel=False)  # noqa: E731
    reset_launches()
    got, first_k = timed(torch, kernel_path)
    launches = launches_now()
    check(launches["sparse_tile_candidates"] > 0, f"{phase}: K3 never ran: {launches}")
    ref, first_p = timed(torch, plain_path)
    wall = {"apss_blocked_sparse_kernel": wall_ms(np, torch, kernel_path),
            "apss_blocked_sparse_plain": wall_ms(np, torch, plain_path, reps=1)}
    if dense is None:
        near = near_threshold_counts(torch, to_dense(sp), t)
    else:
        near = dense["near"]
    got_np = matches_to_numpy(got)
    c = compare(np, got_np, matches_to_numpy(ref), t, near)
    vs_k2 = None
    if dense is not None:
        vs_k2 = compare(np, got_np, dense["k2"], t, near)
        vs_k2["counts_equal"] = bool(np.array_equal(got_np[2], dense["k2"][2]))

    # K3's own inputs, built stage by stage as the main path builds them, each
    # stage timed on the host clock up to a synchronize.
    stage = {}
    spp, _ = pad_rows_sparse(sp, bm)
    grid = spp.n // bm

    def stats_and_mask():
        stats = sparse_block_stats(spp, bm)
        return live_tile_mask(stats, stats, t, return_ub=True)

    (mask, ub), stage["stats_mask"] = timed(torch, stats_and_mask)
    wl, stage["host_worklist"] = timed(torch, lambda: compact_worklist(mask, ub))
    ij = torch.as_tensor(wl).cuda()
    T = ij.shape[1]
    (bdims, bx), stage["host_support_gather"] = timed(
        torch, lambda: sparse.block_support_gather(spp, bm))
    (bx, bdims), stage["support_to_card"] = timed(
        torch, lambda: (torch.from_numpy(bx).cuda(), torch.from_numpy(bdims).cuda()))
    idxb = spp.indices.reshape(grid, bm, spp.cap)
    valb = spp.values.reshape(grid, bm, spp.cap)
    yg, stage["tile_gather"] = timed(
        torch, lambda: sparse.gather_tiles(bdims, idxb, valb, ij))
    kw = dict(n_valid=n)
    pk, stage["k3"] = timed(
        torch, lambda: sparse.sparse_tile_candidates_kernel(bx, yg, ij, t, k, **kw))
    _, stage["fold"] = timed(torch, lambda: fold_packets(
        ij, pk[0], pk[1], pk[2][..., 0], pk[3], pk[4], pk[5][..., 0],
        grid_m=grid, block_m=bm, k=k))
    S = bx.shape[2]
    emit(phase, n=n, m=m, cap=spp.cap, nnz=int(sp.nnz.sum()), threshold=t, k=k,
         corpus_seconds=gen_s, support_S=S, worklist_T=T,
         live_tiles=int(mask.sum()), total_tiles=grid * grid,
         yg_bytes=yg.numel() * 4, bx_bytes=bx.numel() * 4, stage_ms=stage,
         total_matches=int(ref.counts.sum()),
         overflowed_rows=int(ref.overflowed().sum()),
         launches=launches, first_call_ms={"kernel": first_k, "plain": first_p},
         wall_ms=wall, k3_vs_plain=c, k3_vs_k2=vs_k2)
    check(c["ok"], f"{phase}: K3 path disagrees with the plain sparse path: {c}")
    if vs_k2 is not None:
        check(vs_k2["ok"] and vs_k2["counts_equal"],
              f"{phase}: K3 path disagrees with K2 on the same data: {vs_k2}")

    near_p = np.concatenate([near, np.zeros(spp.n - n, near.dtype)])
    pp = sparse.sparse_tile_candidates_plain(bx, yg, ij, t, k, **kw)
    cmp = packet_compare(np, phase, "K3", pk, pp, ij, grid=grid, bm=bm, k=k,
                         t=t, near_p=near_p)
    valid = np.minimum(bm, n - np.arange(grid) * bm)
    flop = 2.0 * S * float((valid[wl[0]] * valid[wl[1]]).sum())
    nbytes = 4.0 * (bx.numel() + yg.numel()) + 8 * T + T * 2 * bm * (8 * k + 4)
    ib = ij[0].long()

    def library():
        s = torch.bmm(bx[ib], yg.transpose(1, 2))
        return _tile_packets(s, ij[0], ij[1], threshold=t, k=k, block_m=bm,
                             block_n=bm, n_valid=n)

    row = kernel_row(
        np, torch, "sparse_tile_candidates", phase, launches, cmp,
        lambda: sparse.sparse_tile_candidates_kernel(bx, yg, ij, t, k, **kw),
        lambda: sparse.sparse_tile_candidates_plain(bx, yg, ij, t, k, **kw),
        library, flop, nbytes,
    )
    del got, ref, bx, yg, pk, pp
    torch.cuda.empty_cache()
    return row


def kernel_row(np, torch, name, phase, launches, cmp, kernel, plain, library,
               flop, nbytes) -> dict:
    ms = time_ms(np, torch, kernel)
    plain_ms = time_ms(np, torch, plain)
    library_ms = time_ms(np, torch, library)
    bound_ms, bound_by = bound(flop, nbytes)
    return dict(
        name=f"{name}[{phase}]", **KERNEL_INFO[name],
        launches=launches[name], max_abs_err=cmp["max_abs_err"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, flop=flop, bytes=nbytes,
        near_tie_swaps=cmp.get("near_tie_swaps"),
    )


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
