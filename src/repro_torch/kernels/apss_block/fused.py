"""The dense worklist kernels: wrappers, launch counts and plain versions.

1. :func:`apss_fused_kernel` (K1, ``csrc/apss_fused.cu``) -- streaming fused
   extraction: per-row top-k and exact counts of ``X·Yᵀ ≥ t`` over every
   live column tile, with the score matrix never in device memory. The
   columns go in the segments of :func:`fused_segments`, one thread block
   per (128-row tile, segment), and a last launch merges the segments'
   lists as :func:`merge_segments_plain` does. A first launch writes each
   128-row tile's bitmap of the 32-feature chunks it holds a nonzero in
   (:func:`fused_occupancy_plain`), and a tile pair walks only the chunks
   both hold (:func:`fused_walk_plain` counts them).
2. :func:`apss_tile_candidates_kernel` (K2, ``csrc/tile_candidates.cu``) --
   per live upper-triangular tile of a ``(2, T)`` worklist, a forward packet
   (rows of block i) and a mirror packet (rows of block j), which
   ``ops.fold_packets`` folds into ``Matches``. The tiles are scored in the
   work items of :func:`tile_work_items` and selected in a second launch
   (``csrc/tile_items.cuh``, shared with K3).
3. :func:`rect_tile_candidates_kernel` (K4, ``csrc/rect_tile_candidates.cu``)
   -- query-time serving: per live (query block, corpus block) tile of a
   rectangular worklist, the forward packet of the query rows only (no
   mirror, no self-exclusion), folded by ``ops.fold_rect_packets``. Each
   tile is spread over the card in the work items of
   :func:`rect_work_split`, whose partials a second launch adds and
   selects from. Its masked entry (``col_live``/``qpos``) adds the live
   index's dead-column and own-position masks to that selection
   (``serving/mutable.py``'s delta joins).
4. :func:`rect_tile_candidates_early_exit_kernel` (K5,
   ``csrc/rect_tile_candidates_ee.cu``) -- K4 walking the worklist in its
   upper-bound-descending order with a running per-row values buffer, and
   skipping a tile once every valid row of its query block holds k values
   strictly above the tile's bound. One cooperative grid over every SM
   scores each tile in the work items of :func:`ee_work_split`.

K4 and K5 take queries and corpus in either of float32 and bfloat16, each
in its own (a bf16 index scores f32 queries unrounded, as the reference
promotes); every score is a float32 sum. Each wrapper takes the kernel's
padded inputs. On a CUDA tensor it checks
device, dtype, shape and contiguity, allocates the outputs, launches on the
current stream, raises on a non-zero status and adds one to
``LAUNCHES[name]``. On a CPU tensor it returns the plain PyTorch version of
the same function (:func:`apss_fused_plain`,
:func:`apss_tile_candidates_plain`), which the CPU tests hold against the
reference package and which the card's smoke run holds the kernels against.

With an op census active (``launch.op_analysis``) each launch also
reports its work at the padded shapes the card computes: FLOPs of the
tiles it scores, and the bytes of each scored tile's operand rows, its
outputs and its scratch (written and read back once); K1's are those of
the chunks it walks, plus its bitmaps' read of the operands. Work the launch
itself decides (K1's walked stages, K5's skips) is read when the census
closes. With no census this costs one ``is None`` check.

Top-k order everywhere: value descending, then global id ascending. Empty
slots are ``NEG_LARGE`` / ``-1``; the ops layer turns them into ``-inf``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.matches import NEG_INF, stable_topk, topk_by_id
from repro_torch.core.precision import dot_f32
from repro_torch.kernels import _build
from repro_torch.launch import op_analysis

# Finite stand-in for -inf inside the kernels; the ops layer converts it.
NEG_LARGE = -0.5e30
_VALID = -0.25e30  # values above this are real candidates

# Kernel launches by wrapper name; a launch is counted only where it happens.
LAUNCHES = {
    "apss_fused": 0,              # K1, this module
    "apss_tile_candidates": 0,    # K2, this module
    "sparse_tile_candidates": 0,  # K3, sparse.py
    "rect_tile_candidates": 0,       # K4, this module
    "rect_tile_candidates_masked": 0,  # K4's masked entry (the live index), this module
    "rect_tile_candidates_ee": 0,    # K5, this module
    "rect_sparse_tile_candidates": 0,  # K6, sparse.py
    "apss_block": 0,              # K7, apss_block.py
}

_TILE = 64  # block sides are multiples of it (csrc/apss_common.cuh, TILE)
_TK = 32    # widths are multiples of the kernels' feature stage (PK, TK)
TILE_ITEM = 128  # rows and columns of a K2/K3 work item (csrc/tile_items.cuh)
FUSED_TILE = 128    # K1's score tile, rows and columns (csrc/apss_fused.cu, FT)
OCC_WORD = 32 * _TK  # features of one word of K1's bitmaps (a bit a stage of its walk)
FUSED_MAX_K = 1024  # K1's largest k (its per-warp merge area in shared memory)
_MAX_SEGMENTS = 32  # K1's merge holds one segment per lane
SEGMENT_SLACK = 0.05  # K1 takes fewer segments for at most 5 % more tile steps
# Scratch K4 keeps live at once; a longer worklist runs in passes of tiles.
RECT_SCRATCH_BYTES = 1 << 28
_RECT_CHUNK = 64  # rectangular tiles selected together by the plain versions
_MAX_EE_K = 256  # K5's values buffer (csrc/apss_common.cuh, MAX_EE_K)
# Features per partial sum of a rectangular score (csrc/apss_common.cuh, FK):
# K4, K5 and K6 add FK-feature partials in increasing chunk order.
EE_FK = 1024
_EE_STRIP_C = 64  # corpus rows of one K5 work item (a score_strip's columns)
_THREADS = 256    # threads of a K5 block (csrc/apss_common.cuh, THREADS)


def lazy(fn):
    """``fn`` evaluated once, on the first call (deferred census work)."""
    box = []

    def get():
        if not box:
            box.append(fn())
        return box[0]

    return get


def packet_bytes(rows: int, k: int) -> int:
    """Bytes of ``rows`` packet rows: k values, k ids and a count."""
    return rows * (2 * k + 1) * 4


def _f32(threshold: float) -> float:
    return float(np.float32(threshold))


def _select(values: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k along the last axis of candidates whose ids ascend along it.

    Returns ``(values, ids)`` padded to ``k`` with ``NEG_LARGE`` / ``-1``.
    """
    v, pos = stable_topk(values, k)
    i = torch.gather(ids, -1, pos)
    valid = v > _VALID
    v = torch.where(valid, v, NEG_LARGE)
    i = torch.where(valid, i, -1)
    pad = k - v.shape[-1]
    if pad:
        v = torch.nn.functional.pad(v, (0, pad), value=NEG_LARGE)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    return v, i


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def apss_fused_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    block_mask: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_m: int,
    block_n: int,
    n_valid_cols: int,
    row_offset: int = 0,
    col_offset: int = 0,
    exclude_self: bool = True,
):
    """K1's function in plain PyTorch, one row block at a time.

    Returns ``(values (n_rows, k) f32, indices (n_rows, k) i32,
    counts (n_rows, 1) i32)``.
    """
    n_rows, n_cols = x.shape[0], y.shape[0]
    dev = x.device
    t = _f32(threshold)
    lcol = torch.arange(n_cols, dtype=torch.int32, device=dev)
    gcol = lcol + int(col_offset)
    col_ok = lcol < n_valid_cols
    live = block_mask.to(dev, torch.bool)
    outs = []
    for b in range(n_rows // block_m):
        s = dot_f32(x[b * block_m:(b + 1) * block_m], y)
        ok = (s >= t) & (col_ok & live[b].repeat_interleave(block_n))[None, :]
        if exclude_self:
            grow = (
                int(row_offset) + b * block_m
                + torch.arange(block_m, dtype=torch.int32, device=dev)
            )
            ok &= grow[:, None] != gcol[None, :]
        v, i = _select(
            torch.where(ok, s, NEG_LARGE),
            torch.where(ok, gcol[None, :], -1),
            k,
        )
        outs.append((v, i, ok.sum(dim=1, keepdim=True, dtype=torch.int32)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def fused_occupancy_plain(x: torch.Tensor) -> torch.Tensor:
    """K1's step 0 in plain PyTorch: the bitmaps of ``x (n, m)``'s 128-row
    tiles, ``(ceil(n / 128), 2, ceil(m / 1024))`` int32 words. Bit ``c`` of
    word ``[t, 0, j]`` is set where some row of tile ``t`` is nonzero in
    features ``[32 (32 j + c), +32)``, of ``[t, 1, j]`` where one of them is
    Inf or NaN; -0 counts as zero. ``m`` is a multiple of 32."""
    n, m = x.shape
    tiles, chunks = -(-n // FUSED_TILE), m // _TK
    words = -(-m // OCC_WORD)
    v = torch.nn.functional.pad(x, (0, 0, 0, tiles * FUSED_TILE - n))
    v = v.reshape(tiles, FUSED_TILE, chunks, _TK)
    bits = torch.stack([(v != 0).any(dim=3).any(dim=1),
                        (~torch.isfinite(v)).any(dim=3).any(dim=1)], dim=1)
    bits = torch.nn.functional.pad(bits, (0, words * 32 - chunks)).reshape(tiles, 2, words, 32)
    w = (bits.to(torch.int64) << torch.arange(32, device=x.device)).sum(dim=3)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


_POP8 = np.array([bin(b).count("1") for b in range(256)], np.int64)


def fused_walk_plain(occ_x: torch.Tensor, occ_y: torch.Tensor, block_mask: torch.Tensor, *,
                     block_m: int, block_n: int, m: int) -> tuple[int, int]:
    """The stages K1 walks and those of its walk over every chunk, from the
    bitmaps of :func:`fused_occupancy_plain`: over each 128 × 128 tile
    ``(i, j)`` under a live entry of ``block_mask`` (at ``block_m`` ×
    ``block_n``), ``popcount((ox_i & oy_j) | bad_x_i | bad_y_j)`` and
    ``m / 32``."""
    mask = torch.as_tensor(block_mask).cpu() != 0
    cells = mask.repeat_interleave(block_m // _TILE, dim=0).repeat_interleave(
        block_n // _TILE, dim=1)  # 64 x 64 cells, two to a tile side
    cells = torch.nn.functional.pad(cells, (0, cells.shape[1] % 2, 0, cells.shape[0] % 2))
    live = cells.reshape(cells.shape[0] // 2, 2, -1, 2).any(dim=3).any(dim=1).numpy()
    ox, oy = (np.ascontiguousarray(o.cpu().numpy()).view(np.uint32) for o in (occ_x, occ_y))
    walked = 0
    for i, cols in enumerate(live):
        w = (ox[i, 0] & oy[cols, 0]) | ox[i, 1] | oy[cols, 1]
        walked += int(_POP8[w.view(np.uint8)].sum())
    return walked, int(live.sum()) * (m // _TK)


def fused_segments(row_tiles: int, col_tiles: int, slots: int) -> int:
    """K1's number of column segments for a grid of ``row_tiles`` 128-row
    tiles by ``col_tiles`` 128-column tiles on a card that holds ``slots``
    thread blocks at once.

    At least enough segments for the grid to cover every slot twice (or
    every column tile its own segment, at most 32); among those, the lowest
    count (the fewest lists to merge, and the fewest runs of a segment's
    running top-k to refill) whose tile steps on the busiest slot,
    ``ceil(row_tiles · S / slots) · ceil(col_tiles / S)``, come within
    ``SEGMENT_SLACK`` of the fewest.
    """
    if row_tiles < 1 or col_tiles < 1 or slots < 1:
        raise ValueError(f"no segments for {row_tiles} x {col_tiles} tiles on {slots} slots")
    hi = min(col_tiles, _MAX_SEGMENTS)
    lo = min(hi, -(-2 * slots // row_tiles))
    steps = {s: -(-row_tiles * s // slots) * -(-col_tiles // s) for s in range(lo, hi + 1)}
    best = min(steps.values())
    return min(s for s, n in steps.items() if n <= (1 + SEGMENT_SLACK) * best)


def segment_bounds(col_tiles: int, n_segments: int) -> list[tuple[int, int]]:
    """The column tiles ``[ct0, ct1)`` of each K1 segment, as the kernel cuts
    them."""
    return [(s * col_tiles // n_segments, (s + 1) * col_tiles // n_segments)
            for s in range(n_segments)]


def merge_segments_plain(values: torch.Tensor, indices: torch.Tensor, counts: torch.Tensor):
    """K1's merge in plain PyTorch: per row, the first ``k`` of the union of
    the segments' top-k lists ``values, indices (S, n, k)`` by (value desc,
    id asc), and the sum of the segments' counts ``(S, n)``.

    Exact: the segments hold disjoint columns, and a member of the top-k of
    the union is in the top-k of its own segment. Returns ``(values (n, k),
    indices (n, k) i32, counts (n, 1) i32)`` with ``NEG_LARGE`` / ``-1``
    empties.
    """
    S, n, k = values.shape
    v = values.permute(1, 0, 2).reshape(n, S * k)
    i = indices.permute(1, 0, 2).reshape(n, S * k)
    i = torch.where(v > _VALID, i, torch.iinfo(torch.int32).max)  # empties last
    v, i = topk_by_id(v, i, k)
    valid = v > _VALID
    return (torch.where(valid, v, NEG_LARGE), torch.where(valid, i, -1).to(torch.int32),
            counts.sum(dim=0, dtype=torch.int32)[:, None])


def apss_fused_segmented_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    block_mask: torch.Tensor,
    threshold: float,
    k: int,
    *,
    n_segments: int,
    block_m: int,
    block_n: int,
    n_valid_cols: int,
    row_offset: int = 0,
    col_offset: int = 0,
    exclude_self: bool = True,
):
    """K1's launch shape in plain PyTorch: :func:`apss_fused_plain` on each
    of ``n_segments`` column segments of 128-column tiles (the columns of
    ``y`` passed with their own ``col_offset``, ``n_valid_cols`` and mask
    columns, at 64-column mask granularity), then
    :func:`merge_segments_plain`. Equals :func:`apss_fused_plain` on the
    whole of ``y``."""
    n_cols = y.shape[0]
    if n_cols % block_n or block_n % _TILE:
        raise ValueError(f"{n_cols} columns are not tiles of {block_n}")
    mask = block_mask.to(x.device, torch.int32).repeat_interleave(block_n // _TILE, dim=1)
    col_tiles = -(-n_cols // FUSED_TILE)
    parts = []
    for ct0, ct1 in segment_bounds(col_tiles, n_segments):
        c0, c1 = ct0 * FUSED_TILE, min(ct1 * FUSED_TILE, n_cols)
        parts.append(apss_fused_plain(
            x, y[c0:c1], mask[:, c0 // _TILE:c1 // _TILE], threshold, k,
            block_m=block_m, block_n=_TILE, n_valid_cols=min(max(n_valid_cols - c0, 0), c1 - c0),
            row_offset=row_offset, col_offset=col_offset + c0, exclude_self=exclude_self))
    v, i, c = (torch.stack(p) for p in zip(*parts))
    return merge_segments_plain(v, i, c[..., 0])


def _tile_packets(
    s, ib, jb, *, threshold: float, k: int, block_m: int, block_n: int,
    n_valid: int,
):
    """Forward + mirror candidate packets of a batch of self-join tiles.

    ``s (B, block_m, block_n)`` scores of tiles ``(ib[b], jb[b])``. Mirror
    candidate ids are the tile's ROW ids (``grow``): the mirror rows are the
    y-block's vectors and their partners the x-block's. Diagonal tiles emit
    an empty mirror packet (a copy would double-count).

    Returns ``(fv, fi, fc, bv, bi, bc)`` with counts shaped ``(B, block, 1)``.
    """
    dev = s.device
    ib = ib.to(torch.int32)[:, None, None]
    jb = jb.to(torch.int32)[:, None, None]
    grow = ib * block_m + torch.arange(block_m, dtype=torch.int32, device=dev)[:, None]
    gcol = jb * block_n + torch.arange(block_n, dtype=torch.int32, device=dev)[None, :]
    ok = (
        (s >= _f32(threshold))
        & (grow != gcol)
        & (grow < n_valid)
        & (gcol < n_valid)
    )
    sv = torch.where(ok, s, NEG_LARGE)
    fv, fi = _select(sv, torch.where(ok, gcol, -1), k)
    fc = ok.sum(dim=2, keepdim=True, dtype=torch.int32)
    mv, mi = _select(
        sv.transpose(1, 2), torch.where(ok, grow, -1).transpose(1, 2), k
    )
    diag = ib == jb
    bv = torch.where(diag, NEG_LARGE, mv)
    bi = torch.where(diag, -1, mi)
    bc = torch.where(diag, 0, ok.sum(dim=1, dtype=torch.int32)[..., None])
    return fv, fi, fc, bv, bi, bc


def apss_tile_candidates_plain(
    D: torch.Tensor,
    ij: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_m: int,
    block_n: int,
    n_valid: int,
    chunk_bytes: int = 1 << 30,
):
    """K2's function in plain PyTorch, in chunks of worklist entries whose
    gathered row blocks stay under ``chunk_bytes``.

    Returns ``(fv, fi, fc)`` shaped ``(T, block_m, k|k|1)`` and
    ``(bv, bi, bc)`` shaped ``(T, block_n, k|k|1)``.
    """
    n, m = D.shape
    T = ij.shape[1]
    ij = ij.to(D.device, torch.long)
    xb = D.view(n // block_m, block_m, m)
    yb = D.view(n // block_n, block_n, m)
    step = max(1, chunk_bytes // (4 * (block_m + block_n) * m))
    outs = []
    for a in range(0, T, step):
        ib, jb = ij[0, a:a + step], ij[1, a:a + step]
        s = dot_f32(xb[ib], yb[jb])
        outs.append(_tile_packets(
            s, ib, jb, threshold=threshold, k=k, block_m=block_m,
            block_n=block_n, n_valid=n_valid,
        ))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _rect_tile_packets(
    s, jb, *, threshold: float, k: int, block_q: int, block_c: int,
    nc_valid: int,
):
    """Forward packets of a batch of rectangular (query × corpus) tiles.

    ``s (B, block_q, block_c)`` scores of tiles whose corpus blocks have
    global ids ``jb (B,)``. Queries are not corpus rows: no self-exclusion
    and no mirror packet; ``gcol < nc_valid`` masks corpus padding rows.
    Returns ``(fv, fi, fc)`` shaped ``(B, block_q, k|k|1)``.
    """
    jb = jb.to(s.device, torch.int32)[:, None, None]
    gcol = jb * block_c + torch.arange(block_c, dtype=torch.int32, device=s.device)
    ok = (s >= _f32(threshold)) & (gcol < nc_valid)
    fv, fi = _select(torch.where(ok, s, NEG_LARGE), torch.where(ok, gcol, -1), k)
    return fv, fi, ok.sum(dim=2, keepdim=True, dtype=torch.int32)


def live_masked(s, ib, jb, col_live, qpos, *, block_q: int, block_c: int):
    """The live index's masks on a batch of tile scores ``s (B, block_q,
    block_c)`` of query blocks ``ib`` and corpus blocks ``jb``: a column
    whose ``col_live`` is False, or that is the query row's own corpus
    position ``qpos[row]`` (−1: none), scores ``NEG_LARGE``, which fails any
    real threshold, t ≤ 0 included (the reference's ``_mut_dense_inner``).
    ``None`` leaves a mask out."""
    dev = s.device
    gcol = jb.to(dev, torch.long)[:, None] * block_c + torch.arange(block_c, device=dev)
    if col_live is not None:
        s = torch.where(col_live.to(dev, torch.bool)[gcol][:, None, :], s, NEG_LARGE)
    if qpos is not None:
        grow = ib.to(dev, torch.long)[:, None] * block_q + torch.arange(block_q, device=dev)
        own = qpos.to(dev, torch.long)[grow][:, :, None] == gcol[:, None, :]
        s = torch.where(own, NEG_LARGE, s)
    return s


def rect_tile_candidates_plain(
    Q: torch.Tensor,
    C: torch.Tensor,
    ij: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_q: int,
    block_c: int,
    nc_valid: int,
    col_live: torch.Tensor | None = None,
    qpos: torch.Tensor | None = None,
):
    """K4's function in plain PyTorch, with its masked entry's masks
    (:func:`live_masked`; ``None``: unmasked).

    Rows 0 and 1 of ``ij (2|3, T)`` address the query and corpus blocks;
    packet column ids come from its last row. Each tile is one product, so
    a tile's scores do not depend on which other tiles share the call (the
    early-exit paths score single tiles and must give the same bits); the
    selection runs ``_RECT_CHUNK`` tiles at a time. Returns ``(fv, fi, fc)``
    shaped ``(T, block_q, k|k|1)``.
    """
    m = Q.shape[1]
    ij = ij.to(Q.device, torch.long)
    qb = Q.view(-1, block_q, m)
    cb = C.view(-1, block_c, m)
    wl = ij.cpu().tolist()
    outs = []
    step = _RECT_CHUNK
    for a in range(0, ij.shape[1], step):
        s = torch.stack([
            dot_f32(qb[qi], cb[cj])
            for qi, cj in zip(wl[0][a:a + step], wl[1][a:a + step])
        ])
        if col_live is not None or qpos is not None:
            s = live_masked(s, ij[0, a:a + step], ij[-1, a:a + step], col_live, qpos,
                            block_q=block_q, block_c=block_c)
        outs.append(_rect_tile_packets(
            s, ij[-1, a:a + step], threshold=threshold, k=k, block_q=block_q,
            block_c=block_c, nc_valid=nc_valid,
        ))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def early_exit_walk(packets, ij, ub, nq_valid: int, *, grid_q: int, block_q: int, k: int):
    """The strict early-exit rule in plain PyTorch, the one both early-exit
    paths run: the worklist ``ij (2|3, T)`` walked in order with running
    per-block top-k buffers.

    Tile ``t`` is skipped when ``ub[t]`` is a padding bound (≤ −0.25e30) or
    when every valid row (global row < ``nq_valid``; padded rows never pin a
    block) of its query block holds a k-th value strictly above ``ub[t]``.
    Once every valid row holds a k-th value above some bound, each later
    tile under it is skipped without looking at the buffers (the global stop:
    in a bound-descending worklist, the rest of it). Strict, where the
    reference skips at k-th ≥ bound: ties are ordered by (value desc, id
    asc), so a skipped tile holding a candidate equal to a row's k-th value
    with a lower id would change the result. ``packets(t)`` gives tile
    ``t``'s forward packet ``(1, block_q, k|k|1)``; each scored packet merges
    into its block's buffer in that order, which is the fold's result.

    Returns ``(values (grid_q·block_q, k), indices, counts saturated at k,
    skipped (T,) bool)``, the buffers on ``ij``'s device.
    """
    dev = ij.device
    cv = torch.full((grid_q, block_q, k), NEG_INF, device=dev)
    ci = torch.full((grid_q, block_q, k), -1, dtype=torch.int32, device=dev)
    cc = torch.zeros((grid_q, block_q), dtype=torch.int32, device=dev)
    live = torch.arange(grid_q * block_q, device=dev).view(grid_q, block_q) < nq_valid
    ubh = torch.as_tensor(ub).float().cpu().tolist()
    skipped = torch.ones(len(ubh), dtype=torch.bool)
    stop = NEG_INF  # every valid row's k-th value is above this
    for t, qi in enumerate(ij[0].tolist()):
        u = ubh[t]
        if u <= _VALID or u < stop:
            continue
        kth = torch.where(live, cv[:, :, k - 1], float("inf"))
        blk_min, stop = torch.stack([kth[qi].min(), kth.min()]).tolist()
        if blk_min > u:
            continue
        fv, fi, fc = packets(t)
        v, i = topk_by_id(torch.cat([cv[qi], fv[0]], 1), torch.cat([ci[qi], fi[0]], 1), k)
        i = torch.where(v > _VALID, i, -1)
        cv[qi] = torch.where(i >= 0, v, NEG_INF)
        ci[qi] = i
        cc[qi] += fc[0, :, 0]
        skipped[t] = False
    return cv.reshape(-1, k), ci.reshape(-1, k), cc.clamp_max(k).reshape(-1), skipped


def rect_tile_candidates_early_exit_plain(
    Q: torch.Tensor,
    C: torch.Tensor,
    ij: torch.Tensor,
    ub: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_q: int,
    block_c: int,
    nc_valid: int,
    nq_valid: int,
):
    """K5's function in plain PyTorch: :func:`early_exit_walk` over K4's
    plain per-tile packets, each scored packet kept at its worklist slot.

    A skipped tile's packet is ``(NEG_LARGE, -1, 0)``. Returns ``(fv, fi,
    fc, skipped)`` with ``skipped (T, 1)`` int32.
    """
    dev = Q.device
    T = ij.shape[1]
    ij = ij.to(dev, torch.long)
    fv = torch.full((T, block_q, k), NEG_LARGE, device=dev)
    fi = torch.full((T, block_q, k), -1, dtype=torch.int32, device=dev)
    fc = torch.zeros((T, block_q, 1), dtype=torch.int32, device=dev)

    def packets(t):
        p = rect_tile_candidates_plain(Q, C, ij[:, t:t + 1], threshold, k, block_q=block_q,
                                       block_c=block_c, nc_valid=nc_valid)
        fv[t], fi[t], fc[t] = (a[0] for a in p)
        return p

    *_, skipped = early_exit_walk(packets, ij, ub, nq_valid, grid_q=Q.shape[0] // block_q,
                                  block_q=block_q, k=k)
    return fv, fi, fc, skipped.to(dev, torch.int32)[:, None]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EeSplit:
    """K5's work split of one scored tile.

    ``items (n_items, 3)`` int32 rows are (feature chunk, first query row,
    first corpus row) of a strip of ``strip_rows`` query rows by 64 corpus
    rows over the chunk's FK features; ``grid`` is the number of thread
    blocks to launch."""

    n_chunks: int
    strip_rows: int
    items: np.ndarray
    grid: int


def ee_work_split(m: int, block_q: int, block_c: int, capacity: int) -> EeSplit:
    """The work items of one K5 tile over a co-resident grid of ``capacity``
    thread blocks.

    The features go in ``ceil(m / EE_FK)`` chunks (the summation order K4
    shares); the tile in strips of 64, 32 or 16 query rows (never more than
    twice ``block_q``) by 64 corpus rows. The tallest strip that still gives
    every block an item is taken, else the lowest, which gives the most
    items. The grid is ``capacity`` capped by the work of the widest phase:
    the items, the tile's elements at one per thread, its rows at one per
    warp.
    """
    if m < 1 or block_q < 1 or block_c % _EE_STRIP_C or capacity < 1:
        raise ValueError(f"no split for m={m}, block_q={block_q}, block_c={block_c}, "
                         f"capacity={capacity}")
    n_chunks = -(-m // EE_FK)
    heights = [h for h in (64, 32, 16) if h < 2 * block_q or h == 16]
    for rows in heights:
        if n_chunks * -(-block_q // rows) * (block_c // _EE_STRIP_C) >= capacity:
            break
    f, r0, c0 = np.meshgrid(np.arange(n_chunks), np.arange(0, block_q, rows),
                            np.arange(0, block_c, _EE_STRIP_C), indexing="ij")
    items = np.stack([f.ravel(), r0.ravel(), c0.ravel()], 1).astype(np.int32)
    work = max(len(items), -(-block_q * block_c // _THREADS), -(-block_q // (_THREADS // 32)))
    return EeSplit(n_chunks, rows, items, min(capacity, work))


def ee_capacity(q_dtype: torch.dtype, c_dtype: torch.dtype, k: int,
                device: torch.device) -> int:
    """Thread blocks of K5 that ``device`` holds at once (occupancy × SMs),
    for the instantiation of queries of ``q_dtype`` against a corpus of
    ``c_dtype``."""
    fn, check = _entry("rect_tile_candidates_ee",
                       f"apss_rect_tile_candidates_ee_capacity_{_pair(q_dtype, c_dtype)}",
                       [_I, _VP])
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(fn(k, ctypes.byref(blocks)))
    return blocks.value


def ee_split_for(Q: torch.Tensor, C: torch.Tensor, *, block_q: int, block_c: int,
                 k: int) -> EeSplit:
    """The split :func:`rect_tile_candidates_early_exit_kernel` launches
    with for queries ``Q`` against corpus ``C`` on the card."""
    return ee_work_split(Q.shape[1], block_q, block_c,
                         ee_capacity(Q.dtype, C.dtype, k, Q.device))


@dataclasses.dataclass(frozen=True)
class RectSplit:
    """K4's work split of a worklist of ``n_tiles`` tiles.

    One work item (thread block) per (tile, feature chunk of FK, strip of
    ``strip_c`` corpus rows), its query strip the whole query block in
    ``strip_rows`` rows, numbered ``((t - t0) * n_chunks + f) * strips +
    strip`` within a pass of ``pass_tiles`` tiles. ``scratch_bytes`` is the
    partial-sum scratch, ``(pass_tiles, n_chunks, block_q, block_c)`` f32."""

    n_tiles: int
    n_chunks: int
    strip_rows: int
    strip_c: int
    strips: int
    pass_tiles: int
    scratch_bytes: int

    @property
    def n_items(self) -> int:
        return self.n_tiles * self.n_chunks * self.strips

    def items(self) -> np.ndarray:
        """``(n_items, 4)`` int32 rows (tile, chunk, first query row, first
        corpus row), in the kernel's order: by pass, then by the item
        number within it."""
        t, f, c = np.meshgrid(np.arange(self.n_tiles), np.arange(self.n_chunks),
                              np.arange(self.strips) * self.strip_c, indexing="ij")
        return np.stack([t.ravel(), f.ravel(), np.zeros(t.size, np.int64),
                         c.ravel()], 1).astype(np.int32)


def rect_work_split(n_tiles: int, m: int, block_q: int, block_c: int,
                    budget: int = RECT_SCRATCH_BYTES) -> RectSplit:
    """K4's work items for ``n_tiles`` tiles of width ``m``: FK-feature
    chunks (the summation order K5 and K6 share) × corpus strips × one query
    strip, and the passes that keep the scratch within ``budget`` bytes (at
    least one tile a pass).

    The query strip is the query block rounded up to 8, 16, 32, 64 or 128
    rows and to at least ``2048 / block_c``: each of the kernel's 256
    threads owns 8 strip rows, so ``2048 / strip_rows`` threads lie along
    the corpus strip, which is ``block_c`` rows or 8 a thread, the fewer
    (``csrc/rect_tile_candidates.cu``)."""
    if n_tiles < 1 or m < 1 or not 1 <= block_q <= 128 or block_c not in (64, 128, 256):
        raise ValueError(f"no split for T={n_tiles}, m={m}, block_q={block_q}, "
                         f"block_c={block_c}")
    n_chunks = -(-m // EE_FK)
    strip_rows = 8
    while strip_rows < block_q or strip_rows * block_c < 8 * _THREADS:
        strip_rows *= 2
    strip_c = min(block_c, 8 * (8 * _THREADS // strip_rows))
    per_tile = 4 * n_chunks * block_q * block_c
    pass_tiles = max(1, min(n_tiles, budget // per_tile))
    return RectSplit(n_tiles, n_chunks, strip_rows, strip_c, block_c // strip_c, pass_tiles,
                     pass_tiles * per_tile)


def tile_work_items(n_tiles: int, block_m: int, block_n: int) -> np.ndarray:
    """The scoring work items of K2 and K3, one thread block each, in launch
    order: ``(t, r0, c0)`` int32 rows, each worklist tile cut into parts of
    up to ``TILE_ITEM`` rows (of block ``ij[0, t]``, from ``r0``) by
    ``TILE_ITEM`` columns (of the tile's column block, from ``c0``). The
    parts of one tile are adjacent, so they meet its operands in L2: 4 a
    tile at 256 × 256, 2 at 256 × 128 or 128 × 256, 1 at 128 × 128 or
    below."""
    if n_tiles < 1 or block_m < 1 or block_n < 1:
        raise ValueError(f"no work items for T={n_tiles}, block_m={block_m}, "
                         f"block_n={block_n}")
    t, r0, c0 = np.meshgrid(np.arange(n_tiles), np.arange(0, block_m, TILE_ITEM),
                            np.arange(0, block_n, TILE_ITEM), indexing="ij")
    return np.stack([t.ravel(), r0.ravel(), c0.ravel()], axis=1).astype(np.int32)


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _entry(lib_name: str, symbol: str, argtypes: list):
    """``(fn, check)`` of an APSS kernel entry (``_build.bind``)."""
    return _build.bind(lib_name, symbol, argtypes, errors="apss_error_string")


def _check_operand(name: str, a: torch.Tensor) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} must be float32 or bfloat16, got {a.dtype}")
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if a.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _suffix(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def _pair(q_dtype: torch.dtype, c_dtype: torch.dtype) -> str:
    """Entry suffix of a rectangular kernel: query type, then corpus type."""
    return f"{_suffix(q_dtype)}_{_suffix(c_dtype)}"


def fused_capacity(dtype: torch.dtype, k: int, device: torch.device) -> int:
    """Thread blocks of K1 that ``device`` holds at once at this ``k``
    (blocks an SM × SMs)."""
    fn, check = _entry("apss_fused", f"apss_fused_capacity_{_suffix(dtype)}", [_I, _VP, _VP])
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        check(fn(k, ctypes.byref(per_sm), ctypes.byref(sms)))
    return per_sm.value * sms.value


def fused_segments_for(x: torch.Tensor, n_cols: int, k: int) -> int:
    """The segment count :func:`apss_fused_kernel` launches with for rows
    ``x`` against ``n_cols`` columns on the card."""
    return fused_segments(-(-x.shape[0] // FUSED_TILE), -(-n_cols // FUSED_TILE),
                          fused_capacity(x.dtype, k, x.device))


# K1's stage counter of its last call on the card, a (2,) int64 tensor on the
# card; None after a call that ran the plain version.
_last_walk: list = [None]


def last_walk() -> tuple[int, int] | None:
    """``(stages walked, stages of the walk over every chunk)`` over the live
    128 × 128 tiles of the last :func:`apss_fused_kernel` call, or None if
    that call ran the plain version. Reading it waits for the call."""
    walked = _last_walk[0]
    return None if walked is None else tuple(walked.tolist())


def fused_occupancy(x: torch.Tensor) -> torch.Tensor:
    """K1's step 0 on its own: the bitmaps of :func:`fused_occupancy_plain`,
    from the occupancy kernel on a CUDA tensor and from the plain version
    on a CPU one."""
    if x.device.type == "cpu":
        return fused_occupancy_plain(x)
    _check_operand("x", x)
    n, m = x.shape
    if m % _TK:
        raise ValueError(f"m must be a multiple of {_TK}; got {m}")
    occ = torch.empty((-(-n // FUSED_TILE), 2, -(-m // OCC_WORD)), dtype=torch.int32,
                      device=x.device)
    fn, check = _entry("apss_fused", f"apss_fused_occupancy_{_suffix(x.dtype)}",
                       [_VP, _I, _I, _VP, _VP])
    check(fn(x.data_ptr(), n, m, occ.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream))
    return occ


def apss_fused_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    block_mask: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_m: int = 256,
    block_n: int = 256,
    n_valid_cols: int,
    row_offset: int = 0,
    col_offset: int = 0,
    exclude_self: bool = True,
):
    """K1 on padded inputs: ``x (n_rows, m)``, ``y (n_cols, m)``, ``block_mask
    (n_rows/block_m, n_cols/block_n)`` (0 ⇒ tile provably dead).

    ``row_offset``/``col_offset`` are the global ids of ``x[0]``/``y[0]``
    and ``n_valid_cols`` the count of non-padding rows of ``y``; all three
    are runtime arguments of the kernel. The columns run in
    :func:`fused_segments_for` segments; ``k`` above ``FUSED_MAX_K`` raises
    ``ValueError``. Each live tile walks only the 32-feature chunks where
    both of its row tiles hold a nonzero (or either an Inf or NaN), from the
    bitmaps of a first launch (:func:`fused_occupancy`), with the bits of
    the walk over every chunk; :func:`last_walk` reads the stages walked.
    Returns ``(values (n_rows, k) f32, indices (n_rows, k) i32,
    counts (n_rows, 1) i32)``.
    """
    kw = dict(
        block_m=block_m, block_n=block_n, n_valid_cols=n_valid_cols,
        row_offset=row_offset, col_offset=col_offset, exclude_self=exclude_self,
    )
    if x.device.type == "cpu":
        _last_walk[0] = None
        return apss_fused_plain(x, y, block_mask, threshold, k, **kw)
    _check_operand("x", x)
    _check_operand("y", y)
    n_rows, m = x.shape
    n_cols = y.shape[0]
    if y.device != x.device or y.dtype != x.dtype or y.shape[1] != m:
        raise ValueError("x and y must share device, dtype and width")
    if n_rows % block_m or n_cols % block_n:
        raise ValueError(
            f"({n_rows}, {n_cols}) not tile-divisible by ({block_m}, {block_n})"
        )
    if block_m % _TILE or block_n % _TILE or m % _TK:
        raise ValueError(
            f"block_m, block_n must be multiples of {_TILE} and m of {_TK}; "
            f"got {block_m}, {block_n}, {m}"
        )
    if not 1 <= k <= FUSED_MAX_K:
        raise ValueError(f"k must be in [1, {FUSED_MAX_K}] for K1's merge area; got {k}")
    mask = block_mask.to(x.device, torch.int32).contiguous()
    if tuple(mask.shape) != (n_rows // block_m, n_cols // block_n):
        raise ValueError(f"block_mask shape {tuple(mask.shape)} is not the grid")
    dev = x.device
    values = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    indices = torch.empty((n_rows, k), dtype=torch.int32, device=dev)
    counts = torch.empty((n_rows, 1), dtype=torch.int32, device=dev)
    S = fused_segments_for(x, n_cols, k)
    if S > 1:
        seg = (torch.empty((S, n_rows, k), dtype=torch.float32, device=dev),
               torch.empty((S, n_rows, k), dtype=torch.int32, device=dev),
               torch.empty((S, n_rows), dtype=torch.int32, device=dev))
    else:  # one segment: the kernel writes the output itself
        seg = (values, indices, counts)
    same = y.data_ptr() == x.data_ptr() and n_cols == n_rows  # one set of bitmaps
    tiles = -(-n_rows // FUSED_TILE) + (0 if same else -(-n_cols // FUSED_TILE))
    occ = torch.empty((tiles, 2, -(-m // OCC_WORD)), dtype=torch.int32, device=dev)
    walked = torch.empty(2, dtype=torch.int64, device=dev)
    fn, check = _entry(
        "apss_fused", f"apss_fused_{_suffix(x.dtype)}",
        [_VP] * 11 + [_I] * 8 + [_F, _I, _I, _I, _VP],
    )
    status = fn(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(), occ.data_ptr(), walked.data_ptr(),
        *(a.data_ptr() for a in seg),
        values.data_ptr(), indices.data_ptr(), counts.data_ptr(),
        n_rows, n_cols, m, block_m, block_n,
        int(row_offset), int(col_offset), int(n_valid_cols),
        _f32(threshold), k, int(bool(exclude_self)), S,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status)
    LAUNCHES["apss_fused"] += 1
    _last_walk[0] = walked
    if op_analysis.CENSUS is not None:
        stages = lazy(lambda: int(walked[0]))
        out = packet_bytes(n_rows, k) * (1 + 2 * S if S > 1 else 1)  # + segment lists
        step0 = (n_rows if same else n_rows + n_cols) * m * x.element_size() + 8 * occ.numel()
        op_analysis.report_kernel(
            "apss_fused", "apss_fused",
            lambda: 2.0 * stages() * FUSED_TILE * FUSED_TILE * _TK,
            lambda: stages() * 2 * FUSED_TILE * _TK * x.element_size() + out
            + 4 * mask.numel() + step0)
    return values, indices, counts


def apss_tile_candidates_kernel(
    D: torch.Tensor,
    ij: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_m: int = 256,
    block_n: int = 256,
    n_valid: int,
):
    """K2 on a padded corpus ``D (n, m)`` and a ``(2, T)`` worklist of live
    upper-triangular tiles: the :func:`tile_work_items` of every tile into a
    ``(T, block_m, block_n)`` f32 scratch, then the packets' selection.

    Returns forward packets ``(T, block_m, k)×2 + (T, block_m, 1)`` and
    mirror packets ``(T, block_n, k)×2 + (T, block_n, 1)``.
    """
    kw = dict(block_m=block_m, block_n=block_n, n_valid=n_valid)
    if D.device.type == "cpu":
        return apss_tile_candidates_plain(D, ij, threshold, k, **kw)
    _check_operand("D", D)
    n, m = D.shape
    if n % block_m or n % block_n:
        raise ValueError(f"n={n} not tile-divisible by ({block_m}, {block_n})")
    if block_m % _TILE or block_n % _TILE or max(block_m, block_n) > 256 or m % _TK:
        raise ValueError(
            f"block_m, block_n must be multiples of {_TILE} up to 256 and m of "
            f"{_TK}; got {block_m}, {block_n}, {m}"
        )
    ij = ij.to(D.device, torch.int32).contiguous()
    if ij.dim() != 2 or ij.shape[0] != 2 or ij.shape[1] < 1:
        raise ValueError(f"ij must be a non-empty (2, T) worklist: {tuple(ij.shape)}")
    lo, hi_i, hi_j = torch.stack([ij.min(), ij[0].max(), ij[1].max()]).tolist()
    if lo < 0 or hi_i >= n // block_m or hi_j >= n // block_n:
        raise ValueError("ij holds a block index outside the corpus")
    T = ij.shape[1]
    dev = D.device
    scratch = torch.empty((T, block_m, block_n), dtype=torch.float32, device=dev)
    fv = torch.empty((T, block_m, k), dtype=torch.float32, device=dev)
    fi = torch.empty((T, block_m, k), dtype=torch.int32, device=dev)
    fc = torch.empty((T, block_m, 1), dtype=torch.int32, device=dev)
    bv = torch.empty((T, block_n, k), dtype=torch.float32, device=dev)
    bi = torch.empty((T, block_n, k), dtype=torch.int32, device=dev)
    bc = torch.empty((T, block_n, 1), dtype=torch.int32, device=dev)
    fn, check = _entry(
        "tile_candidates", f"apss_tile_candidates_{_suffix(D.dtype)}",
        [_VP, _VP, _I] + [_VP] * 7 + [_I] * 4 + [_F, _I, _VP],
    )
    status = fn(
        D.data_ptr(), ij.data_ptr(), T, scratch.data_ptr(),
        fv.data_ptr(), fi.data_ptr(), fc.data_ptr(),
        bv.data_ptr(), bi.data_ptr(), bc.data_ptr(),
        m, block_m, block_n, int(n_valid), _f32(threshold), k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status)
    LAUNCHES["apss_tile_candidates"] += 1
    if op_analysis.CENSUS is not None:
        op_analysis.report_kernel(
            "apss_tile_candidates", "tile_candidates", 2.0 * T * block_m * block_n * m,
            T * (block_m + block_n) * m * D.element_size() + 8 * T * block_m * block_n
            + packet_bytes(T * (block_m + block_n), k) + 8 * T)
    return fv, fi, fc, bv, bi, bc


def _check_rect_blocks(block_q: int, block_c: int, width: int) -> None:
    if block_q % 8 or not 8 <= block_q <= 128 or block_c not in (64, 128, 256) or width % _TK:
        raise ValueError(
            "block_q must be a multiple of 8 up to 128, block_c 64, 128 or 256 "
            f"and the width a multiple of {_TK}; got {block_q}, {block_c}, {width}"
        )


def _worklist_on(ij, dev: torch.device, rows: tuple[int, ...], limits) -> torch.Tensor:
    """``ij`` as a contiguous int32 worklist on ``dev``, checked: ``rows`` it
    may have, and per row the exclusive upper bound of its block ids
    (``None``: any id ≥ 0). A worklist given on the host is checked there
    and copied without waiting for the device's queue, so that launches
    on several shards do not wait on each other."""
    ij = torch.as_tensor(ij).to(dtype=torch.int32).contiguous()
    if ij.dim() != 2 or ij.shape[0] not in rows or ij.shape[1] < 1:
        raise ValueError(
            f"ij must be a non-empty ({'|'.join(map(str, rows))}, T) worklist: "
            f"{tuple(ij.shape)}"
        )
    lo, *hi = torch.cat([ij.min()[None], ij.amax(dim=1)]).tolist()
    if lo < 0 or any(lim is not None and h >= lim for h, lim in zip(hi, limits)):
        raise ValueError("ij holds a block index outside the corpus or the queries")
    return ij.to(dev, non_blocking=True)


def _check_rect_operands(Q: torch.Tensor, C: torch.Tensor, block_q: int, block_c: int):
    _check_operand("Q", Q)
    _check_operand("C", C)
    nq, m = Q.shape
    if C.device != Q.device or C.shape[1] != m:
        raise ValueError("Q and C must share device and width")
    _check_rect_blocks(block_q, block_c, m)
    if nq % block_q or C.shape[0] % block_c:
        raise ValueError(
            f"({nq}, {C.shape[0]}) rows not divisible by ({block_q}, {block_c})"
        )
    return nq // block_q, C.shape[0] // block_c


def rect_tile_candidates_kernel(
    Q: torch.Tensor,
    C: torch.Tensor,
    ij: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_q: int = 128,
    block_c: int = 256,
    nc_valid: int,
    col_live: torch.Tensor | None = None,
    qpos: torch.Tensor | None = None,
):
    """K4 on padded queries ``Q (nq, m)``, a padded corpus ``C (nc, m)`` and
    a ``(2, T)`` or ``(3, T)`` worklist of live (query block, corpus block)
    tiles; packet column ids come from the worklist's last row. ``Q`` and
    ``C`` are each float32 or bfloat16. The work goes in the items of
    :func:`rect_work_split`.

    ``col_live (nc,)`` (bool, False = a dead column) and ``qpos (nq,)``
    (int, each query row's own corpus position or −1), given together and
    with a ``(2, T)`` worklist, are K4's masked entry (the live index's
    delta joins): those columns score ``NEG_LARGE`` before the threshold,
    in the selection launch only, so every score keeps the unmasked
    bits. Its launches count under ``"rect_tile_candidates_masked"``.

    Returns ``(fv, fi, fc)`` shaped ``(T, block_q, k|k|1)``.
    """
    kw = dict(block_q=block_q, block_c=block_c, nc_valid=nc_valid)
    if Q.device.type == "cpu":
        return rect_tile_candidates_plain(Q, C, ij, threshold, k, col_live=col_live,
                                          qpos=qpos, **kw)
    grid_q, grid_c = _check_rect_operands(Q, C, block_q, block_c)
    masked = col_live is not None or qpos is not None
    if masked and (col_live is None or qpos is None):
        raise ValueError("col_live and qpos go together")
    ij = _worklist_on(ij, Q.device, (2,) if masked else (2, 3), (grid_q, grid_c, None))
    R, T = ij.shape
    dev = Q.device
    masks = [None, None]
    if masked:
        col_live = torch.as_tensor(col_live).to(dev, torch.uint8).contiguous()
        qpos = torch.as_tensor(qpos).to(dev, torch.int32).contiguous()
        if tuple(col_live.shape) != (C.shape[0],) or tuple(qpos.shape) != (Q.shape[0],):
            raise ValueError(
                f"col_live {tuple(col_live.shape)} and qpos {tuple(qpos.shape)} must be "
                f"({C.shape[0]},) and ({Q.shape[0]},)")
        masks = [col_live.data_ptr(), qpos.data_ptr()]
    split = rect_work_split(T, Q.shape[1], block_q, block_c)
    part = torch.empty(split.scratch_bytes // 4, dtype=torch.float32, device=dev)
    fv = torch.empty((T, block_q, k), dtype=torch.float32, device=dev)
    fi = torch.empty((T, block_q, k), dtype=torch.int32, device=dev)
    fc = torch.empty((T, block_q, 1), dtype=torch.int32, device=dev)
    fn, check = _entry(
        "rect_tile_candidates", f"apss_rect_tile_candidates_{_pair(Q.dtype, C.dtype)}",
        [_VP, _VP, _VP, _I, _I, _VP, _I] + [_VP] * 3 + [_I] * 4 + [_F, _I] + [_VP] * 3,
    )
    status = fn(
        Q.data_ptr(), C.data_ptr(), ij.data_ptr(), R, T, part.data_ptr(), split.pass_tiles,
        fv.data_ptr(), fi.data_ptr(), fc.data_ptr(),
        Q.shape[1], block_q, block_c, int(nc_valid), _f32(threshold), k,
        torch.cuda.current_stream(dev).cuda_stream, *masks,
    )
    check(status)
    name = "rect_tile_candidates_masked" if masked else "rect_tile_candidates"
    LAUNCHES[name] += 1
    if op_analysis.CENSUS is not None:
        m = Q.shape[1]
        op_analysis.report_kernel(
            name, "rect_tile_candidates", 2.0 * T * block_q * block_c * m,
            T * (block_q * Q.element_size() + block_c * C.element_size()) * m
            + 8 * T * split.n_chunks * block_q * block_c + packet_bytes(T * block_q, k)
            + 4 * R * T + (C.shape[0] + 4 * Q.shape[0] if masked else 0))
    return fv, fi, fc


def rect_tile_candidates_early_exit_kernel(
    Q: torch.Tensor,
    C: torch.Tensor,
    ij: torch.Tensor,
    ub: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_q: int = 128,
    block_c: int = 256,
    nc_valid: int,
    nq_valid: int,
):
    """K5: K4 over a ``(2, T)`` worklist ordered by upper bound descending,
    with ``ub (T,)`` the tiles' bounds (``NEG_LARGE`` on padding entries)
    and ``nq_valid`` the count of real query rows (a runtime argument).

    Returns ``(fv, fi, fc, skipped)``: K4's packets (neutral on skipped
    tiles) and ``skipped (T, 1)`` int32.
    """
    kw = dict(block_q=block_q, block_c=block_c, nc_valid=nc_valid, nq_valid=nq_valid)
    if Q.device.type == "cpu":
        return rect_tile_candidates_early_exit_plain(Q, C, ij, ub, threshold, k, **kw)
    grid_q, grid_c = _check_rect_operands(Q, C, block_q, block_c)
    if not 1 <= k <= _MAX_EE_K:
        raise ValueError(f"k must be in [1, {_MAX_EE_K}] for the values buffer; got {k}")
    ij = _worklist_on(ij, Q.device, (2,), (grid_q, grid_c))
    T = ij.shape[1]
    dev = Q.device
    ub = torch.as_tensor(ub).to(dev, torch.float32).contiguous()
    if tuple(ub.shape) != (T,):
        raise ValueError(f"ub shape {tuple(ub.shape)} is not ({T},)")
    split = ee_split_for(Q, C, block_q=block_q, block_c=block_c, k=k)
    items = torch.from_numpy(split.items).to(dev)
    fv = torch.empty((T, block_q, k), dtype=torch.float32, device=dev)
    fi = torch.empty((T, block_q, k), dtype=torch.int32, device=dev)
    fc = torch.empty((T, block_q, 1), dtype=torch.int32, device=dev)
    skipped = torch.empty((T, 1), dtype=torch.int32, device=dev)
    topv = torch.empty((grid_q * block_q, k), dtype=torch.float32, device=dev)
    part = torch.empty((split.n_chunks, block_q, block_c), dtype=torch.float32, device=dev)
    fn, check = _entry(
        "rect_tile_candidates_ee", f"apss_rect_tile_candidates_ee_{_pair(Q.dtype, C.dtype)}",
        [_VP] * 4 + [_I, _I] + [_VP] * 7 + [_I] * 8 + [_F, _I, _VP],
    )
    status = fn(
        Q.data_ptr(), C.data_ptr(), ij.data_ptr(), ub.data_ptr(), T, grid_q,
        fv.data_ptr(), fi.data_ptr(), fc.data_ptr(), skipped.data_ptr(),
        topv.data_ptr(), part.data_ptr(), items.data_ptr(), len(split.items),
        split.strip_rows, split.grid, Q.shape[1], block_q, block_c, int(nc_valid),
        int(nq_valid), _f32(threshold), k, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status)
    LAUNCHES["rect_tile_candidates_ee"] += 1
    if op_analysis.CENSUS is not None:
        m = Q.shape[1]
        scored = lazy(lambda: T - int(skipped.sum()))
        per_tile = ((block_q * Q.element_size() + block_c * C.element_size()) * m
                    + 8 * split.n_chunks * block_q * block_c)
        op_analysis.report_kernel(
            "rect_tile_candidates_ee", "rect_tile_candidates_ee",
            lambda: 2.0 * scored() * block_q * block_c * m,
            lambda: scored() * per_tile + packet_bytes(T * block_q, k) + 16 * T)
    return fv, fi, fc, skipped
