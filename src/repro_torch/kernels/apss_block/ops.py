"""Public wrappers of the self-join kernels: padding, masks, worklists, folds.

- :func:`apss_block_matmul` -- the dense-output kernel (K7): the
  thresholded ``n×n`` score matrix, dead tiles zero (validation and
  benchmarks; ``O(n²)`` device memory).
- :func:`apss_fused` -- streaming fused extraction (K1): matmul →
  threshold → top-k merge → count in one kernel, ``Matches``-shaped
  ``O(n·k)`` output; the ``n×n`` score matrix never exists.
- :func:`apss_fused_compacted` -- the worklist path (K2): the live mask is
  compacted on the host into upper-triangular tiles, each computed once
  for both orientations (S = Sᵀ), and the per-tile packets are folded into
  ``Matches`` by :func:`fold_packets`.
- :func:`compact_rect_worklist` and :func:`fold_rect_packets` -- the same
  two steps for the rectangular (queries × corpus) tiles of serving
  (``serving/query.py``, kernels K4, K5 and K6).

Each runs its kernel on a CUDA tensor and the kernel's plain version on a
CPU one (``fused.py``, ``apss_block.py``); the entry points take
``device=`` and default to the card. The sparse worklist path (K3) is
``sparse.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.matches import NEG_INF, Matches, empty_matches, topk_by_id
from repro_torch.core.pruning import block_prune_mask
from repro_torch.interop import _host, as_corpus
from repro_torch.kernels.apss_block.apss_block import apss_block_kernel
from repro_torch.kernels.apss_block.fused import (
    _VALID,
    apss_fused_kernel,
    apss_tile_candidates_kernel,
)


def _pad_to(x: torch.Tensor, mult0: int, mult1: int) -> torch.Tensor:
    p0 = (-x.shape[0]) % mult0
    p1 = (-x.shape[1]) % mult1
    if p0 or p1:
        x = torch.nn.functional.pad(x, (0, p1, 0, p0))
    return x


def _pick_bk(m: int, block_k: int) -> int:
    """Feature-axis tile: requested size, shrunk for narrow inputs so the
    zero-padding stays < one tile (multiples of 128)."""
    return min(block_k, max(128, -(-m // 128) * 128))


def _padded_pair(x, y, threshold, block_mask, auto_mask, block_m, block_n, bk, device):
    """``x``/``y`` on ``device``, rows padded to ``block_m``/``block_n`` and
    features to ``bk``, with the tile mask: the caller's, else the maxweight
    bound mask (``auto_mask``), else all live. Returns ``(nx, ny, xp, yp,
    mask)``."""
    same = y is x
    x = as_corpus(x, device)
    y = x if same else as_corpus(y, device)
    xp = _pad_to(x, block_m, bk)
    yp = xp if y is x and block_n == block_m else _pad_to(y, block_n, bk)
    if block_mask is None:
        if auto_mask:
            block_mask = block_prune_mask(
                xp, yp, threshold, block_m, block_n, use_minsize=False
            )
        else:
            grid = (xp.shape[0] // block_m, yp.shape[0] // block_n)
            block_mask = torch.ones(grid, dtype=torch.int32, device=xp.device)
    block_mask = torch.as_tensor(block_mask).to(xp.device)
    return x.shape[0], y.shape[0], xp, yp, block_mask


def apss_block_matmul(
    x,
    y,
    threshold: float,
    *,
    block_mask=None,
    auto_mask: bool = True,
    block_m: int = 256,
    block_n: int = 256,
    block_k: int = 512,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Thresholded similarity matrix ``where(X·Yᵀ ≥ t, ·, 0)`` with tile
    skipping, from K7.

    Rows are padded to ``block_m``/``block_n`` and features to ``block_k``.
    Without ``block_mask``, the maxweight bound mask is computed from the
    padded inputs (``auto_mask``); ``auto_mask=False`` runs every tile.
    Returns ``(nx, ny)`` f32.
    """
    n_rows, n_cols, xp, yp, block_mask = _padded_pair(
        x, y, threshold, block_mask, auto_mask, block_m, block_n, block_k, device
    )
    out = apss_block_kernel(
        xp, yp, block_mask, threshold, block_m=block_m, block_n=block_n
    )
    return out[:n_rows, :n_cols]


def apss_fused(
    x,
    y,
    threshold: float,
    k: int,
    *,
    block_mask=None,
    auto_mask: bool = True,
    block_m: int = 256,
    block_n: int = 256,
    block_k: int = 512,
    row_offset: int = 0,
    col_offset: int = 0,
    exclude_self: bool = True,
    device: str | torch.device = "cuda",
) -> Matches:
    """Fused streaming similarity join: ``Matches`` straight from K1.

    ``x (nq, m)`` query rows, ``y (nc, m)`` corpus rows (numpy or tensors;
    moved to ``device``). Offsets are runtime arguments of the kernel, so a
    distribution schedule can change them at every step. Without
    ``block_mask``, the maxweight bound mask gates tiles (``auto_mask``).
    The two steps are :func:`_padded_pair` and :func:`apss_fused_padded`.
    """
    return apss_fused_padded(
        *_padded_pair(
            x, y, threshold, block_mask, auto_mask, block_m, block_n,
            _pick_bk(x.shape[1], block_k), device,
        ),
        threshold, k, block_m=block_m, block_n=block_n, row_offset=row_offset,
        col_offset=col_offset, exclude_self=exclude_self,
    )


def apss_fused_padded(
    nq: int,
    nc: int,
    xp: torch.Tensor,
    yp: torch.Tensor,
    block_mask: torch.Tensor,
    threshold: float,
    k: int,
    *,
    block_m: int = 256,
    block_n: int = 256,
    row_offset: int = 0,
    col_offset: int = 0,
    exclude_self: bool = True,
) -> Matches:
    """K1 and its tail on :func:`_padded_pair`'s ``(nq, nc, xp, yp,
    block_mask)``: ``Matches`` of the ``nq`` query rows against the ``nc``
    corpus rows."""
    values, indices, counts = apss_fused_kernel(
        xp, yp, block_mask, threshold, k,
        block_m=block_m, block_n=block_n, n_valid_cols=nc,
        row_offset=int(row_offset), col_offset=int(col_offset),
        exclude_self=exclude_self,
    )
    values = torch.where(indices >= 0, values, NEG_INF)
    return Matches(values=values[:nq], indices=indices[:nq], counts=counts[:nq, 0])


def compact_worklist(mask, ub=None) -> np.ndarray | None:
    """Host-side live mask → dense upper-triangular worklist ``(2, T)``.

    Symmetrizes first (the minsize bound is asymmetric: a pair is live if
    either orientation is), then keeps ``j ≥ i`` only: each off-diagonal
    tile is computed once for both orientations (S = Sᵀ). Returns None when
    nothing is live. With ``ub`` (the ``(nb, nb)`` tile upper bounds of
    ``core.pruning.live_tile_mask(return_ub=True)``), live tiles are sorted
    by upper bound descending (the paper's adaptive ordering); results do
    not depend on the order.
    """
    live = _host(mask).astype(bool)
    live = np.triu(live | live.T)
    iu, ju = np.nonzero(live)
    if iu.size == 0:
        return None
    if ub is not None:
        u = _host(ub).astype(np.float64)
        u = np.maximum(u, u.T)  # match the symmetrized liveness
        order = np.argsort(-u[iu, ju], kind="stable")
        iu, ju = iu[order], ju[order]
    return np.stack([iu, ju]).astype(np.int32)


def pad_worklist(wl: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Bucket-pad a ``(2, T)`` worklist to the next power of two.

    Padding entries repeat tile ``(0, 0)`` and are marked invalid in the
    returned ``(Tb,)`` bool vector, so a fold can drop them.
    """
    T = wl.shape[1]
    Tb = 1 << max(0, (T - 1).bit_length())
    valid = np.zeros((Tb,), bool)
    valid[:T] = True
    if Tb == T:
        return wl, valid
    pad = np.zeros((2, Tb - T), np.int32)
    return np.concatenate([wl, pad], axis=1), valid


def compact_rect_worklist(mask, ub=None) -> np.ndarray | None:
    """Host-side live mask → rectangular worklist ``(2, T)`` of live
    ``(query_block, corpus_block)`` tiles (the serving sibling of
    :func:`compact_worklist`: no symmetry, no triangular cut), ordered by
    ``ub`` descending when given, ties in row-major order. None when
    nothing is live."""
    iu, ju = np.nonzero(_host(mask).astype(bool))
    if iu.size == 0:
        return None
    if ub is not None:
        order = np.argsort(-_host(ub).astype(np.float64)[iu, ju], kind="stable")
        iu, ju = iu[order], ju[order]
    return np.stack([iu, ju]).astype(np.int32)


def _fold_by_block(blk, pv, pi, pc, *, grid, block, k, per_block=None):
    """Fold packets ``pv/pi (P, block, k)``, ``pc (P, block)`` into the row
    blocks ``blk (P,)`` they target: counts add, and one top-k per row over
    all of its block's packets by (value desc, id asc), which is exact
    because packets entering one row block come from disjoint column
    ranges. Packets are grouped by target block into a ``(grid, P_max,
    block, k)`` buffer, ``P_max`` the most any block receives. A caller
    that knows the packets per block on the host passes them
    (``per_block``, numpy): the buffer is then sized without waiting on
    the device."""
    dev = pv.device
    counts = torch.zeros((grid, block), dtype=torch.int32, device=dev)
    counts.index_add_(0, blk, pc.to(torch.int32))
    order = torch.argsort(blk, stable=True)
    blk = blk[order]
    if per_block is None:
        per_block = torch.bincount(blk, minlength=grid)
        P = int(per_block.max())
    else:
        P = int(per_block.max())
        per_block = torch.from_numpy(per_block).to(dev, non_blocking=True)
    start = torch.cumsum(per_block, 0) - per_block
    slot = torch.arange(blk.numel(), device=dev) - start[blk]
    shape = (grid, P, block, k)
    buf_v = torch.full(shape, NEG_INF, dtype=torch.float32, device=dev)
    buf_i = torch.full(shape, -1, dtype=torch.int32, device=dev)
    buf_v[blk, slot] = pv[order]
    buf_i[blk, slot] = pi[order]
    cand_v = buf_v.permute(0, 2, 1, 3).reshape(grid, block, P * k)
    cand_i = buf_i.permute(0, 2, 1, 3).reshape(grid, block, P * k)
    v, i = topk_by_id(cand_v, cand_i, k)
    i = torch.where(v > _VALID, i, -1)
    values = torch.where(i >= 0, v, NEG_INF).reshape(grid * block, k)
    return values, i.reshape(grid * block, k), counts.reshape(grid * block)


def fold_packets(ij, fv, fi, fc, bv, bi, bc, *, grid_m, block_m, k):
    """Fold per-tile candidate packets into flat ``(values, indices, counts)``.

    ``ij (2, T)`` worklist of upper-triangular tiles; ``f*`` are the forward
    packets (rows of block ``ij[0, t]``), ``b*`` the mirror packets (rows of
    block ``ij[1, t]``; empty on diagonal tiles); counts are ``(T, block_m)``.
    """
    dev = fv.device
    ij = torch.as_tensor(ij).to(dev, torch.long)
    off = ij[0] != ij[1]  # a diagonal tile's mirror packet is empty
    return _fold_by_block(
        torch.cat([ij[0], ij[1][off]]),
        torch.cat([fv, bv[off]]), torch.cat([fi, bi[off]]), torch.cat([fc, bc[off]]),
        grid=grid_m, block=block_m, k=k,
    )


def fold_rect_packets(ij, tvalid, fv, fi, fc, *, grid_q, block_q, k):
    """Fold rectangular forward packets (rows of query block ``ij[0, t]``)
    into flat ``(values, indices, counts)``; counts are ``(T, block_q)``.

    ``tvalid (T,)`` marks real worklist entries: padding entries (which may
    alias a real tile) are neutralised (values −inf, ids −1, counts 0)
    before the merge, so they never count twice. A worklist given as a
    numpy array sizes the fold on the host, so that the fold does not wait
    for the packets' kernel (the sharded query folds every shard's packets
    before any result is read).
    """
    dev = fv.device
    per_block = np.bincount(ij[0], minlength=grid_q) if isinstance(ij, np.ndarray) else None
    ij = torch.as_tensor(ij).to(dev, torch.long, non_blocking=True)
    dead = ~torch.as_tensor(tvalid).to(dev, torch.bool, non_blocking=True)
    return _fold_by_block(
        ij[0],
        torch.where(dead[:, None, None], NEG_INF, fv),
        torch.where(dead[:, None, None], -1, fi),
        torch.where(dead[:, None], 0, fc),
        grid=grid_q, block=block_q, k=k, per_block=per_block,
    )


def apss_fused_compacted(
    D,
    threshold: float,
    k: int,
    *,
    block_m: int = 256,
    block_k: int = 512,
    use_minsize: bool = True,
    device: str | torch.device = "cuda",
) -> Matches:
    """Self-join via the live-tile worklist kernel (K2).

    The block bound mask is compacted ON THE HOST into a dense list of live
    upper-triangular ``(i, j)`` tiles: a pruned tile costs nothing, and each
    off-diagonal tile is computed once for both orientations (S = Sᵀ).
    """
    D = as_corpus(D, device)
    n, m = D.shape
    bk = _pick_bk(m, block_k)
    Dp = _pad_to(D, block_m, bk)
    grid_m = Dp.shape[0] // block_m

    mask, ub = block_prune_mask(
        Dp, Dp, threshold, block_m, block_m, use_minsize=use_minsize,
        return_ub=True,
    )
    wl = compact_worklist(mask, ub)
    if wl is None:
        return empty_matches(n, k, Dp.device)
    ij = torch.as_tensor(wl).to(Dp.device)

    fv, fi, fc, bv, bi, bc = apss_tile_candidates_kernel(
        Dp, ij, threshold, k, block_m=block_m, block_n=block_m, n_valid=n,
    )
    values, indices, counts = fold_packets(
        ij, fv, fi, fc[..., 0], bv, bi, bc[..., 0],
        grid_m=grid_m, block_m=block_m, k=k,
    )
    return Matches(values=values[:n], indices=indices[:n], counts=counts[:n])
