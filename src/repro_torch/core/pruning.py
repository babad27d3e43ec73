"""Candidate pruning bounds at tile granularity (PyTorch).

The sequential optimizations of Bayardo et al. (partial indexing / minsize)
exploit per-dimension ``maxweight`` upper bounds to skip work. Here they are
evaluated per tile: a cheap summary product yields a
``(row_blocks × col_blocks)`` mask of provably-below-threshold block pairs,
which the kernels skip.

All bounds are conservative: a pruned block pair can contain **no** match,
so pruned execution stays exact.

For CSR corpora (``core.sparse``) the same bounds come straight from the
sparse layout (:func:`sparse_block_prune_mask`): block maxima by
scatter-max, per-row sizes from the stored ``nnz``, and the inverted-index
candidacy test, since blocks that share no dimension have a zero bound.

Local pruning (paper Lemma 1): if ``sim(x, y) ≥ t`` then at least one of
``p`` dimension shards sees a partial score ``≥ t/p``
(:func:`local_threshold`); :func:`checkerboard_live_mask` composes the
per-slice masks of the 2-D split by it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.precision import dot_f32


class BlockStats(NamedTuple):
    """Per-row-block pruning summaries: the *index-build* half of pruning.

    Attributes:
      maxw:    ``(nb, m)`` per-block per-dimension max ``|weight|``.
      mw:      ``(nb,)`` per-block max weight (max of ``maxw`` over dims).
      max_nnz: ``(nb,)`` int32 per-block max row nnz (the paper's ``|y|``).
    """

    maxw: torch.Tensor
    mw: torch.Tensor
    max_nnz: torch.Tensor


STATS_CHUNK_BYTES = 1 << 28  # the rows dense_block_stats reads at a time


def dense_block_stats(
    D: torch.Tensor, block_rows: int, eps: float = 0.0
) -> BlockStats:
    """Block pruning summaries from a dense ``(n, m)`` tensor.

    Taken over whole row blocks of about ``STATS_CHUNK_BYTES`` at a time,
    so the temporaries (``|D|`` and its nonzero mask) stay that size
    instead of the corpus's: ranks that share a card hold several corpora.
    """
    n, m = D.shape
    if n % block_rows:
        raise ValueError(f"rows {n} not a multiple of block_rows {block_rows}")
    chunk = block_rows * max(1, STATS_CHUNK_BYTES // (block_rows * m * D.element_size()))
    parts = [
        (block_maxweight_bounds(c, block_rows), *block_minsize_bounds(c, block_rows, eps))
        for c in D.split(chunk)
    ]
    maxw, mw, max_nnz = (torch.cat(f) for f in zip(*parts))
    return BlockStats(maxw=maxw, mw=mw, max_nnz=max_nnz)


def sparse_block_stats(sp, block_rows: int) -> BlockStats:
    """Block pruning summaries straight from padded CSR (never densified).

    ``max_nnz`` uses the corpus's exact stored per-row nnz; stored nnz
    over-counts duplicate coordinates, which only loosens (never unsounds)
    the minsize bound.
    """
    maxw = sparse_block_maxweight(sp, block_rows)
    max_nnz = sp.nnz.reshape(-1, block_rows).amax(dim=1)
    return BlockStats(maxw=maxw, mw=maxw.amax(dim=1), max_nnz=max_nnz)


def live_tile_mask(
    stats_rows: BlockStats,
    stats_cols: BlockStats,
    threshold: float,
    *,
    use_minsize: bool = True,
    normalized: bool = True,
    return_ub: bool = False,
):
    """``(n_row_blocks, n_col_blocks)`` bool LIVE mask from block stats.

    ``normalized`` refers to the column side (the minsize bound needs
    ``||y|| = 1``). ``return_ub=True`` also returns the f32 upper bounds,
    the worklist ordering key (``ops.compact_worklist``).
    """
    t = float(np.float32(threshold))
    ub = block_upper_bounds(stats_rows.maxw, stats_cols.maxw)
    live = ub >= t
    if use_minsize and normalized:
        ms_ub = (
            stats_rows.mw.float()[:, None]
            * torch.sqrt(stats_cols.max_nnz.float())[None, :]
        )
        live &= ms_ub >= t
        ub = torch.minimum(ub, ms_ub)
    if return_ub:
        return live, ub
    return live


def block_maxweight_bounds(D: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Per-block, per-dimension max absolute weight: ``(n/b, m)``."""
    n, m = D.shape
    if n % block_rows:
        raise ValueError(f"rows {n} not a multiple of block_rows {block_rows}")
    return D.abs().reshape(n // block_rows, block_rows, m).amax(dim=1)


def block_upper_bounds(
    maxw_rows: torch.Tensor, maxw_cols: torch.Tensor
) -> torch.Tensor:
    """Upper bound on any cross-block similarity: ``ub[I, J] ≥ max sim``.

    ``sim(x, y) ≤ Σ_d maxw_I[d]·maxw_J[d]`` for ``x ∈ I``, ``y ∈ J``.
    """
    return dot_f32(maxw_rows, maxw_cols)


def row_nnz(D: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Number of non-zero components per row (paper's ``|x|``)."""
    return (D.abs() > eps).sum(dim=-1, dtype=torch.int32)


def block_minsize_bounds(
    D: torch.Tensor, block_rows: int, eps: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(max_weight, max_nnz)`` per row block for the minsize bound.

    For unit rows, Cauchy-Schwarz over the nonzero support gives
    ``sim(x, y) ≤ maxweight(x) · sqrt(|y|)``.
    """
    n, m = D.shape
    if n % block_rows:
        raise ValueError(f"rows {n} not a multiple of block_rows {block_rows}")
    absD = D.abs().reshape(n // block_rows, block_rows, m)
    max_weight = absD.amax(dim=(1, 2))
    nnz = (absD > eps).sum(dim=-1, dtype=torch.int32)
    return max_weight, nnz.amax(dim=1)


def block_prune_mask(
    D_rows: torch.Tensor,
    D_cols: torch.Tensor,
    threshold: float,
    block_rows: int,
    block_cols: int | None = None,
    *,
    use_minsize: bool = True,
    normalized: bool = True,
    return_ub: bool = False,
):
    """``(n_row_blocks, n_col_blocks)`` bool mask; True = block pair is LIVE.

    ``D_rows`` are query rows, ``D_cols`` corpus rows (self-join: the same
    tensor). A thin wrapper over :func:`dense_block_stats` +
    :func:`live_tile_mask`.
    """
    block_cols = block_cols or block_rows
    stats_r = dense_block_stats(D_rows, block_rows)
    stats_c = (
        stats_r
        if D_cols is D_rows and block_cols == block_rows
        else dense_block_stats(D_cols, block_cols)
    )
    return live_tile_mask(
        stats_r, stats_c, threshold,
        use_minsize=use_minsize, normalized=normalized, return_ub=return_ub,
    )


class PruneStats(NamedTuple):
    live_blocks: torch.Tensor    # scalar i32
    total_blocks: torch.Tensor   # scalar i32
    live_fraction: torch.Tensor  # scalar f32


def prune_stats(mask: torch.Tensor) -> PruneStats:
    total = torch.tensor(mask.numel(), dtype=torch.int32)
    live = mask.sum(dtype=torch.int32).cpu()
    return PruneStats(
        live_blocks=live,
        total_blocks=total,
        live_fraction=live.float() / total.float(),
    )


def local_threshold(threshold: float, num_shards: int) -> torch.Tensor:
    """Paper Lemma 1: local pruning threshold ``t_local = t / p``."""
    return torch.tensor(threshold, dtype=torch.float32) / num_shards


# ---------------------------------------------------------------------------
# Sparse-exact bounds: inverted-index candidacy + tile bounds computed from
# the padded-CSR corpus (core.sparse.SparseCorpus), never from a dense array.
# ---------------------------------------------------------------------------


def sparse_block_maxweight(sp, block_rows: int) -> torch.Tensor:
    """Per-block per-dimension max weight ``(n/b, m)`` from CSR, by scatter-max.

    Duplicate coordinates are combined first (``core.sparse.dedupe_rows``),
    so the bound sees the effective per-component magnitude ``|Σ slots|``:
    a per-slot max would under-bound concentrated duplicates and prune
    unsoundly. Padding slots ``(0, 0.0)`` are inert under max-with-0.
    """
    from repro_torch.core.sparse import dedupe_rows

    n = sp.n
    if n % block_rows:
        raise ValueError(f"rows {n} not a multiple of block_rows {block_rows}")
    idx, comp = dedupe_rows(sp.indices, sp.values)
    blk = torch.arange(n, device=idx.device)[:, None] // block_rows
    out = torch.zeros(((n // block_rows) * sp.m,), dtype=torch.float32,
                      device=idx.device)
    out.scatter_reduce_(0, (blk * sp.m + idx).reshape(-1), comp.abs().reshape(-1),
                        reduce="amax")
    return out.reshape(n // block_rows, sp.m)


def sparse_block_support(sp, block_rows: int) -> torch.Tensor:
    """Tile-granular posting lists: ``sup[B, d]`` ⇔ dimension ``d``'s posting
    list intersects row block ``B`` (the inverted index, quantized to
    blocks)."""
    return sparse_block_maxweight(sp, block_rows) > 0


def sparse_candidate_mask(sup_rows: torch.Tensor, sup_cols: torch.Tensor) -> torch.Tensor:
    """Inverted-index candidate generation at tile granularity.

    A tile ``(I, J)`` is a candidate iff some dimension's posting list hits
    both blocks. :func:`sparse_block_prune_mask` enforces this through the
    weighted maxweight bound instead (no shared support ⇒ ``ub = 0 < t``
    for any ``t > 0``), which stays sound at ``t ≤ 0``; this boolean form is
    for index statistics and candidate accounting.
    """
    return dot_f32(sup_rows.float(), sup_cols.float()) > 0


def sparse_block_prune_mask(
    sp_rows,
    sp_cols,
    threshold: float,
    block_rows: int,
    block_cols: int | None = None,
    *,
    use_minsize: bool = True,
    normalized: bool = True,
    return_ub: bool = False,
):
    """``(n_row_blocks, n_col_blocks)`` LIVE mask from CSR inputs only.

    The maxweight bound over sparse block maxima (which is the
    inverted-index candidacy test in weighted form) and, with
    ``use_minsize`` and unit rows, the minsize bound from the exact stored
    nnz. Both are trivially live at ``t ≤ 0``. A self-join
    (``sp_cols is sp_rows``) computes its stats once.
    """
    block_cols = block_cols or block_rows
    stats_r = sparse_block_stats(sp_rows, block_rows)
    stats_c = (
        stats_r
        if sp_cols is sp_rows and block_cols == block_rows
        else sparse_block_stats(sp_cols, block_cols)
    )
    return live_tile_mask(
        stats_r, stats_c, threshold,
        use_minsize=use_minsize, normalized=normalized, return_ub=return_ub,
    )


def checkerboard_live_mask(
    cells,
    threshold: float,
    block_rows: int,
    *,
    use_minsize: bool = True,
) -> torch.Tensor:
    """Self-join LIVE mask under a 2-D checkerboard dimension split.

    ``cells`` are the ``r`` dimension slices of one corpus
    (:func:`~repro_torch.core.sparse.dim_slices`). The mask is the OR over
    cells of each cell's :func:`sparse_block_prune_mask` at Lemma 1's local
    threshold ``t/r``: a pair with ``sim ≥ t`` has a partial ``≥ t/r`` in
    some slice, so its tile is live in that cell's mask. Each cell's minsize
    bound takes the unit-norm form although a cell's rows have norm ≤ 1,
    which only over-bounds, so the composed mask stays sound. It is a
    host-side candidacy check: the exact distributed rescoring needs every
    cell's partials, so no schedule skips work by it.
    """
    t_local = local_threshold(threshold, len(cells))
    live = None
    for cell in cells:
        cell_live = sparse_block_prune_mask(
            cell, cell, t_local, block_rows, use_minsize=use_minsize, normalized=True,
        )
        live = cell_live if live is None else live | cell_live
    return live
