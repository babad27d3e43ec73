"""query_topk: rectangular pruned scoring against a prebuilt APSSIndex.

Per call this computes only the query side of the bounds: the block stats
of the padded batch, then the paper's maxweight + minsize bounds against
the index's corpus block stats (the inverted-index candidacy test in
weighted form). The live ``(query block, corpus block)`` tiles are
compacted on the host into a worklist ordered by upper bound descending
and scored by the rectangular kernels: K4 (dense), K6 (sparse, on the
index's per-block supports) or, with ``early_exit``, K5, each folded into
``Matches`` by ``ops.fold_rect_packets``. No self-pair exclusion, no
mirror packets: queries are not corpus rows.

``early_exit=True`` exploits the worklist order: once every valid query row
of a block holds k values strictly above a tile's bound, no candidate of
that tile (each ≤ the bound) can enter its top-k, so the tile is skipped;
once that holds for every row, the scan stops. Values and ids equal the
full scan's; counts saturate at ``min(count, k)``. K5 runs the rule on the
card; everywhere else ``fused.early_exit_walk`` runs it, strict (k-th >
bound) as its doc explains.

The worklist is not bucket-padded: the reference pads it to a power of two
only so that its jitted inners do not retrace, and eager PyTorch does not
trace. ``TILES`` counts the tiles of every call, as ``fused.LAUNCHES``
counts launches; telemetry, metrics and trace hooks wait for ROADMAP queue
1 item 7; the sharded path (item 4) and ``plan=`` (item 5) are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.matches import Matches, empty_matches
from repro_torch.core.pruning import dense_block_stats, live_tile_mask
from repro_torch.core.sparse import SparseCorpus, to_dense
from repro_torch.kernels.apss_block.fused import (
    early_exit_walk,
    rect_tile_candidates_early_exit_kernel,
    rect_tile_candidates_kernel,
    rect_tile_candidates_plain,
)
from repro_torch.kernels.apss_block.ops import compact_rect_worklist, fold_rect_packets
from repro_torch.kernels.apss_block.sparse import (
    gather_query_tiles,
    rect_sparse_tile_candidates_kernel,
    rect_sparse_tile_candidates_plain,
)
from repro_torch.serving.index import APSSIndex


# Tiles of the query_topk calls since the caller last set them to 0: in the
# grid, live after pruning, and scored (fewer than live only under early_exit).
TILES = {"total": 0, "live": 0, "scored": 0}


def query_topk(
    index: APSSIndex,
    Q,
    threshold: float,
    k: int = 32,
    *,
    block_q: int = 128,
    use_kernel: bool = False,
    use_minsize: bool = True,
    early_exit: bool = False,
) -> Matches:
    """Top-k corpus neighbours ≥ ``threshold`` for a batch of queries.

    ``Q`` is ``(B, m)`` dense (numpy or a tensor; a :class:`SparseCorpus`
    batch is densified) and is scored as given (the server normalizes).
    Float32 and bfloat16 queries keep their dtype (other dtypes become
    float32) and every score is a float32 product of both operands widened
    exactly, whatever the corpus's dtype, as the reference promotes
    f32 × bf16. Returns ``Matches`` with
    global corpus row ids on the index's device, exact against the oracle
    ``extract_matches(Q @ Cᵀ, t, k, exclude_self=False)`` at every
    threshold, ``t ≤ 0`` included (pruned tiles are provably matchless).

    ``use_kernel`` scores through K4 (dense) or K6 (sparse) on a card, and
    ``early_exit`` with ``use_kernel`` on a dense index through K5; without
    it the plain versions run. Sparse early exit walks the worklist in
    plain PyTorch (the reference has no kernel for it either) and scores
    each tile it does not skip through K6 or, without ``use_kernel``, its
    plain version. On a CPU index the wrappers run their plain versions.
    Each call adds its tiles to ``TILES``.
    """
    Q = _queries(index, Q)
    B = Q.shape[0]
    dev = index.device
    Qp = torch.nn.functional.pad(Q, (0, 0, 0, (-B) % block_q))
    grid_q = Qp.shape[0] // block_q
    mask, ub = _query_mask(
        Qp, index.stats, threshold=threshold, block_q=block_q,
        use_minsize=use_minsize, normalized=index.normalized,
    )
    mk, ubh = mask.cpu().numpy(), ub.cpu().numpy()
    wl = compact_rect_worklist(mk, ubh)
    if wl is None:
        out, T, scored = empty_matches(B, k, dev), 0, 0
    else:
        T = wl.shape[1]
        ubw = ubh[wl[0], wl[1]].astype(np.float32)
        values, indices, counts, scored = _score(
            index, Qp, wl, ubw, threshold, k, B=B, block_q=block_q,
            grid_q=grid_q, use_kernel=use_kernel, early_exit=early_exit,
        )
        out = Matches(values=values[:B], indices=indices[:B], counts=counts[:B])
    TILES["total"] += int(mk.size)
    TILES["live"] += T
    TILES["scored"] += scored
    return out


def _queries(index: APSSIndex, Q) -> torch.Tensor:
    """The batch as a dense tensor on the index's device: f32 or bf16 as given
    (never rounded to the corpus's dtype) at the lane-padded width for a
    dense index, f32 for a sparse one."""
    if isinstance(Q, SparseCorpus):
        if Q.m != index.m:
            raise ValueError(f"dimension mismatch: Q.m={Q.m} vs index m={index.m}")
        Q = to_dense(Q.to(index.device))
    Q = torch.as_tensor(Q).to(index.device)
    if Q.dim() != 2 or Q.shape[1] != index.m:
        raise ValueError(f"Q must be (B, {index.m}); got {tuple(Q.shape)}")
    if index.is_sparse:
        return Q.float()
    if Q.dtype not in (torch.float32, torch.bfloat16):
        Q = Q.float()
    width = index.corpus.shape[1]
    return torch.nn.functional.pad(Q, (0, width - index.m)).contiguous()


def _query_mask(Qp, corpus_stats, *, threshold, block_q, use_minsize, normalized):
    """Query-side block stats and the live mask + upper bounds against the
    index's corpus stats: ``O(B·m)`` for the summary and one ``(B/bq × nb)``
    product for the bounds; nothing corpus-sized is recomputed."""
    qstats = dense_block_stats(Qp.float(), block_q)
    return live_tile_mask(
        qstats, corpus_stats, threshold,
        use_minsize=use_minsize, normalized=normalized, return_ub=True,
    )


def _score(index, Qp, wl, ubw, threshold, k, *, B, block_q, grid_q, use_kernel,
           early_exit):
    """Score the worklist ``wl (2, T)`` (bounds ``ubw``) and fold it.
    Returns ``(values, indices, counts, scored_tiles)``."""
    dev = index.device
    ij = torch.from_numpy(wl).to(dev)
    T = wl.shape[1]
    tile = dict(threshold=threshold, k=k, block_q=block_q)
    kw = dict(block_c=index.block_rows, nc_valid=index.n)
    fold = dict(grid_q=grid_q, block_q=block_q, k=k)
    if index.is_sparse:
        score = rect_sparse_tile_candidates_kernel if use_kernel else rect_sparse_tile_candidates_plain

        def packets(ij_t):
            qg = gather_query_tiles(Qp, index.bdims, ij_t, block_q)
            return score(qg, index.bx, ij_t, threshold, k, nc_valid=index.n)
    elif early_exit and use_kernel:
        fv, fi, fc, skipped = rect_tile_candidates_early_exit_kernel(
            Qp, index.corpus, ij, torch.from_numpy(ubw).to(dev), **tile, **kw, nq_valid=B,
        )
        values, indices, counts = fold_rect_packets(
            ij, torch.ones(T, dtype=torch.bool), fv, fi, fc[..., 0], **fold)
        return values, indices, counts.clamp_max(k), T - int(skipped.sum())
    else:
        score = rect_tile_candidates_kernel if use_kernel else rect_tile_candidates_plain

        def packets(ij_t):
            return score(Qp, index.corpus, ij_t, **tile, **kw)

    if early_exit:
        values, indices, counts, skipped = early_exit_walk(
            lambda t: packets(ij[:, t:t + 1]), ij, ubw, B, **fold)
        return values, indices, counts, T - int(skipped.sum())
    fv, fi, fc = packets(ij)
    values, indices, counts = fold_rect_packets(
        ij, torch.ones(T, dtype=torch.bool), fv, fi, fc[..., 0], **fold)
    return values, indices, counts, T
