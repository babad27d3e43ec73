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

On a sharded index (``index.n_shards > 1``) one global mask against the
home device's block stats yields each shard's live tiles: its block range
(``index.shard_block_range``) is sliced out and compacted into a ``(3, T)``
worklist of local block coordinates whose last row carries the global
block id, so packet ids are global and validity is checked against the
global ``n``. Every dense shard is scored by K4 (or its plain version) on
its own device, all launched before any fold, and a sparse shard by
gather-dot against its CSR blocks; each partial is folded on its device
and the partials are merged on the home device in ascending shard order,
which keeps the unsharded fold's tie order (lower ids first). K4's scores
do not depend on which tiles share a launch, so the sharded K4 result
equals the unsharded one bit for bit. As in the reference, early exit and
the kernel on a sparse shard raise ``NotImplementedError``.

The worklist is not bucket-padded: the reference pads it to a power of two
only so that its jitted inners do not retrace, and eager PyTorch does not
trace. ``TILES`` counts the tiles of every call, as ``fused.LAUNCHES``
counts launches. ``plan="auto"`` (or a ``planner.costmodel.QueryPlan``)
lets the cost model choose ``block_q`` and the kernel per batch. With a
telemetry log active, a call records ``serving/query`` (or
``serving/query-sharded``) and, with ``early_exit``, ``serving/early-exit``,
as the reference does; its metrics and trace hooks are ROADMAP queue 1
item 7.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.matches import Matches, empty_matches, merge_matches
from repro_torch.core.pruning import dense_block_stats, live_tile_mask
from repro_torch.core.sparse import SparseCorpus, gather_dot, to_dense
from repro_torch.kernels.apss_block.fused import (
    _RECT_CHUNK,
    _rect_tile_packets,
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
from repro_torch.planner import telemetry
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
    plan=None,
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
    A sharded index runs the per-shard path of the module doc. Each call
    adds its tiles to ``TILES``.

    ``plan="auto"`` (or an explicit ``planner.costmodel.QueryPlan``)
    delegates the ``block_q`` / kernel choice to the cost model, priced
    per batch from the index's exact block stats; its decision overrides
    the ``block_q`` and ``use_kernel`` arguments. On an index on a card
    the kernel is a candidate, on the CPU it is not.
    """
    Q = _queries(index, Q)
    if plan is not None:
        from repro_torch.planner.costmodel import plan_query_topk

        if isinstance(plan, str):
            if plan != "auto":
                raise ValueError(f"plan must be 'auto' or a QueryPlan; got {plan!r}")
            plan = plan_query_topk(index, Q.shape[0], float(threshold), k)
        block_q = int(plan.block_q)
        use_kernel = bool(plan.use_kernel)
    if index.n_shards > 1:
        if early_exit:
            raise NotImplementedError(
                "early_exit is a single-host worklist optimization; the "
                "sharded path prunes per shard but scans its full live "
                "worklist"
            )
        return _sharded_query(index, Q, threshold, k, block_q=block_q,
                              use_kernel=use_kernel, use_minsize=use_minsize)
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
    T = 0 if wl is None else wl.shape[1]
    if telemetry.enabled():
        telemetry.record(telemetry.ApssStats(
            variant="serving/query",
            n=index.n, m=index.m, block_rows=index.block_rows, sparse=index.is_sparse,
            flops=2.0 * T * block_q * index.block_rows * _depth(index),
            live_tiles=T, total_tiles=int(mk.size),
            tile_counts=tuple(int(x) for x in mk.sum(axis=1)),
            extra={"batch": B, "use_kernel": use_kernel},
        ))
    if wl is None:
        out, scored = empty_matches(B, k, dev), 0
    else:
        ubw = ubh[wl[0], wl[1]].astype(np.float32)
        values, indices, counts, scored = _score(
            index, Qp, wl, ubw, threshold, k, B=B, block_q=block_q,
            grid_q=grid_q, use_kernel=use_kernel, early_exit=early_exit,
        )
        out = Matches(values=values[:B], indices=indices[:B], counts=counts[:B])
        if early_exit and telemetry.enabled():
            telemetry.record(telemetry.ApssStats(
                variant="serving/early-exit",
                n=index.n, m=index.m, block_rows=index.block_rows,
                sparse=index.is_sparse, live_tiles=T, total_tiles=int(mk.size),
                extra={"batch": B, "skipped_tiles": T - scored},
            ))
    TILES["total"] += int(mk.size)
    TILES["live"] += T
    TILES["scored"] += scored
    return out


def _depth(index: APSSIndex) -> int:
    """Features a scored tile reads: the support width of a sparse index's
    blocks (its cap when sharded), the lane-padded width of a dense one."""
    if index.is_sparse:
        return int(index.bdims.shape[1] if index.n_shards == 1 else index.shards[0][0].shape[1])
    return int(index.shards[0].shape[1])


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
    width = index.shards[0].shape[1]
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


def _sharded_query(index, Q, threshold, k, *, block_q, use_kernel, use_minsize) -> Matches:
    """The sharded path of the module doc: one global mask, a ``(3, T)``
    worklist per shard with live tiles, every shard's packets launched,
    then each folded on its device and the partials merged in shard order
    on the home device, with no wait on a device after the mask."""
    if index.is_sparse and use_kernel:
        raise NotImplementedError(
            "sharded sparse indexes score via the XLA gather path (no "
            "bdims/bx support compaction is built per shard); use_kernel "
            "applies to dense shards"
        )
    B = Q.shape[0]
    Qp = torch.nn.functional.pad(Q, (0, 0, 0, (-B) % block_q))
    grid_q = Qp.shape[0] // block_q
    mask, ub = _query_mask(
        Qp, index.stats, threshold=threshold, block_q=block_q,
        use_minsize=use_minsize, normalized=index.normalized,
    )
    mk, ubh = mask.cpu().numpy(), ub.cpu().numpy()
    work = shard_worklists(index, mk, ubh)
    live = sum(ij.shape[1] for _, ij in work)
    if telemetry.enabled():
        per_shard = dict((s, ij.shape[1]) for s, ij in work)
        telemetry.record(telemetry.ApssStats(
            variant="serving/query-sharded",
            n=index.n, m=index.m, devices=index.n_shards, block_rows=index.block_rows,
            sparse=index.is_sparse,
            flops=2.0 * live * block_q * index.block_rows * _depth(index),
            live_tiles=live, total_tiles=int(mk.size),
            tile_counts=tuple(per_shard.get(s, 0) for s in range(index.n_shards)),
            extra={"batch": B, "use_kernel": use_kernel},
        ))
    TILES["total"] += int(mk.size)
    TILES["live"] += live
    TILES["scored"] += live
    if not work:
        return empty_matches(B, k, index.device)
    # Every shard's launch is enqueued before its fold, and the folds take
    # host worklists (sized on the host), so nothing here waits on a
    # device: shards on several cards overlap, shards on one card queue.
    packets = [_shard_packets(index, s, Qp, ij, threshold, k, block_q=block_q,
                              use_kernel=use_kernel) for s, ij in work]
    parts = []
    for (_, ij), (fv, fi, fc) in zip(work, packets):
        folded = fold_rect_packets(ij, np.ones(ij.shape[1], bool), fv, fi, fc[..., 0],
                                   grid_q=grid_q, block_q=block_q, k=k)
        parts.append(Matches(*(x.to(index.device) for x in folded)))
    out = functools.reduce(merge_matches, parts)
    return Matches(values=out.values[:B], indices=out.indices[:B], counts=out.counts[:B])


def shard_worklists(index, mask: np.ndarray, ub: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """``(s, ij)`` for each shard with live tiles of the global host ``mask``
    and bounds ``ub``: its block range compacted by bound into a ``(3, T)``
    worklist of query block, local corpus block and global corpus block."""
    work = []
    for s in range(index.n_shards):
        lo, hi = index.shard_block_range(s)
        wl = compact_rect_worklist(mask[:, lo:hi], ub[:, lo:hi])
        if wl is not None:
            work.append((s, np.concatenate([wl, wl[1:2] + lo])))
    return work


def _shard_packets(index, s, Qp, ij, threshold, k, *, block_q, use_kernel):
    """Shard ``s``'s packets of the ``(3, T)`` host worklist ``ij``."""
    dev = index.shard_device(s)
    kw = dict(block_q=block_q, block_c=index.block_rows, nc_valid=index.n)
    if index.is_sparse:
        return _sparse_shard_packets(Qp.to(dev), index.shards[s], ij, threshold, k, **kw)
    score = rect_tile_candidates_kernel if use_kernel else rect_tile_candidates_plain
    return score(Qp.to(dev), index.shards[s], torch.from_numpy(ij), threshold, k, **kw)


def _sparse_shard_packets(Qp, shard, ij, threshold, k, *, block_q, block_c, nc_valid):
    """K4's packets on a CSR shard: ``gather_dot`` of query block ``ij[0, t]``
    against the shard's block ``ij[1, t]``, packet ids from the global block
    ``ij[2, t]`` (the reference's ``sparse_body``); ``_RECT_CHUNK`` tiles are
    selected at a time."""
    idx, val, _ = shard  # every slot is summed, padding slots add 0
    cap = idx.shape[1]
    ci, cv = idx.view(-1, block_c, cap), val.view(-1, block_c, cap)
    qb = Qp.float().view(-1, block_q, Qp.shape[1])
    outs = []
    for a in range(0, ij.shape[1], _RECT_CHUNK):
        t = slice(a, a + _RECT_CHUNK)
        s = torch.stack([gather_dot(qb[qi], ci[cj], cv[cj])
                         for qi, cj in zip(ij[0, t].tolist(), ij[1, t].tolist())])
        outs.append(_rect_tile_packets(
            s, torch.from_numpy(ij[2, t]), threshold=threshold, k=k, block_q=block_q,
            block_c=block_c, nc_valid=nc_valid,
        ))
    return tuple(torch.cat(parts) for parts in zip(*outs))
