"""CSR tile kernel K3: the sparse self-join's worklist path.

The dense worklist path (``ops.apss_fused_compacted``) does ``O(bm·bn·m)``
work per live tile, mostly on zeros at the paper's densities. The sparse
twin works on per-block support compaction (the gather-densify-per-tile
form of the paper's partial indexing):

1. On the host, each row block ``B`` gets its sorted unique dimension list
   ``bdims[B] (S,)`` (``S`` = the largest support over blocks, padded to
   ``lane_pad``) and its rows densified onto that list, ``bx[B] (bm, S)``
   (:func:`block_support_gather`).
2. The live-tile worklist comes from ``core.pruning.sparse_block_prune_mask``
   (inverted-index candidacy ∧ maxweight ∧ exact minsize), from CSR only.
3. Per live tile ``(I, J)``, block ``J``'s CSR rows are gathered onto
   ``bdims[I]`` (binary search + scatter-add, plain torch,
   :func:`gather_tiles`) giving ``yg[t] (bm, S)``. Tile scores are the dense
   product ``bx[I] · yg[t]ᵀ``: exact, because every nonzero of block ``I``
   lies in its own support and dimensions outside it contribute zero.
4. :func:`sparse_tile_candidates_kernel` (K3, ``csrc/sparse_tile_candidates.cu``)
   turns ``(bx, yg, ij)`` into forward and mirror candidate packets exactly
   as K2 does, and ``ops.fold_packets`` folds them into ``Matches``. K2 and
   K3 share one body (``csrc/tile_items.cuh``): it scores the tiles in the
   work items of :func:`sparse_work_items` (K2's ``fused.tile_work_items``,
   up to 128 × 128 scores each), then selects the packets in a second
   launch.

Query-time serving scores dense query blocks against the same per-block
supports: :func:`gather_query_tiles` gathers, per live (query block, corpus
block) tile, the query rows' components at the corpus block's support, and
:func:`rect_sparse_tile_candidates_kernel` (K6,
``csrc/rect_sparse_tile_candidates.cu``) turns ``(qg, bx, ij)`` into the
forward packets that ``ops.fold_rect_packets`` folds.

On a CPU tensor each wrapper runs its plain version (the same tiles in plain
PyTorch); on a CUDA tensor it launches the kernel or raises. Exactness: identical counts and match sets to ``apss_reference`` on
the densified corpus, duplicates-sum semantics included (duplicate
coordinates land in the same gathered slot and accumulate).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.matches import Matches, empty_matches
from repro_torch.core.precision import dot_f32
from repro_torch.core.pruning import sparse_block_prune_mask
from repro_torch.core.sparse import SparseCorpus, pad_rows_sparse
from repro_torch.kernels.apss_block.fused import (
    _I,
    _RECT_CHUNK,
    _TILE,
    RECT_SCRATCH_BYTES,
    TILE_ITEM,
    _TK,
    _VP,
    _F,
    LAUNCHES,
    _check_operand,
    _check_rect_blocks,
    _entry,
    _f32,
    _rect_tile_packets,
    _suffix,
    _tile_packets,
    _worklist_on,
    packet_bytes,
    rect_work_split,
    tile_work_items,
)
from repro_torch.kernels.apss_block.ops import compact_worklist, fold_packets
from repro_torch.launch import op_analysis
from repro_torch.obs import trace


def block_support_gather(
    sp: SparseCorpus, block_m: int, *, pad_to: int = 128
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side per-block support compaction (numpy).

    Returns ``bdims (nb, S)``, the sorted unique dims per row block padded
    with the sentinel ``m`` (sorts last, matches nothing), and
    ``bx (nb, bm, S)``, the block's rows densified onto its own support.
    ``S`` is padded to a multiple of ``pad_to``.
    """
    idx = sp.indices.cpu().numpy()
    val = sp.values.cpu().numpy()
    nnz = sp.nnz.cpu().numpy()
    n, cap = idx.shape
    if n % block_m:
        raise ValueError(f"rows {n} not a multiple of block_m {block_m}")
    nb = n // block_m
    valid = np.arange(cap)[None, :] < nnz[:, None]
    uniq = []
    for b in range(nb):
        sl = slice(b * block_m, (b + 1) * block_m)
        uniq.append(np.unique(idx[sl][valid[sl]]))
    S = max(1, max((len(u) for u in uniq), default=1))
    S = -(-S // pad_to) * pad_to
    bdims = np.full((nb, S), sp.m, np.int32)
    bx = np.zeros((nb, block_m, S), np.float32)
    rows = np.arange(block_m)[:, None]
    for b, u in enumerate(uniq):
        if len(u) == 0:
            continue
        bdims[b, : len(u)] = u
        sl = slice(b * block_m, (b + 1) * block_m)
        pos = np.searchsorted(u, idx[sl])
        pos = np.minimum(pos, len(u) - 1)
        hit = (u[pos] == idx[sl]) & valid[sl]
        np.add.at(bx[b], (rows, pos), np.where(hit, val[sl], 0.0))
    return bdims, bx


def _gather_block(bd: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Gather CSR blocks onto sorted support lists: ``(..., bn, S)``.

    ``bd (..., S)`` supports, ``idx``/``val (..., bn, cap)`` the blocks' CSR
    rows (leading dims shared). Binary search into the support; misses
    (dims outside ``bd``, padding slots) contribute 0; duplicate
    coordinates accumulate.
    """
    S = bd.shape[-1]
    lead = idx.shape[:-2]
    flat = idx.reshape(*lead, -1)
    pos = torch.searchsorted(bd, flat)  # in [0, S]
    in_range = pos.clamp_max(S - 1)
    hit = torch.gather(bd, -1, in_range) == flat
    contrib = torch.where(hit, val.reshape(*lead, -1).float(), 0.0)
    out = torch.zeros((*idx.shape[:-1], S), dtype=torch.float32, device=idx.device)
    return out.scatter_add_(
        -1, in_range.reshape(idx.shape), contrib.reshape(idx.shape)
    )


def gather_tiles(
    bdims: torch.Tensor,
    idxb: torch.Tensor,
    valb: torch.Tensor,
    ij: torch.Tensor,
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """``yg (T, bm, S)``: for worklist entry ``t``, the CSR rows of block
    ``ij[1, t]`` gathered onto the support ``bdims[ij[0, t]]``, ``chunk``
    entries at a time (the search intermediates stay per chunk)."""
    ij = ij.to(idxb.device, torch.long)
    T = ij.shape[1]
    nb, bm, _ = idxb.shape
    yg = torch.empty((T, bm, bdims.shape[1]), dtype=torch.float32, device=idxb.device)
    for a in range(0, T, chunk):
        i, j = ij[0, a:a + chunk], ij[1, a:a + chunk]
        yg[a:a + chunk] = _gather_block(bdims[i], idxb[j], valb[j])
    return yg


# ---------------------------------------------------------------------------
# K3: plain version and kernel wrapper
# ---------------------------------------------------------------------------


def sparse_tile_candidates_plain(
    bx: torch.Tensor,
    yg: torch.Tensor,
    ij: torch.Tensor,
    threshold: float,
    k: int,
    *,
    n_valid: int,
    chunk_bytes: int = 1 << 30,
):
    """K3's function in plain PyTorch, in chunks of worklist entries whose
    operands stay under ``chunk_bytes``.

    Returns ``(fv, fi, fc, bv, bi, bc)``, each ``(T, bm, k|k|1)``.
    """
    _, bm, S = bx.shape
    T = ij.shape[1]
    ij = ij.to(bx.device, torch.long)
    step = max(1, chunk_bytes // (8 * bm * S))
    outs = []
    for a in range(0, T, step):
        ib, jb = ij[0, a:a + step], ij[1, a:a + step]
        s = dot_f32(bx[ib], yg[a:a + step])
        outs.append(_tile_packets(
            s, ib, jb, threshold=threshold, k=k, block_m=bm, block_n=bm,
            n_valid=n_valid,
        ))
    return tuple(torch.cat(parts) for parts in zip(*outs))


K3_ITEM = TILE_ITEM  # K3's work items are K2's (csrc/tile_items.cuh)


def sparse_work_items(n_tiles: int, block_m: int) -> np.ndarray:
    """K3's scoring work items, one thread block each, in launch order:
    K2's :func:`~repro_torch.kernels.apss_block.fused.tile_work_items` of
    square ``block_m`` tiles (4 a tile at 256, 1 at 128 or 64)."""
    return tile_work_items(n_tiles, block_m, block_m)


def _check_blocks(name: str, a: torch.Tensor) -> None:
    if a.dim() != 3 or not a.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 3-D (blocks, rows, support) tensor")
    _check_operand(name, a.view(-1, a.shape[2]))


def sparse_tile_candidates_kernel(
    bx: torch.Tensor,
    yg: torch.Tensor,
    ij: torch.Tensor,
    threshold: float,
    k: int,
    *,
    n_valid: int,
):
    """K3 on support-compacted operands: ``bx (nb, bm, S)`` row blocks on
    their own supports, ``yg (T, bm, S)`` the gathered column block of each
    worklist entry, ``ij (2, T)`` the live upper-triangular tiles.

    Returns forward and mirror packets, each ``(T, bm, k)×2 + (T, bm, 1)``.
    """
    if bx.device.type == "cpu":
        return sparse_tile_candidates_plain(bx, yg, ij, threshold, k, n_valid=n_valid)
    _check_blocks("bx", bx)
    _check_blocks("yg", yg)
    nb, bm, S = bx.shape
    if yg.device != bx.device or yg.dtype != bx.dtype:
        raise ValueError("bx and yg must share device and dtype")
    if bm % _TILE or bm > 256 or S % _TK:
        raise ValueError(
            f"block rows must be a multiple of {_TILE} up to 256 and the support "
            f"a multiple of {_TK}; got {bm}, {S}"
        )
    ij = ij.to(bx.device, torch.int32).contiguous()
    if ij.dim() != 2 or ij.shape[0] != 2 or ij.shape[1] < 1:
        raise ValueError(f"ij must be a non-empty (2, T) worklist: {tuple(ij.shape)}")
    T = ij.shape[1]
    if tuple(yg.shape) != (T, bm, S):
        raise ValueError(f"yg shape {tuple(yg.shape)} is not {(T, bm, S)}")
    lo, hi = torch.stack([ij.min(), ij.max()]).tolist()
    if lo < 0 or hi >= nb:
        raise ValueError("ij holds a block index outside the corpus")
    dev = bx.device
    scratch = torch.empty((T, bm, bm), dtype=torch.float32, device=dev)
    fv = torch.empty((T, bm, k), dtype=torch.float32, device=dev)
    fi = torch.empty((T, bm, k), dtype=torch.int32, device=dev)
    fc = torch.empty((T, bm, 1), dtype=torch.int32, device=dev)
    bv = torch.empty((T, bm, k), dtype=torch.float32, device=dev)
    bi = torch.empty((T, bm, k), dtype=torch.int32, device=dev)
    bc = torch.empty((T, bm, 1), dtype=torch.int32, device=dev)
    fn, check = _entry(
        "sparse_tile_candidates", f"apss_sparse_tile_candidates_{_suffix(bx.dtype)}",
        [_VP, _VP, _VP, _I] + [_VP] * 7 + [_I] * 3 + [_F, _I, _VP],
    )
    status = fn(
        bx.data_ptr(), yg.data_ptr(), ij.data_ptr(), T, scratch.data_ptr(),
        fv.data_ptr(), fi.data_ptr(), fc.data_ptr(),
        bv.data_ptr(), bi.data_ptr(), bc.data_ptr(),
        S, bm, int(n_valid), _f32(threshold), k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status)
    LAUNCHES["sparse_tile_candidates"] += 1
    if op_analysis.CENSUS is not None:
        op_analysis.report_kernel(
            "sparse_tile_candidates", "sparse_tile_candidates", 2.0 * T * bm * bm * S,
            2 * T * bm * S * bx.element_size() + 8 * T * bm * bm
            + packet_bytes(2 * T * bm, k) + 8 * T)
    return fv, fi, fc, bv, bi, bc


# ---------------------------------------------------------------------------
# K6: the serving query gather, plain version and kernel wrapper
# ---------------------------------------------------------------------------


def gather_query_tiles(
    Qp: torch.Tensor, bdims: torch.Tensor, ij: torch.Tensor, block_q: int
) -> torch.Tensor:
    """``qg (T, block_q, S)`` f32: for worklist entry ``t``, the rows of query
    block ``ij[0, t]`` at the support ``bdims[ij[1, t]]``.

    ``Qp (grid_q · block_q, m)`` is dense; a zero column is appended so the
    support's sentinel ``m`` gathers 0.
    """
    ij = ij.to(Qp.device, torch.long)
    qext = torch.nn.functional.pad(Qp.float(), (0, 1))
    rows = ij[0][:, None, None] * block_q + torch.arange(block_q, device=Qp.device)[:, None]
    return qext[rows, bdims.to(Qp.device, torch.long)[ij[1]][:, None, :]]


def rect_sparse_tile_candidates_plain(
    qg: torch.Tensor,
    bx: torch.Tensor,
    ij: torch.Tensor,
    threshold: float,
    k: int,
    *,
    nc_valid: int,
):
    """K6's function in plain PyTorch: one product per tile (as
    ``fused.rect_tile_candidates_plain``), the selection ``_RECT_CHUNK``
    tiles at a time. Returns ``(fv, fi, fc)`` shaped ``(T, block_q,
    k|k|1)``."""
    T, block_q, _ = qg.shape
    block_c = bx.shape[1]
    ij = ij.to(bx.device, torch.long)
    cjs = ij[1].cpu().tolist()
    outs = []
    for a in range(0, T, _RECT_CHUNK):
        s = torch.stack([
            dot_f32(qg[a + i], bx[cj]) for i, cj in enumerate(cjs[a:a + _RECT_CHUNK])
        ])
        outs.append(_rect_tile_packets(
            s, ij[1, a:a + _RECT_CHUNK], threshold=threshold, k=k, block_q=block_q,
            block_c=block_c, nc_valid=nc_valid,
        ))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def rect_sparse_tile_candidates_kernel(
    qg: torch.Tensor,
    bx: torch.Tensor,
    ij: torch.Tensor,
    threshold: float,
    k: int,
    *,
    nc_valid: int,
):
    """K6 on ``qg (T, block_q, S)`` (:func:`gather_query_tiles`), the index's
    ``bx (nb, block_c, S)`` corpus blocks on their own supports and a
    ``(2, T)`` worklist of live (query block, corpus block) tiles. The work
    goes in K4's items (:func:`fused.rect_work_split` with ``m = S``), in
    passes that keep the scratch within ``RECT_SCRATCH_BYTES``.

    Returns ``(fv, fi, fc)`` shaped ``(T, block_q, k|k|1)``.
    """
    if bx.device.type == "cpu":
        return rect_sparse_tile_candidates_plain(qg, bx, ij, threshold, k, nc_valid=nc_valid)
    _check_blocks("qg", qg)
    _check_blocks("bx", bx)
    T, block_q, S = qg.shape
    nb, block_c, S2 = bx.shape
    if qg.device != bx.device or qg.dtype != bx.dtype or S2 != S:
        raise ValueError("qg and bx must share device, dtype and support width")
    _check_rect_blocks(block_q, block_c, S)
    ij = _worklist_on(ij, bx.device, (2,), (None, nb))
    if ij.shape[1] != T:
        raise ValueError(f"qg holds {T} tiles but ij {ij.shape[1]}")
    dev = bx.device
    split = rect_work_split(T, S, block_q, block_c, RECT_SCRATCH_BYTES)
    part = torch.empty(split.scratch_bytes // 4, dtype=torch.float32, device=dev)
    fv = torch.empty((T, block_q, k), dtype=torch.float32, device=dev)
    fi = torch.empty((T, block_q, k), dtype=torch.int32, device=dev)
    fc = torch.empty((T, block_q, 1), dtype=torch.int32, device=dev)
    fn, check = _entry(
        "rect_sparse_tile_candidates",
        f"apss_rect_sparse_tile_candidates_{_suffix(bx.dtype)}",
        [_VP, _VP, _VP, _I, _VP, _I] + [_VP] * 3 + [_I] * 4 + [_F, _I, _VP],
    )
    status = fn(
        qg.data_ptr(), bx.data_ptr(), ij.data_ptr(), T, part.data_ptr(), split.pass_tiles,
        fv.data_ptr(), fi.data_ptr(), fc.data_ptr(),
        S, block_q, block_c, int(nc_valid), _f32(threshold), k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status)
    LAUNCHES["rect_sparse_tile_candidates"] += 1
    if op_analysis.CENSUS is not None:
        op_analysis.report_kernel(
            "rect_sparse_tile_candidates", "rect_sparse_tile_candidates",
            2.0 * T * block_q * block_c * S,
            T * (block_q + block_c) * S * bx.element_size()
            + 8 * T * split.n_chunks * block_q * block_c + packet_bytes(T * block_q, k)
            + 8 * T)
    return fv, fi, fc


# ---------------------------------------------------------------------------
# The sparse worklist self-join
# ---------------------------------------------------------------------------


def apss_sparse_compacted(
    sp: SparseCorpus,
    threshold: float,
    k: int,
    *,
    block_m: int = 256,
    block_mask=None,
    block_ub=None,
    use_minsize: bool = True,
    lane_pad: int = 128,
    device: str | torch.device = "cuda",
) -> Matches:
    """Sparse self-join via the inverted-index worklist and K3.

    The sparse twin of ``ops.apss_fused_compacted``: the live mask comes
    from CSR-only bounds, the worklist is compacted on the host
    (upper-triangular, S = Sᵀ mirrors, ordered by upper bound), and each
    live tile costs ``O(bm² · S)`` instead of ``O(bm² · m)``.
    ``block_mask`` (``(nb, nb)`` LIVE bools over the row-padded corpus)
    skips the internal bound computation when the caller has it; it must be
    conservative or exactness is lost. ``block_ub`` optionally carries the
    matching tile upper bounds for the worklist order.

    Under a tracer each stage runs in a ``kernels/apss_sparse/<stage>``
    span: ``mask`` (when the mask is computed here), ``worklist``,
    ``support_gather`` (on the host), ``gather``, ``score`` (K3) and
    ``fold``.
    """
    sp = sp.to(device)
    dev = sp.device
    n = sp.n
    spp, _ = pad_rows_sparse(sp, block_m)
    grid_m = spp.n // block_m

    if block_mask is not None:
        mask, ub = block_mask, block_ub
    else:
        with trace.span("kernels/apss_sparse/mask"):
            mask, ub = sparse_block_prune_mask(
                spp, spp, threshold, block_m, use_minsize=use_minsize, return_ub=True,
            )
    with trace.span("kernels/apss_sparse/worklist"):
        wl = compact_worklist(mask, ub)
        if wl is None:
            return empty_matches(n, k, dev)
        ij = torch.as_tensor(wl).to(dev)

    with trace.span("kernels/apss_sparse/support_gather"):
        bdims, bx = block_support_gather(spp, block_m, pad_to=lane_pad)
    with trace.span("kernels/apss_sparse/gather"):
        idxb = spp.indices.reshape(grid_m, block_m, spp.cap)
        valb = spp.values.reshape(grid_m, block_m, spp.cap)
        yg = gather_tiles(torch.from_numpy(bdims).to(dev), idxb, valb, ij)
        bx = torch.from_numpy(bx).to(dev)
    with trace.span("kernels/apss_sparse/score"):
        fv, fi, fc, bv, bi, bc = sparse_tile_candidates_kernel(
            bx, yg, ij, threshold, k, n_valid=n,
        )
    del yg  # the largest buffer of the path; the fold does not need it
    with trace.span("kernels/apss_sparse/fold"):
        values, indices, counts = fold_packets(
            ij, fv, fi, fc[..., 0], bv, bi, bc[..., 0],
            grid_m=grid_m, block_m=block_m, k=k,
        )
    return Matches(values=values[:n], indices=indices[:n], counts=counts[:n])
