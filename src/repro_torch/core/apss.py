"""Single-device APSS: the reference oracle and the blocked production path.

``apss_reference`` is the plain oracle: a dense ``S = D·Dᵀ`` filtered at
threshold ``t`` (the paper's all-pairs-0-array). ``apss_blocked`` is the
tiled self-join: row blocks against the full corpus, either by plain
products (``use_kernel=False``) or through the fused streaming kernel K1
(``use_kernel=True``), which never materializes the score matrix and skips
tiles the maxweight bound proves dead.

A :class:`~repro_torch.core.sparse.SparseCorpus` takes the sparse path:
the inverted-index worklist and the CSR tile kernel K3
(``use_kernel=True``) or the blocked gather-dot join (``use_kernel=False``).

Entry points take numpy arrays, tensors or a ``SparseCorpus`` and
``device=`` (default ``"cuda"``, which raises when there is no card; the
CPU runs the plain versions of the kernels). The planner's
``variant="auto"`` is ROADMAP queue 1 item 5.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.matches import Matches, extract_matches
from repro_torch.core.precision import dot_f32
from repro_torch.core.pruning import (
    PruneStats,
    block_prune_mask,
    live_tile_mask,
    prune_stats,
    sparse_block_stats,
)
from repro_torch.core.sparse import (
    SparseCorpus,
    pad_rows_sparse,
    sparse_similarity_topk,
)
from repro_torch.interop import as_corpus


def normalize_rows(D: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize rows (the paper assumes ``||x|| = 1``)."""
    D = torch.as_tensor(D)
    nrm = torch.linalg.norm(D.float(), dim=-1, keepdim=True)
    return (D / nrm.clamp_min(eps)).to(D.dtype)


def pad_rows(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Zero-pad axis 0 to a multiple; returns (padded, original_len)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])
    return x, n


def apss_reference(
    D,
    threshold: float,
    k: int = 32,
    *,
    exclude_self: bool = True,
    device: str | torch.device = "cuda",
) -> Matches:
    """Oracle APSS self-join: dense ``D·Dᵀ``, threshold, per-row top-k.

    O(n²m) FLOPs, O(n²) memory: for validation-scale inputs only. Dense
    corpora only: pass ``core.sparse.to_dense(sp)`` for a sparse one.
    """
    if not isinstance(D, (np.ndarray, torch.Tensor)):
        raise TypeError(
            f"apss_reference takes a dense corpus (numpy array or tensor), "
            f"got {type(D).__name__}"
        )
    D = as_corpus(D, device)
    return extract_matches(dot_f32(D, D), threshold, k, exclude_self=exclude_self)


def similarity_topk(
    Q,
    C,
    threshold: float,
    k: int = 32,
    *,
    block_rows: int = 512,
    exclude_self: bool = False,
    row_offset: int = 0,
    col_offset: int = 0,
    col_valid: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
    variant: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> Matches:
    """Blocked similarity join of queries ``Q (nq, m)`` vs corpus ``C (nc, m)``.

    Streams ``block_rows`` queries at a time, so peak memory is
    ``O(block_rows · nc)``. ``use_kernel=True`` routes the whole join
    through K1 (``kernels.apss_block.apss_fused``), with the maxweight
    bound mask gating tiles and runtime offsets; ``col_valid`` is not
    supported there (the kernel derives contiguous-prefix validity from the
    corpus length).

    Two ``SparseCorpus`` inputs take ``core.sparse.sparse_similarity_topk``
    (no ``use_kernel``, no ``col_valid``: the sparse kernel path is the
    self-join ``apss_blocked``).
    """
    if variant == "auto":
        raise NotImplementedError(
            "variant='auto' needs the execution planner: ROADMAP queue 1 item 5"
        )
    if variant is not None:
        raise ValueError(f"unknown variant: {variant!r} (only 'auto')")
    if isinstance(Q, SparseCorpus) != isinstance(C, SparseCorpus):
        raise ValueError(
            "Q and C must use the same representation "
            "(both SparseCorpus or both dense)"
        )
    if isinstance(Q, SparseCorpus):
        if use_kernel:
            raise ValueError(
                "sparse use_kernel is self-join only: call apss_blocked on a "
                "SparseCorpus (kernels.apss_block.sparse.apss_sparse_compacted)"
            )
        if col_valid is not None:
            raise ValueError("sparse similarity_topk derives col validity "
                             "from the unpadded corpus length")
        same = C is Q
        Q = Q.to(device)
        return sparse_similarity_topk(
            Q, Q if same else C.to(device), threshold, k, block_rows=block_rows,
            exclude_self=exclude_self, row_offset=row_offset, col_offset=col_offset,
        )
    same = C is Q
    Q = as_corpus(Q, device)
    C = Q if same else as_corpus(C, device)
    if use_kernel:
        if col_valid is not None:
            raise ValueError("use_kernel=True does not support col_valid")
        from repro_torch.kernels.apss_block.ops import apss_fused

        bm = _kernel_tile(block_rows)
        return apss_fused(
            Q, C, threshold, k, block_m=bm, block_n=bm,
            row_offset=int(row_offset), col_offset=int(col_offset),
            exclude_self=exclude_self, device=Q.device,
        )
    if col_valid is not None:
        col_valid = torch.as_tensor(col_valid).to(Q.device)
    parts = [
        extract_matches(
            dot_f32(Q[b:b + block_rows], C), threshold, k,
            row_offset=int(row_offset) + b, col_offset=int(col_offset),
            exclude_self=exclude_self, col_valid=col_valid,
        )
        for b in range(0, Q.shape[0], block_rows)
    ]
    return Matches(*(torch.cat(f) for f in zip(*parts)))


def _kernel_tile(block_rows: int) -> int:
    """Clamp the user's row-block knob to a kernel tile of 128..256 rows."""
    return min(max(128, block_rows), 256)


def apss_blocked(
    D,
    threshold: float,
    k: int = 32,
    *,
    block_rows: int = 512,
    with_prune_stats: bool = False,
    use_kernel: bool = False,
    device: str | torch.device = "cuda",
) -> Matches | tuple[Matches, PruneStats]:
    """Blocked APSS self-join with optional block-prune accounting.

    ``use_kernel=True`` runs the self-join through the fused streaming
    kernel K1: matmul → threshold → top-k merge → count in one kernel, tile
    skipping from the maxweight bound mask, and an ``O(n·k)`` output. The
    plain path computes every tile. Exactness does not depend on the mask.

    ``D`` may be a :class:`~repro_torch.core.sparse.SparseCorpus`: the
    self-join then takes the sparse path, the inverted-index worklist and
    K3 (``use_kernel=True``) or the blocked gather-dot join
    (``use_kernel=False``). Both are exact on the densified corpus.
    """
    if isinstance(D, SparseCorpus):
        return _apss_blocked_sparse(
            D.to(device), threshold, k, block_rows=block_rows,
            with_prune_stats=with_prune_stats, use_kernel=use_kernel,
        )
    D = as_corpus(D, device)
    if use_kernel:
        from repro_torch.kernels.apss_block.ops import apss_fused

        bm = _kernel_tile(block_rows)
        m = apss_fused(
            D, D, threshold, k, block_m=bm, block_n=bm, exclude_self=True,
            device=D.device,
        )
    else:
        m = similarity_topk(
            D, D, threshold, k, block_rows=block_rows, exclude_self=True,
            device=D.device,
        )
    if not with_prune_stats:
        return m
    Dp, _ = pad_rows(D, block_rows)
    return m, prune_stats(block_prune_mask(Dp, Dp, threshold, block_rows))


def _apss_blocked_sparse(
    D: SparseCorpus,
    threshold: float,
    k: int,
    *,
    block_rows: int,
    with_prune_stats: bool,
    use_kernel: bool,
) -> Matches | tuple[Matches, PruneStats]:
    mask = ub = None
    bs = _kernel_tile(block_rows) if use_kernel else block_rows
    if with_prune_stats or use_kernel:
        # The block stats are computed once and shared by the worklist and
        # the accounting.
        Dp, _ = pad_rows_sparse(D, bs)
        stats = sparse_block_stats(Dp, bs)
        mask, ub = live_tile_mask(stats, stats, threshold, return_ub=True)
    if use_kernel:
        from repro_torch.kernels.apss_block.sparse import apss_sparse_compacted

        m = apss_sparse_compacted(
            D, threshold, k, block_m=bs, block_mask=mask, block_ub=ub,
            device=D.device,
        )
    else:
        m = sparse_similarity_topk(
            D, D, threshold, k, block_rows=block_rows, exclude_self=True
        )
    if not with_prune_stats:
        return m
    return m, prune_stats(mask)
