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
CPU runs the plain versions of the kernels). ``similarity_topk(...,
variant="auto")`` hands the self-join to the execution planner
(``planner.plan_apss``). With a telemetry log active
(``planner.telemetry.CommLog``) each ``apss_blocked`` call records one
``ApssStats``.
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
from repro_torch.obs import trace
from repro_torch.planner import telemetry


def _mask_counts(mask):
    """Host-side live-tile accounting from a mask: (live, total, per-row
    counts), or Nones without a mask. Read only when telemetry is on."""
    if mask is None:
        return None, None, None
    mk = mask.cpu().numpy()
    return int(mk.sum()), int(mk.size), tuple(int(x) for x in mk.sum(axis=1))


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
    mesh=None,
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

    ``variant="auto"`` hands the whole self-join to the execution planner
    (``planner.plan_apss``): ``Q`` must be ``C`` (the same object) with
    ``exclude_self=True``, and ``mesh`` (optional; then every rank calls)
    opens the distributed variants to the candidate set. The plan runs on
    ``device``; every other argument is chosen by the planner from sampled
    corpus statistics and the calibrated cost models.
    """
    if variant not in (None, "auto"):
        raise ValueError(f"unknown variant: {variant!r} (only 'auto')")
    if variant == "auto":
        if Q is not C:
            raise ValueError(
                "variant='auto' plans the APSS self-join: pass the same "
                "object as Q and C (rectangular retrieval is served by "
                "serving.query_topk against a prebuilt index)"
            )
        if not exclude_self:
            raise ValueError(
                "variant='auto' dispatches to self-join variants, which "
                "exclude self-pairs; pass exclude_self=True"
            )
        from repro_torch.planner.plan import plan_apss

        return plan_apss(Q, threshold, k, mesh, device=device).run()
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

    Records ``blocked/dense-kernel`` or ``blocked/dense-xla`` (the plain
    path, under the reference's name), ``blocked/sparse-kernel`` or
    ``blocked/sparse-xla`` when telemetry is on; live tiles where a mask
    was computed (``with_prune_stats``, or the sparse kernel's worklist).
    K1 on the card adds the stages it walked and those of the walk over
    every chunk (``extra``: ``k1_stages_walked``, ``k1_stages_dense``; read
    from the card, so the record waits for K1) and scales ``flops`` by their
    ratio.

    Runs in a ``core/apss_blocked`` span. K1's path opens two children,
    ``core/apss_blocked/prepare`` (the padded copy and the bound mask) and
    ``core/apss_blocked/score`` (K1 and its tail); the sparse path computes
    its mask in ``core/apss_blocked/mask``, and the sparse kernel's stages
    open ``kernels/apss_sparse/<stage>`` spans.
    """
    join = _apss_blocked_sparse if isinstance(D, SparseCorpus) else _apss_blocked_dense
    with trace.span("core/apss_blocked"):
        m, mask, record = join(D, threshold, k, block_rows=block_rows,
                               with_prune_stats=with_prune_stats, use_kernel=use_kernel,
                               device=device)
    if record is not None:  # pinned to the caller's span (a plan's ``execute``)
        telemetry.record(record)
    if not with_prune_stats:
        return m
    return m, prune_stats(mask)


def _apss_blocked_dense(D, threshold, k, *, block_rows, with_prune_stats, use_kernel,
                        device):
    """``(Matches, mask or None, ApssStats or None)`` of the dense join."""
    D = as_corpus(D, device)
    if use_kernel:
        from repro_torch.kernels.apss_block.fused import last_walk
        from repro_torch.kernels.apss_block.ops import _padded_pair, _pick_bk, apss_fused_padded

        bm = _kernel_tile(block_rows)
        with trace.span("core/apss_blocked/prepare"):
            pair = _padded_pair(D, D, threshold, None, True, bm, bm,
                                _pick_bk(D.shape[1], 512), D.device)
        with trace.span("core/apss_blocked/score"):
            m = apss_fused_padded(*pair, threshold, k, block_m=bm, block_n=bm,
                                  exclude_self=True)
    else:
        m = similarity_topk(
            D, D, threshold, k, block_rows=block_rows, exclude_self=True,
            device=D.device,
        )
    mask = record = None
    if with_prune_stats:
        Dp, _ = pad_rows(D, block_rows)
        mask = block_prune_mask(Dp, Dp, threshold, block_rows)
    if telemetry.enabled():
        n, mdim = D.shape
        live, total, counts = _mask_counts(mask)
        flops = telemetry.dense_join_flops(n, n, mdim)
        if use_kernel and live is not None and total:
            flops *= live / total  # K1 skips dead tiles
        extra = {}
        walk = last_walk() if use_kernel else None
        if walk is not None:  # K1 ran on the card: it skips chunks one tile holds no nonzero in
            extra = {"k1_stages_walked": walk[0], "k1_stages_dense": walk[1]}
            if walk[1]:
                flops *= walk[0] / walk[1]
        record = telemetry.ApssStats(
            variant="blocked/dense-kernel" if use_kernel else "blocked/dense-xla",
            n=n, m=mdim, block_rows=block_rows, sparse=False, flops=flops,
            live_tiles=live, total_tiles=total, tile_counts=counts, extra=extra,
        )
    return m, mask, record


def _apss_blocked_sparse(D: SparseCorpus, threshold: float, k: int, *, block_rows: int,
                         with_prune_stats: bool, use_kernel: bool, device):
    """``(Matches, mask or None, ApssStats or None)`` of the sparse join."""
    D = D.to(device)
    mask = ub = record = None
    bs = _kernel_tile(block_rows) if use_kernel else block_rows
    if with_prune_stats or use_kernel:
        # The block stats are computed once and shared by the worklist and
        # the accounting.
        with trace.span("core/apss_blocked/mask"):
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
    if telemetry.enabled():
        live, total, counts = _mask_counts(mask)
        flops = telemetry.sparse_join_flops(D.n, D.n, D.cap)
        if use_kernel and live is not None and total:
            flops *= live / total  # worklist compaction skips dead tiles
        record = telemetry.ApssStats(
            variant="blocked/sparse-kernel" if use_kernel else "blocked/sparse-xla",
            n=D.n, m=D.m, block_rows=bs, sparse=True, flops=flops,
            live_tiles=live, total_tiles=total, tile_counts=counts,
            extra={"cap": D.cap},
        )
    return m, mask, record
