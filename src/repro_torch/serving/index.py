"""APSSIndex: every corpus-side support structure of serving, built once.

A server answers a stream of query batches against a fixed corpus, so the
structures the self-join rebuilds on every call are built here once:

- the row-normalized, block-padded corpus: a dense tensor, lane-padded to
  the feature tile the rectangular kernel reads, or the padded-CSR triple
  of a :class:`~repro_torch.core.sparse.SparseCorpus`;
- :class:`~repro_torch.core.pruning.BlockStats`: per-block per-dimension
  maxweight vectors (their support is the tile-granular inverted index),
  per-block max weight and exact per-block max nnz for the minsize bound;
- for sparse corpora, the per-block support compaction ``bdims (nb, S)`` /
  ``bx (nb, block_rows, S)`` that the CSR tile kernel K6 reads.

:func:`~repro_torch.serving.query.query_topk` evaluates the bounds on the
query side only and scores the live tiles straight away. Single device:
the mesh-sharded index is ROADMAP queue 1 item 4, the planner's ``plan=``
item 5.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.apss import normalize_rows, pad_rows
from repro_torch.core.pruning import BlockStats, dense_block_stats, sparse_block_stats
from repro_torch.core.sparse import SparseCorpus, normalize_sparse, pad_rows_sparse
from repro_torch.interop import as_corpus
from repro_torch.kernels.apss_block.ops import _pad_to, _pick_bk
from repro_torch.kernels.apss_block.sparse import block_support_gather


class APSSIndex:
    """Build-once retrieval index over a fixed corpus (see module doc).

    ``corpus`` is ``(n_padded, width)`` dense or the ``(indices, values,
    nnz)`` CSR triple; ``n`` counts the real rows, ``m`` the dimensions,
    ``kind`` is ``"dense"`` or ``"sparse"`` and ``normalized`` records
    whether rows are unit-norm (it gates the minsize bound).
    """

    def __init__(
        self,
        corpus,
        stats: BlockStats,
        bdims: torch.Tensor | None,
        bx: torch.Tensor | None,
        *,
        n: int,
        m: int,
        block_rows: int,
        kind: str,
        normalized: bool,
    ):
        self.corpus = corpus
        self.stats = stats
        self.bdims = bdims
        self.bx = bx
        self.n = int(n)
        self.m = int(m)
        self.block_rows = int(block_rows)
        self.kind = kind
        self.normalized = bool(normalized)
        self._stats_host = None

    @property
    def is_sparse(self) -> bool:
        return self.kind == "sparse"

    @property
    def device(self) -> torch.device:
        return self.stats.mw.device

    @property
    def n_padded(self) -> int:
        return (self.corpus[0] if self.is_sparse else self.corpus).shape[0]

    @property
    def n_blocks(self) -> int:
        return self.n_padded // self.block_rows

    def stats_host(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of the per-block ``(mw, max_nnz)`` vectors, cached."""
        if self._stats_host is None:
            self._stats_host = (
                self.stats.mw.cpu().numpy(), self.stats.max_nnz.cpu().numpy()
            )
        return self._stats_host

    def sparse_corpus(self) -> SparseCorpus:
        """The padded corpus as a :class:`SparseCorpus` view (sparse kind)."""
        if not self.is_sparse:
            raise ValueError("a dense index has no CSR triple")
        return SparseCorpus(*self.corpus, self.m)

    def __repr__(self) -> str:
        return (
            f"APSSIndex(kind={self.kind}, n={self.n}, m={self.m}, "
            f"block_rows={self.block_rows}, device={self.device})"
        )


def build_index(
    corpus,
    *,
    block_rows: int = 256,
    normalize: bool = True,
    assume_normalized: bool = True,
    lane_pad: int = 128,
    device: str | torch.device = "cuda",
) -> APSSIndex:
    """Build every corpus-side structure once, on ``device``.

    ``corpus`` is a dense ``(n, m)`` array or tensor, or a
    :class:`SparseCorpus`. Rows are L2-normalized (``normalize``) and padded
    to ``block_rows``. ``normalize=False`` serves rows as given;
    ``assume_normalized`` then records whether they are unit-norm, which
    the minsize bound needs (``False``: weaker pruning, still exact).
    A dense corpus is lane-padded once to the feature tile the query path
    reads (``_pick_bk(m, 512)``); the sparse build compacts each block onto
    its support, padded to ``lane_pad``.
    """
    normalized = True if normalize else assume_normalized
    if isinstance(corpus, SparseCorpus):
        sp = corpus.to(device)
        if normalize:
            sp = normalize_sparse(sp)
        spp, _ = pad_rows_sparse(sp, block_rows)
        stats = sparse_block_stats(spp, block_rows)
        bdims, bx = block_support_gather(spp, block_rows, pad_to=lane_pad)
        return APSSIndex(
            (spp.indices, spp.values, spp.nnz), stats,
            torch.from_numpy(bdims).to(spp.device), torch.from_numpy(bx).to(spp.device),
            n=sp.n, m=sp.m, block_rows=block_rows, kind="sparse", normalized=normalized,
        )
    C = as_corpus(corpus, device)
    n, m = C.shape
    if normalize:
        C = normalize_rows(C)
    Cp = _pad_to(pad_rows(C, block_rows)[0], 1, _pick_bk(m, 512))
    return APSSIndex(
        Cp.contiguous(), dense_block_stats(Cp, block_rows), None, None,
        n=n, m=m, block_rows=block_rows, kind="dense", normalized=normalized,
    )


def index_nbytes(index: APSSIndex) -> int:
    """Total bytes of the index's tensors (benchmark accounting)."""
    corpus = list(index.corpus) if index.is_sparse else [index.corpus]
    extra = [x for x in (index.bdims, index.bx) if x is not None]
    return int(sum(x.numel() * x.element_size() for x in corpus + list(index.stats) + extra))

