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
query side only and scores the live tiles straight away.

With ``devices=`` (p of them) the corpus is split into p row-block shards,
shard ``s`` on ``devices[s]`` holding the contiguous global blocks
:meth:`APSSIndex.shard_block_range`; rows are padded to a multiple of
``p · block_rows``, so the last shard carries the padding rows. The block
stats cover the whole padded corpus once and stay on the home device,
``devices[0]``, where queries arrive and results are returned: the query
path evaluates the global bounds there and hands each shard its own
worklist. A sparse shard holds its slice of the CSR triple and no support
compaction (the sharded path scores it by gather-dot, as the reference's
does). PyTorch has no single-process counterpart of a sharded array, so
the shards are per-device tensors; several shards may share one device.
The planner's ``plan=`` is ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.apss import normalize_rows
from repro_torch.core.pruning import BlockStats, dense_block_stats, sparse_block_stats
from repro_torch.core.sparse import SparseCorpus, normalize_sparse, pad_rows_sparse
from repro_torch.interop import as_corpus, device_of
from repro_torch.kernels.apss_block.ops import _pick_bk
from repro_torch.kernels.apss_block.sparse import block_support_gather


class APSSIndex:
    """Build-once retrieval index over a fixed corpus (see module doc).

    ``corpus`` is ``(n_padded, width)`` dense or the ``(indices, values,
    nnz)`` CSR triple; a sharded index passes ``shards`` instead, one such
    corpus per row-block shard, each on its own device, and keeps no whole
    corpus. ``n`` counts the real rows, ``m`` the dimensions, ``kind`` is
    ``"dense"`` or ``"sparse"`` and ``normalized`` records whether rows are
    unit-norm (it gates the minsize bound).
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
        shards=None,
    ):
        self.shards = (corpus,) if shards is None else tuple(shards)
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
    def corpus(self):
        """The whole padded corpus; a sharded index keeps only its ``shards``."""
        if self.n_shards > 1:
            raise ValueError("a sharded index keeps its corpus in shards, not whole")
        return self.shards[0]

    @property
    def device(self) -> torch.device:
        """The home device: block stats, queries and results live here."""
        return self.stats.mw.device

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_device(self, s: int) -> torch.device:
        shard = self.shards[s]
        return (shard[0] if self.is_sparse else shard).device

    @property
    def n_padded(self) -> int:
        return sum((x[0] if self.is_sparse else x).shape[0] for x in self.shards)

    @property
    def n_blocks(self) -> int:
        return self.n_padded // self.block_rows

    @property
    def nb_local(self) -> int:
        """Corpus blocks of each shard (``n_blocks`` unsharded): rows are
        padded to a multiple of ``n_shards · block_rows``, so it divides."""
        return self.n_blocks // self.n_shards

    def shard_block_range(self, s: int) -> tuple[int, int]:
        """Global ``[lo, hi)`` corpus-block ids owned by shard ``s``."""
        lo = s * self.nb_local
        return lo, lo + self.nb_local

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
        shards = f", shards={self.n_shards}" if self.n_shards > 1 else ""
        return (
            f"APSSIndex(kind={self.kind}, n={self.n}, m={self.m}, "
            f"block_rows={self.block_rows}{shards}, device={self.device})"
        )


def build_index(
    corpus,
    *,
    block_rows: int = 256,
    normalize: bool = True,
    assume_normalized: bool = True,
    lane_pad: int = 128,
    device: str | torch.device | None = None,
    devices=None,
) -> APSSIndex:
    """Build every corpus-side structure once, on ``device`` (default
    ``"cuda"``), or split into row-block shards over ``devices``.

    ``corpus`` is a dense ``(n, m)`` array or tensor, or a
    :class:`SparseCorpus`. Rows are L2-normalized (``normalize``) and padded
    to ``block_rows``. ``normalize=False`` serves rows as given;
    ``assume_normalized`` then records whether they are unit-norm, which
    the minsize bound needs (``False``: weaker pruning, still exact).
    A dense corpus is lane-padded once to the feature tile the query path
    reads (``_pick_bk(m, 512)``); the sparse build compacts each block onto
    its support, padded to ``lane_pad``.

    ``devices`` (a sequence of p devices, one per shard; see the module
    doc) pads rows to ``p · block_rows`` and places shard ``s`` on
    ``devices[s]``; ``devices[0]`` is the home device, and ``device``, if
    given too, must name it. One device builds the unsharded index.
    """
    home, devices = _placement(device, devices)
    normalized = True if normalize else assume_normalized
    p = len(devices)
    if isinstance(corpus, SparseCorpus):
        sp = corpus.to(home)
        if normalize:
            sp = normalize_sparse(sp)
        spp, _ = pad_rows_sparse(sp, p * block_rows)
        stats = sparse_block_stats(spp, block_rows)
        triple = (spp.indices, spp.values, spp.nnz)
        meta = dict(n=sp.n, m=sp.m, block_rows=block_rows, kind="sparse",
                    normalized=normalized)
        if p == 1:
            bdims, bx = block_support_gather(spp, block_rows, pad_to=lane_pad)
            return APSSIndex(triple, stats, torch.from_numpy(bdims).to(home),
                             torch.from_numpy(bx).to(home), **meta)
        rows = spp.n // p
        shards = [tuple(x[s * rows:(s + 1) * rows].to(dev, copy=True) for x in triple)
                  for s, dev in enumerate(devices)]
        return APSSIndex(None, stats, None, None, shards=shards, **meta)
    C = torch.as_tensor(corpus)
    C = as_corpus(C, C.device)
    shards, stats = _dense_shards(C, devices, block_rows, normalize, home)
    return APSSIndex(None, stats, None, None, shards=shards, n=C.shape[0], m=C.shape[1],
                     block_rows=block_rows, kind="dense", normalized=normalized)


def _placement(device, devices) -> tuple[torch.device, list[torch.device]]:
    """The home device and the shards' devices (one, the home, unsharded)."""
    if devices is None:
        home = _resolved(device_of("cuda" if device is None else device))
        return home, [home]
    devices = [_resolved(device_of(d)) for d in devices]
    if not devices:
        raise ValueError("devices must name at least one device")
    if device is not None and _resolved(device_of(device)) != devices[0]:
        raise ValueError(f"device={device} is not the home device devices[0]={devices[0]}")
    return devices[0], devices


def _resolved(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _dense_shards(C, devices, block_rows, normalize, home):
    """Shard by shard (one shard: the unsharded index): its ``rows`` of
    ``C`` moved to the shard's device, normalized there and zero-padded to
    ``rows × width``, the width lane-padded to the feature tile the query
    path reads (the last shards take the padding rows), and its block
    stats, gathered onto ``home``. No other whole padded copy is made."""
    n, m = C.shape
    p = len(devices)
    rows = block_rows * -(-n // (p * block_rows))
    width = m + (-m) % _pick_bk(m, 512)
    shards, parts = [], []
    for s, dev in enumerate(devices):
        part = C[s * rows:(s + 1) * rows].to(dev)
        if normalize:
            part = normalize_rows(part)
        shard = part.new_zeros((rows, width))
        shard[:part.shape[0], :m] = part
        shards.append(shard)
        parts.append(dense_block_stats(shard, block_rows))
    stats = BlockStats(*(torch.cat([f.to(home) for f in fields]) for fields in zip(*parts)))
    return shards, stats


def index_nbytes(index: APSSIndex) -> int:
    """Total bytes of the index's tensors, every shard's (benchmark accounting)."""
    corpus = [x for shard in index.shards
              for x in (shard if index.is_sparse else (shard,))]
    extra = [x for x in (index.bdims, index.bx) if x is not None]
    return int(sum(x.numel() * x.element_size() for x in corpus + list(index.stats) + extra))
