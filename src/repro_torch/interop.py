"""Moving APSS state between numpy (and so the JAX package) and the port.

This system has no weights; the corpus (dense, or a padded-CSR
``SparseCorpus``), the block statistics of an index and the ``Matches`` a
join returns are its state. These functions carry each across in either
direction with the port's dtypes: float32 scores, int32 ids and counts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.matches import Matches
from repro_torch.core.pruning import BlockStats


def device_of(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def as_corpus(D, device: str | torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on ``device``.

    A bf16 corpus stays bf16 (the kernels read it and sum in f32); every
    other dtype becomes float32.
    """
    dev = device_of(device)
    t = torch.as_tensor(D)
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t.to(dev).contiguous()


def corpus_from_numpy(D: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """An ``(n, m)`` numpy corpus as a float32 tensor on ``device``."""
    return as_corpus(np.array(D, np.float32), device)


def sparse_corpus_from_numpy(
    indices: np.ndarray, values: np.ndarray, nnz: np.ndarray, m: int,
    device: str | torch.device,
):
    """A padded-CSR ``SparseCorpus`` (int32 ids, f32 values, int32 nnz) from
    the numpy arrays of one, e.g. ``np.asarray`` of a JAX corpus's fields."""
    from repro_torch.core.sparse import SparseCorpus  # core.sparse imports this module

    dev = device_of(device)
    return SparseCorpus(
        indices=torch.tensor(np.asarray(indices, np.int32), device=dev),
        values=torch.tensor(np.asarray(values, np.float32), device=dev),
        nnz=torch.tensor(np.asarray(nnz, np.int32), device=dev),
        m=int(m),
    )


def sparse_corpus_to_numpy(sp) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """``(indices, values, nnz, m)`` of a ``SparseCorpus`` from either package."""
    return (
        _host(sp.indices).astype(np.int32),
        _host(sp.values).astype(np.float32),
        _host(sp.nnz).astype(np.int32),
        int(sp.m),
    )


def block_stats_from_numpy(
    maxw: np.ndarray, mw: np.ndarray, max_nnz: np.ndarray,
    device: str | torch.device,
) -> BlockStats:
    """Index block statistics (``BlockStats`` fields) from numpy arrays."""
    dev = device_of(device)
    return BlockStats(
        maxw=torch.tensor(np.asarray(maxw), device=dev),
        mw=torch.tensor(np.asarray(mw), device=dev),
        max_nnz=torch.tensor(np.asarray(max_nnz, np.int32), device=dev),
    )


def matches_from_numpy(
    values: np.ndarray, indices: np.ndarray, counts: np.ndarray,
    device: str | torch.device,
) -> Matches:
    """``Matches`` from numpy arrays (f32 values, i32 ids and counts)."""
    dev = device_of(device)
    return Matches(
        values=torch.tensor(np.asarray(values, np.float32), device=dev),
        indices=torch.tensor(np.asarray(indices, np.int32), device=dev),
        counts=torch.tensor(np.asarray(counts, np.int32), device=dev),
    )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def matches_to_numpy(m) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(values, indices, counts)`` as numpy arrays, from either package."""
    return (
        _host(m.values).astype(np.float32),
        _host(m.indices).astype(np.int32),
        _host(m.counts).astype(np.int32),
    )


def index_from_numpy(
    corpus,
    maxw: np.ndarray,
    mw: np.ndarray,
    max_nnz: np.ndarray,
    *,
    bdims: np.ndarray | None = None,
    bx: np.ndarray | None = None,
    n: int,
    m: int,
    block_rows: int,
    kind: str,
    normalized: bool,
    device: str | torch.device,
):
    """A serving ``APSSIndex`` from the numpy arrays of one, e.g. the leaves of
    a JAX index (``np.asarray`` of each): ``corpus`` is the padded dense
    array or the ``(indices, values, nnz)`` CSR triple, ``maxw``/``mw``/
    ``max_nnz`` its block stats and ``bdims``/``bx`` its sparse support
    compaction."""
    from repro_torch.serving.index import APSSIndex  # serving imports this module

    dev = device_of(device)
    if kind == "sparse":
        sp = sparse_corpus_from_numpy(*corpus, m, dev)
        corpus = (sp.indices, sp.values, sp.nnz)
        bdims = torch.tensor(np.asarray(bdims, np.int32), device=dev)
        bx = torch.tensor(np.asarray(bx, np.float32), device=dev)
    else:
        corpus = as_corpus(np.asarray(corpus), dev)
    return APSSIndex(
        corpus, block_stats_from_numpy(maxw, mw, max_nnz, dev), bdims, bx,
        n=n, m=m, block_rows=block_rows, kind=kind, normalized=normalized,
    )
