"""Sparse corpus generators that never build ``(n, m)`` (numpy + torch).

The port's own copy of ``repro.data.sparse``: the same draws from the same
numpy random stream, so one seed gives the same indices and nnz in both
packages (values to f32 rounding of the row norms). They build the
padded-CSR ``SparseCorpus`` directly: memory is ``O(n · cap)``, so shapes
at the paper's ``m`` cost what their payload costs.

Same structure as the dense twins in ``data.synthetic``: Zipf-distributed
dimension popularity, and a topic-clustered variant where tile pruning
fires. Rows are L2-normalized in CSR form; coordinates are unique per row.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.apss import normalize_rows
from repro_torch.core.sparse import SparseCorpus, densify_rows, normalize_sparse
from repro_torch.interop import device_of


def _finish(indices, values, nnz, m, device) -> SparseCorpus:
    dev = device_of(device)
    sp = SparseCorpus(
        torch.from_numpy(indices).to(dev),
        torch.from_numpy(values).to(dev),
        torch.from_numpy(np.asarray(nnz, np.int32)).to(dev),
        m,
    )
    return normalize_sparse(sp)


def _zipf_pop(size: int, alpha: float) -> np.ndarray:
    pop = np.arange(1, size + 1, dtype=np.float64) ** (-alpha)
    return pop / pop.sum()


def sparse_zipfian_corpus(
    n: int,
    m: int,
    avg_nnz: float,
    *,
    zipf_alpha: float = 1.1,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> SparseCorpus:
    """Power-law sparse corpus, CSR-direct (the paper's Table-1 regime).

    Dimension ``d`` is drawn with prob ∝ ``(d+1)^-alpha``; per-row
    coordinates are unique; rows L2-normalized. ``cap`` is the realized max
    row nnz.
    """
    rng = np.random.default_rng(seed)
    pop = _zipf_pop(m, zipf_alpha)
    nnz = np.minimum(np.maximum(1, rng.poisson(avg_nnz, size=n)), m).astype(
        np.int32
    )
    cap = int(nnz.max())
    indices = np.zeros((n, cap), np.int32)
    values = np.zeros((n, cap), np.float32)
    for i in range(n):
        k = int(nnz[i])
        dims = np.sort(rng.choice(m, size=k, replace=False, p=pop))
        indices[i, :k] = dims
        values[i, :k] = np.abs(rng.standard_normal(k)).astype(np.float32) + 0.05
    return _finish(indices, values, nnz, m, device)


def perturbed_queries(
    sp: SparseCorpus,
    nq: int,
    *,
    noise: float = 0.02,
    start: int | None = None,
    seed: int = 1,
) -> np.ndarray:
    """Dense query batch: perturbed rows from one contiguous corpus range.

    The serving traffic model: near-duplicate, topical queries. Rows
    ``[start, start + nq)`` are densified, their nonzeros jittered by
    ``noise`` and the batch L2-renormalized, drawing the reference's numpy
    stream. Returns ``(nq, m)`` f32 numpy.
    """
    rng = np.random.default_rng(seed)
    if start is None:
        start = int(rng.integers(0, max(1, sp.n - nq)))
    qd = densify_rows(sp, start, min(nq, sp.n)).cpu().numpy()
    if qd.shape[0] < nq:  # tiny corpora: repeat rows to fill the batch
        reps = -(-nq // qd.shape[0])
        qd = np.tile(qd, (reps, 1))[:nq]
    jitter = noise * np.abs(rng.standard_normal(qd.shape)).astype(np.float32)
    qd = qd + jitter * (qd > 0)
    return normalize_rows(torch.from_numpy(qd)).numpy()


def sparse_clustered_corpus(
    n: int,
    m: int,
    avg_nnz: float,
    *,
    n_clusters: int = 32,
    zipf_alpha: float = 1.1,
    seed: int = 0,
    overlap_dims: int = 0,
    overlap_scale: float = 0.25,
    device: str | torch.device = "cuda",
) -> SparseCorpus:
    """Topic-clustered Zipfian corpus, CSR-direct (pruning-friendly regime).

    Contiguous row clusters draw dimensions from disjoint bands of
    ``m / n_clusters`` dims, so the inverted index proves cross-cluster
    tiles share no support. ``overlap_dims > 0`` reserves that many leading
    dimensions as a shared background vocabulary: every row adds two
    low-weight (``overlap_scale``) nonzeros there, so cross-cluster tiles
    get a small nonzero bound instead of a zero one.
    """
    rng = np.random.default_rng(seed)
    ov = int(overlap_dims)
    n_sh = 2 if ov >= 2 else ov
    band = (m - ov) // n_clusters
    rows_per = -(-n // n_clusters)
    pop = _zipf_pop(band, zipf_alpha)
    nnz = np.minimum(np.maximum(1, rng.poisson(avg_nnz, size=n)), band).astype(
        np.int32
    )
    cap = int(nnz.max()) + n_sh
    indices = np.zeros((n, cap), np.int32)
    values = np.zeros((n, cap), np.float32)
    for i in range(n):
        c = min(i // rows_per, n_clusters - 1)
        k = int(nnz[i])
        dims = ov + c * band + rng.choice(band, size=k, replace=False, p=pop)
        vals = np.abs(rng.standard_normal(k)).astype(np.float32) + 0.05
        if n_sh:
            sh = rng.choice(ov, size=n_sh, replace=False)
            shv = overlap_scale * (
                np.abs(rng.standard_normal(n_sh)).astype(np.float32) + 0.05
            )
            dims = np.concatenate([sh, dims])
            vals = np.concatenate([shv, vals])
            k += n_sh
        order = np.argsort(dims)
        indices[i, :k] = dims[order]
        values[i, :k] = vals[order]
    if n_sh:
        nnz = nnz + n_sh
    return _finish(indices, values, nnz, m, device)
