"""Synthetic corpora with the paper's dataset statistics (numpy only).

The port's own copy of ``repro.data.synthetic``: the same generators with
the same random streams, so one seed gives byte-identical arrays in both
packages. It is kept separate because importing ``repro.data`` loads JAX.

The paper's five real-world datasets (Table 1) are text corpora with
Zipf-distributed dimension (term) frequencies. ``synthetic_corpus``
reproduces that structure: dimension popularity ~ Zipf(alpha), TF-IDF-like
positive weights, L2-normalized rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Table 1 of the paper (name → n, m, nnz). Used to scale synthetic stand-ins.
PAPER_DATASETS = {
    "radikal": dict(n=6883, m=136447, nnz=1072472, t=0.2),
    "20-newsgroups": dict(n=20001, m=313389, nnz=2984809, t=0.4),
    "wikipedia": dict(n=70115, m=1350761, nnz=43285850, t=0.9),
    "facebook": dict(n=66568, m=4618973, nnz=14277455, t=0.99),
    "virginia-tech": dict(n=85653, m=367098, nnz=25827347, t=0.99),
}


def synthetic_corpus(
    n: int,
    m: int,
    avg_nnz: float,
    *,
    zipf_alpha: float = 1.1,
    seed: int = 0,
) -> np.ndarray:
    """Power-law sparse corpus as a dense (n, m) float32 array, row-normalized.

    Dimension d is chosen with prob ∝ (d+1)^-alpha (Zipf over dims); weights
    are |N(0,1)| + 0.05. Rows are L2-normalized (the paper's assumption).
    """
    rng = np.random.default_rng(seed)
    D = np.zeros((n, m), np.float32)
    pop = (np.arange(1, m + 1, dtype=np.float64)) ** (-zipf_alpha)
    pop /= pop.sum()
    nnz_per_row = np.maximum(1, rng.poisson(avg_nnz, size=n))
    for i in range(n):
        k = min(int(nnz_per_row[i]), m)
        dims = rng.choice(m, size=k, replace=False, p=pop)
        w = np.abs(rng.standard_normal(k)).astype(np.float32) + 0.05
        D[i, dims] = w
    norms = np.linalg.norm(D, axis=1, keepdims=True)
    D /= np.maximum(norms, 1e-12)
    return D


def clustered_corpus(
    n: int,
    m: int,
    avg_nnz: float,
    *,
    n_clusters: int = 32,
    zipf_alpha: float = 1.1,
    seed: int = 0,
) -> np.ndarray:
    """Topic-clustered Zipfian corpus: the block-pruning-friendly regime.

    Rows are grouped into ``n_clusters`` contiguous clusters, each drawing
    its dimensions from a disjoint band of ``m / n_clusters`` dims, so tiles
    that cross cluster boundaries share no support and the maxweight bound
    proves them dead.
    """
    rng = np.random.default_rng(seed)
    D = np.zeros((n, m), np.float32)
    band = m // n_clusters
    rows_per = -(-n // n_clusters)
    pop = np.arange(1, band + 1, dtype=np.float64) ** (-zipf_alpha)
    pop /= pop.sum()
    nnz_per_row = np.maximum(1, rng.poisson(avg_nnz, size=n))
    for i in range(n):
        c = min(i // rows_per, n_clusters - 1)
        k = min(int(nnz_per_row[i]), band)
        dims = c * band + rng.choice(band, size=k, replace=False, p=pop)
        D[i, dims] = np.abs(rng.standard_normal(k)).astype(np.float32) + 0.05
    D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)
    return D


def paper_like_corpus(
    name: str, *, scale: float = 0.02, seed: int = 0
) -> tuple[np.ndarray, float]:
    """A scaled-down stand-in for one of the paper's Table-1 datasets.

    Returns ``(D, threshold)`` with the paper's per-dataset threshold.
    """
    spec = PAPER_DATASETS[name]
    n = max(64, int(spec["n"] * scale))
    m = max(128, int(spec["m"] * scale))
    avg_nnz = max(4.0, spec["nnz"] / spec["n"] * min(1.0, scale * 4))
    return synthetic_corpus(n, m, avg_nnz, seed=seed), spec["t"]


@dataclasses.dataclass
class CorpusStats:
    n: int
    m: int
    nnz: int
    avg_vector_size: float
    avg_dim_size: float
    sparsity: float

    def row(self) -> str:
        return (
            f"n={self.n} m={self.m} nnz={self.nnz} "
            f"avg|x|={self.avg_vector_size:.1f} avg|I_d|={self.avg_dim_size:.1f} "
            f"sparsity={self.sparsity:.2e}"
        )


def corpus_stats(D: np.ndarray) -> CorpusStats:
    """The paper's Table-1 columns for any corpus."""
    nz = D != 0
    nnz = int(nz.sum())
    n, m = D.shape
    dims_used = max(int((nz.sum(0) > 0).sum()), 1)
    return CorpusStats(
        n=n,
        m=m,
        nnz=nnz,
        avg_vector_size=nnz / n,
        avg_dim_size=nnz / dims_used,
        sparsity=nnz / (n * m),
    )
