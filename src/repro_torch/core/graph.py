"""Similarity-graph construction from APSS matches (host-side numpy).

Converts the fixed-capacity :class:`Matches` into COO edge lists and into
the padded edge arrays that graph consumers take as input.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.matches import Matches


def matches_to_coo(
    m: Matches, *, undirected: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert matches to COO ``(rows, cols, weights)``.

    With ``undirected=True``, keeps each unordered pair once (``i < j``).
    """
    vals = m.values.detach().cpu().numpy()
    idx = m.indices.detach().cpu().numpy()
    n, k = idx.shape
    rows = np.repeat(np.arange(n, dtype=np.int32), k)
    cols = idx.reshape(-1)
    w = vals.reshape(-1)
    keep = cols >= 0
    if undirected:
        keep &= rows < cols
    return rows[keep], cols[keep], w[keep].astype(np.float32)


def coo_to_padded_edges(
    rows: np.ndarray,
    cols: np.ndarray,
    weights: np.ndarray,
    max_edges: int,
    *,
    add_reverse: bool = True,
    add_self_loops_n: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a COO edge list to a static size.

    Returns ``(src, dst, weight, edge_mask)`` each of length ``max_edges``.
    Padding edges point at node 0 with mask 0.
    """
    if add_reverse:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        weights = np.concatenate([weights, weights])
    if add_self_loops_n is not None:
        loop = np.arange(add_self_loops_n, dtype=rows.dtype)
        rows = np.concatenate([rows, loop])
        cols = np.concatenate([cols, loop])
        weights = np.concatenate([weights, np.ones_like(loop, dtype=weights.dtype)])
    e = len(rows)
    if e > max_edges:
        raise ValueError(f"{e} edges exceed static capacity {max_edges}")
    pad = max_edges - e
    src = np.pad(rows.astype(np.int32), (0, pad))
    dst = np.pad(cols.astype(np.int32), (0, pad))
    w = np.pad(weights.astype(np.float32), (0, pad))
    mask = np.pad(np.ones(e, np.float32), (0, pad))
    return src, dst, w, mask


def match_set(m: Matches) -> set[tuple[int, int]]:
    """Unordered match pairs as a python set (test/debug utility)."""
    rows, cols, _ = matches_to_coo(m, undirected=True)
    return {(int(i), int(j)) for i, j in zip(rows, cols)}
