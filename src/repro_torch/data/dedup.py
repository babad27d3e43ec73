"""Near-duplicate detection for the data pipeline: the paper's own
application ("near-duplicate detection by using a high threshold").

Documents (as normalized feature vectors) are self-joined with the APSS
core at a high threshold; of every duplicate cluster only the lowest-index
row survives. On a CUDA device the self-join runs through K1
(``apss_blocked(use_kernel=True)``), on the CPU through the plain path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.apss import apss_blocked, normalize_rows
from repro_torch.core.graph import matches_to_coo
from repro_torch.interop import as_corpus


def dedup_corpus(
    D,
    *,
    threshold: float = 0.95,
    k: int = 64,
    block_rows: int = 512,
    device: str | torch.device = "cuda",
    use_kernel: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Return ``(keep_mask, duplicate_of)`` for the rows of ``D`` (numpy).

    ``duplicate_of[i] = j < i`` for dropped rows, else -1. ``use_kernel=None``
    takes K1 on a CUDA device and the plain path on the CPU.
    """
    Dn = normalize_rows(as_corpus(D, device))
    if use_kernel is None:
        use_kernel = Dn.device.type == "cuda"
    matches = apss_blocked(Dn, threshold, k, block_rows=block_rows, use_kernel=use_kernel,
                           device=Dn.device)
    rows, cols, _ = matches_to_coo(matches, undirected=True)
    n = Dn.shape[0]
    keep = np.ones(n, bool)
    dup_of = np.full(n, -1, np.int32)
    # rows < cols by construction: the later row is the duplicate.
    order = np.argsort(cols, kind="stable")
    for r, c in zip(rows[order], cols[order]):
        if keep[c] and keep[r]:
            keep[c] = False
            dup_of[c] = r
    return keep, dup_of
