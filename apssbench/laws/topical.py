"""``topical``: the rows fall into ``topics`` contiguous groups, one topic
after another as the corpus is stored; topic ``c`` draws its dimensions
from its own band ``[c·w, (c + 1)·w)`` of ``w = m // topics``, Zipf-popular
within the band; otherwise the ``zipf`` law (nonzeros a row, weights,
normalisation). Rows of two topics share no dimension. ``assumed``:
``topics``, ``zipf_alpha``."""

from __future__ import annotations

import torch

from apssbench.gen import row_nnz, weighted, zipf_dims


def topical_csr(n: int, m: int, avg_nnz: float, alpha: float, topics: int,
                gen: torch.Generator):
    width = m // topics
    per = -(-n // topics)
    nnz = row_nnz(n, avg_nnz, width, gen)
    cap = int(nnz.max())
    slots = torch.arange(cap, device=gen.device)
    indices = torch.empty((n, cap), dtype=torch.int32, device=gen.device)
    for c in range(topics):
        r0, r1 = c * per, min(n, (c + 1) * per)
        if r0 >= r1:
            break
        dims = zipf_dims(nnz[r0:r1], cap, width, alpha, gen)
        live = slots[None, :] < nnz[r0:r1, None]
        indices[r0:r1] = torch.where(live, dims + c * width, 0)
    return weighted(indices, nnz, m, gen)


def draw(config: dict, gen):
    a = config["assumed"]
    return topical_csr(config["n"], config["m"], config["nnz"] / config["n"], a["zipf_alpha"],
                       a["topics"], gen)
