"""Synthetic stand-ins of the paper's Table 1 corpora, drawn on the device.

A configuration's ``assumed.law`` names its law, ``apssbench/laws/<law>.py``;
the pieces here are shared. The ``zipf`` law (``zipf_csr``): a row's nonzero
count is Poisson(nnz / n), at least 1 and at most m; its dimensions are
drawn without replacement with probability proportional to Zipf popularity
``(d + 1) ** -alpha``; its weights are ``|N(0, 1)| + 0.05``; rows are
L2-normalised. Sampling without replacement is Gumbel-top-k: each row keeps
the ``nnz`` dimensions with the largest ``log p_d + G_d`` (``G`` standard
Gumbel), which is the law of drawing one dimension at a time with
probability ∝ ``p`` among those left. All draws come from one
``torch.Generator`` on the device, in a few large calls, so one seed gives
the same corpus on one kind of card.

Queries follow the serving traffic model: a batch is a contiguous range of
corpus rows, or rows drawn at random across the corpus, whose nonzeros are
jittered by ``noise · |N(0, 1)|`` and then L2-renormalised (near-duplicate,
topical lookups).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CHUNK_ELEMENTS = 1 << 28  # Gumbel keys drawn at a time (1 GiB of f32)


class Csr(NamedTuple):
    """Padded CSR: ``indices (n, cap)`` int32 dimension ids sorted ascending
    in each row, padding slots ``0``; ``values (n, cap)`` f32, padding
    ``0.0``; ``nnz (n,)`` int32; ``m`` dimensions."""

    indices: torch.Tensor
    values: torch.Tensor
    nnz: torch.Tensor
    m: int

    @property
    def n(self) -> int:
        return self.indices.shape[0]

    @property
    def cap(self) -> int:
        return self.indices.shape[1]

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in (self.indices, self.values, self.nnz))


def _normalised(values: torch.Tensor) -> torch.Tensor:
    norm = values.square().sum(dim=1, keepdim=True).sqrt()
    return values / norm.clamp_min(1e-12)


def row_nnz(n: int, avg_nnz: float, cap: int, gen: torch.Generator) -> torch.Tensor:
    """Each row's nonzero count, Poisson(``avg_nnz``) clamped to ``[1, cap]``."""
    rates = torch.full((n,), float(avg_nnz), dtype=torch.float32, device=gen.device)
    return torch.poisson(rates, generator=gen).clamp_(1, cap).to(torch.int32)


def zipf_dims(nnz: torch.Tensor, cap: int, width: int, alpha: float,
              gen: torch.Generator) -> torch.Tensor:
    """``(r, cap)`` int32 dimensions in ``[0, width)``: row ``i`` draws
    ``nnz[i]`` without replacement, ∝ ``(d + 1) ** -alpha``, sorted
    ascending; padding slots ``0``."""
    dev = gen.device
    logp = -alpha * torch.arange(1, width + 1, dtype=torch.float32, device=dev).log()
    slots = torch.arange(cap, device=dev)
    out = torch.empty((nnz.shape[0], cap), dtype=torch.int32, device=dev)
    rows = max(1, CHUNK_ELEMENTS // width)
    for r0 in range(0, nnz.shape[0], rows):
        r1 = min(nnz.shape[0], r0 + rows)
        keys = torch.rand((r1 - r0, width), generator=gen, device=dev)
        keys.log_().neg_().log_().neg_().add_(logp)  # log p + Gumbel
        top = keys.topk(cap, dim=1).indices
        del keys
        live = slots[None, :] < nnz[r0:r1, None]
        dims = torch.where(live, top, width).sort(dim=1).values
        out[r0:r1] = torch.where(live, dims, 0).to(torch.int32)
    return out


def weighted(indices: torch.Tensor, nnz: torch.Tensor, m: int, gen: torch.Generator) -> Csr:
    """The CSR of ``indices`` with weights ``|N(0, 1)| + 0.05``, rows
    L2-normalised."""
    live = torch.arange(indices.shape[1], device=indices.device)[None, :] < nnz[:, None]
    weights = torch.randn(indices.shape, generator=gen, device=gen.device).abs_().add_(0.05)
    return Csr(indices, _normalised(torch.where(live, weights, 0.0)), nnz, m)


def zipf_csr(n: int, m: int, avg_nnz: float, alpha: float, gen: torch.Generator) -> Csr:
    """An ``n × m`` corpus of the module's law on ``gen``'s device."""
    nnz = row_nnz(n, avg_nnz, m, gen)
    return weighted(zipf_dims(nnz, int(nnz.max()), m, alpha, gen), nnz, m, gen)


def densify(csr: Csr, rows: slice = slice(None), dtype=torch.float32) -> torch.Tensor:
    """Rows ``rows`` of the corpus as a dense ``(r, m)`` tensor (padding
    slots add 0 at dimension 0)."""
    idx, val = csr.indices[rows].long(), csr.values[rows].to(dtype)
    out = torch.zeros((idx.shape[0], csr.m), dtype=dtype, device=idx.device)
    out.scatter_add_(1, idx, val)
    return out


def query_pool(csr: Csr, batches: int, batch: int, noise: float, gen: torch.Generator,
               rows: str = "contiguous") -> Csr:
    """``batches`` batches of ``batch`` queries, stacked in order. Batch
    ``b`` is, by ``rows``, ``contiguous``: rows ``[s_b, s_b + batch)`` of
    the corpus (``s_b`` drawn from ``gen``), or ``scattered``: ``batch``
    distinct rows drawn uniformly, in the order drawn. Each nonzero is
    raised by ``noise · |N(0, 1)|``, then the row L2-renormalised. The
    queries keep their rows' dimensions."""
    n = csr.n
    if batch > n:
        raise ValueError(f"a batch of {batch} queries needs at least {batch} corpus rows")
    if rows == "contiguous":
        starts = torch.randint(0, n - batch + 1, (batches,), generator=gen, device=gen.device)
        rows = (starts[:, None] + torch.arange(batch, device=gen.device)[None, :]).reshape(-1)
    elif rows == "scattered":
        keys = torch.rand((batches, n), generator=gen, device=gen.device)
        rows = keys.topk(batch, dim=1).indices.reshape(-1)
    else:
        raise ValueError(f"rows is 'contiguous' or 'scattered', not {rows!r}")
    idx, val = csr.indices[rows], csr.values[rows]
    jitter = torch.randn(val.shape, generator=gen, device=gen.device).abs_().mul_(noise)
    val = _normalised(torch.where(val > 0, val + jitter, 0.0))
    return Csr(idx.contiguous(), val.contiguous(), csr.nnz[rows].contiguous(), csr.m)
