"""The least time a kernel's call could take on one H100, from the work its
inputs need, whatever implements it.

Each kernel has a module here (``k1.py``, ...) with ``DEVICE_NAMES``, the
substrings of its device records' names in the profiler's trace, and
``count(run)``, which returns ``{key: (ops, bytes)}`` for each distinct call
input of the run (one for a self-join; one per pool batch for queries):

- bytes: every input byte that the call needs read once, in the
  representation the cell hands over, and the ``Matches`` written once;
- ops: 2 × the nonzero products of the row pairs the call must score, so a
  method that multiplies zeros reads low, and no exact method can read over
  100 %.

The bound is the larger of ``ops / PEAK_FLOPS`` and ``bytes / PEAK_BYTES``.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores: the highest peak
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """``(seconds, "ops" | "bytes")``: the bound and which of the two set it."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def matches_bytes(rows: int, k: int) -> int:
    """``Matches`` of ``rows`` rows: f32 values and int32 ids ``(rows, k)``,
    int32 counts."""
    return rows * k * 8 + rows * 4


def doc_freq(indices: torch.Tensor, nnz: torch.Tensor, m: int) -> torch.Tensor:
    """Rows holding each dimension, ``(m,)`` int64, from padded CSR."""
    live = torch.arange(indices.shape[1], device=indices.device)[None, :] < nnz[:, None]
    return torch.bincount(indices[live].long(), minlength=m)


def join_pair_products(indices: torch.Tensor, nnz: torch.Tensor, m: int) -> float:
    """Nonzero products over the unordered row pairs of a self-join:
    ``Σ_d df_d (df_d − 1) / 2``."""
    df = doc_freq(indices, nnz, m).double()
    return float((df * (df - 1) / 2).sum())


def query_pair_products(q_indices, q_nnz, df: torch.Tensor, m: int) -> float:
    """Nonzero products of a query batch against the corpus: ``Σ_d qf_d df_d``."""
    qf = doc_freq(q_indices, q_nnz, m).double()
    return float((qf * df.double()).sum())


def sharing_rows(q_indices, q_nnz, c_indices, c_nnz, m: int) -> int:
    """Corpus rows that share a dimension with some query of the batch."""
    used = torch.zeros(m + 1, dtype=torch.bool, device=q_indices.device)
    ql = torch.arange(q_indices.shape[1], device=q_indices.device)[None, :] < q_nnz[:, None]
    used[q_indices[ql].long()] = True
    cl = torch.arange(c_indices.shape[1], device=c_indices.device)[None, :] < c_nnz[:, None]
    hit = used[torch.where(cl, c_indices.long(), m)]
    return int(hit.any(dim=1).sum())
