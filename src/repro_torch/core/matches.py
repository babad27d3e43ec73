"""Fixed-capacity match extraction for APSS (PyTorch).

Matches are represented per query row as a top-``k`` buffer plus an
*exact* per-row match count:

- ``values[i, :]``  the ``k`` highest similarities ≥ ``t`` for row ``i``
  (padded with ``-inf``),
- ``indices[i, :]`` their global column ids (padded with ``-1``),
- ``counts[i]``     the exact number of matches ≥ ``t`` (may exceed ``k``; a
  count larger than ``k`` flags truncation, never silently).

Ids and counts are ``torch.int32``. Selection is exact and ordered: higher
value first and, on equal values, the lower position first. That is the
order ``lax.top_k`` gives the reference; ``torch.topk`` promises no order
among ties, so every selection here goes through :func:`stable_topk`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = float("-inf")


class Matches(NamedTuple):
    """Top-k thresholded matches for a block of query rows."""

    values: torch.Tensor   # (rows, k) f32
    indices: torch.Tensor  # (rows, k) i32, -1 = empty slot
    counts: torch.Tensor   # (rows,)   i32, exact #matches ≥ t

    @property
    def capacity(self) -> int:
        return self.values.shape[-1]

    def overflowed(self) -> torch.Tensor:
        """Rows whose exact count exceeds the top-k capacity."""
        return self.counts > self.capacity


def empty_matches(rows: int, k: int, device: str | torch.device) -> Matches:
    return Matches(
        values=torch.full((rows, k), NEG_INF, dtype=torch.float32, device=device),
        indices=torch.full((rows, k), -1, dtype=torch.int32, device=device),
        counts=torch.zeros((rows,), dtype=torch.int32, device=device),
    )


def stable_topk(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last axis, ties by lower position.

    Returns ``(top_values, positions)`` with ``min(k, cols)`` columns.
    """
    kk = min(k, values.shape[-1])
    v, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :kk], pos[..., :kk]


def topk_by_id(
    values: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best ``(value, id)`` pairs by (value desc, id asc).

    Used where candidates arrive in no particular id order (packet folds);
    the result does not depend on the order of the input columns.
    """
    by_id = torch.argsort(ids, dim=-1, stable=True)
    v = torch.gather(values, -1, by_id)
    i = torch.gather(ids, -1, by_id)
    v, pos = stable_topk(v, k)
    return v, torch.gather(i, -1, pos)


def _pad_k(vals: torch.Tensor, idx: torch.Tensor, k: int):
    kk = vals.shape[-1]
    if kk < k:  # narrower than capacity: pad out to k
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return vals, idx


def extract_matches(
    scores: torch.Tensor,
    threshold: float,
    k: int,
    *,
    row_offset: int = 0,
    col_offset: int = 0,
    exclude_self: bool = True,
    col_valid: torch.Tensor | None = None,
) -> Matches:
    """Extract per-row thresholded top-k matches from a dense score tile.

    Args:
      scores: ``(rows, cols)`` dense similarity tile, f32.
      threshold: similarity threshold ``t``.
      k: match capacity per row.
      row_offset / col_offset: global ids of ``scores[0, 0]``, used for
        self-pair exclusion and for emitting global column indices.
      exclude_self: mask the ``i == j`` diagonal (APSS self-join semantics).
      col_valid: optional ``(cols,)`` bool mask for padded corpus columns.
    """
    rows, cols = scores.shape
    dev = scores.device
    scores = scores.float()
    gcol = torch.arange(cols, dtype=torch.int32, device=dev) + int(col_offset)
    ok = scores >= float(np.float32(threshold))
    if exclude_self:
        grow = torch.arange(rows, dtype=torch.int32, device=dev) + int(row_offset)
        ok &= grow[:, None] != gcol[None, :]
    if col_valid is not None:
        ok &= col_valid.to(dev, torch.bool)[None, :]

    masked = torch.where(ok, scores, NEG_INF)
    vals, local_idx = stable_topk(masked, k)
    idx = torch.where(vals > NEG_INF, gcol[local_idx], -1)
    vals, idx = _pad_k(vals, idx, k)
    counts = ok.sum(dim=-1, dtype=torch.int32)
    return Matches(values=vals, indices=idx, counts=counts)


def merge_matches(a: Matches, b: Matches) -> Matches:
    """Merge two match sets over *disjoint* column ranges for the same rows.

    Counts add; the top-k buffers are re-selected from the union (ties go to
    ``a``, the lower position, as ``lax.top_k`` does for the reference).
    """
    vals = torch.cat([a.values, b.values], dim=-1)
    idx = torch.cat([a.indices, b.indices], dim=-1)
    top_vals, sel = stable_topk(vals, a.capacity)
    top_idx = torch.gather(idx, -1, sel)
    top_idx = torch.where(top_vals > NEG_INF, top_idx, -1)
    return Matches(values=top_vals, indices=top_idx, counts=a.counts + b.counts)


def dedupe_candidates(
    values: torch.Tensor, indices: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate per-row ``(value, index)`` candidate lists by index.

    Duplicates arise in the vertical compressed accumulation when several
    devices propose the same candidate column (each copy carries the same
    fully accumulated score). Returns the lists sorted by index (stable, so
    the first occurrence of every index stays), with duplicate and empty
    slots set to ``(-inf, -1)``.

    Args:
      values: ``(rows, c)`` scores.
      indices: ``(rows, c)`` int32 column ids, -1 = empty.
    """
    order = torch.argsort(indices, dim=-1, stable=True)  # -1 sentinels first
    s_idx = torch.gather(indices, -1, order)
    s_val = torch.gather(values, -1, order)
    prev = torch.cat([torch.full_like(s_idx[:, :1], -2), s_idx[:, :-1]], dim=-1)
    first = (s_idx != prev) & (s_idx >= 0)
    return torch.where(first, s_val, NEG_INF), torch.where(first, s_idx, -1)


def matches_from_candidates(
    values: torch.Tensor,
    indices: torch.Tensor,
    threshold: float,
    k: int,
    *,
    row_offset: int = 0,
    exclude_self: bool = True,
    dedupe: bool = True,
) -> Matches:
    """Build :class:`Matches` from per-row ``(value, index)`` candidate lists.

    Used by the vertical compressed and recursive accumulations, whose final
    scores live in compacted form rather than in a dense tile. The top ``k``
    are taken by value, ties to the lower position of the (deduplicated)
    list, as ``lax.top_k`` does for the reference.
    """
    values = values.float()
    if dedupe:
        values, indices = dedupe_candidates(values, indices)
    ok = (values >= float(np.float32(threshold))) & (indices >= 0)
    if exclude_self:
        grow = torch.arange(values.shape[0], dtype=torch.int32, device=values.device)
        ok &= indices != grow[:, None] + int(row_offset)
    masked = torch.where(ok, values, NEG_INF)
    vals, sel = stable_topk(masked, k)
    idx = torch.gather(torch.where(ok, indices, -1), -1, sel)
    idx = torch.where(vals > NEG_INF, idx, -1)
    vals, idx = _pad_k(vals, idx, k)
    return Matches(values=vals, indices=idx, counts=ok.sum(dim=-1, dtype=torch.int32))


def total_matches(m: Matches) -> torch.Tensor:
    """Total directed match count (each unordered pair counted twice)."""
    return m.counts.sum()
