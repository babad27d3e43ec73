"""Exact scores in float64 and the judge of a program's ``Matches``.

A cell's answer for a query row (a corpus row in a self-join) is its
top-``k`` by value, ties to the lower id, of the pairs with cosine ``≥ t``,
and the exact count of those pairs. The reference scores every pair in
float64 from the benchmark's own float32 inputs and judges each answered row
with a margin ``mu`` (the value limit: rounding within it may move a pair
across ``t`` or across the ``k``-th value):

- ``value_gap``: the largest ``|value − s|`` over the returned pairs, ``s``
  the float64 score of the returned id;
- ``rows_wrong``: rows whose answer breaks any of: the count lies within
  ``[#(s ≥ t + mu), #(s ≥ t − mu)]``; ``min(count, k)`` valid ids lead the
  list, the rest are ``(-inf, -1)``; ids are distinct, in range, not the
  row itself in a self-join, with ``s ≥ max(t, s_k) − mu`` (``s_k`` the
  reference's ``k``-th best); every pair with ``s ≥ max(t, s_k) + mu`` is
  returned; values do not increase along the list.

The control is this reference computed in the precision below the
configuration's float32: inputs rounded to TF32 (10 mantissa bits, to
nearest even, as the tensor cores round them) and products summed in
float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK_BYTES = 1 << 31  # the largest dense float64 operand block


def _dense(idx: torch.Tensor, val: torch.Tensor, m: int, dtype) -> torch.Tensor:
    out = torch.zeros((idx.shape[0], m), dtype=dtype, device=idx.device)
    out.scatter_add_(1, idx.long(), val.to(dtype))
    return out


def _blocks(rows: int, m: int, itemsize: int):
    step = max(1, BLOCK_BYTES // (m * itemsize))
    return [(a, min(rows, a + step)) for a in range(0, rows, step)]


def scores(q_idx, q_val, c_idx, c_val, m: int, *, dtype=torch.float64,
           round_inputs=None) -> torch.Tensor:
    """Every ``(query, corpus)`` dot product, ``(nq, nc)`` in ``dtype``,
    from padded-CSR rows, by dense blocks on the inputs' device."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    out = torch.empty((q_idx.shape[0], c_idx.shape[0]), dtype=dtype, device=q_idx.device)
    for c0, c1 in _blocks(c_idx.shape[0], m, itemsize):
        cb = _dense(c_idx[c0:c1], c_val[c0:c1], m, dtype)
        if round_inputs is not None:
            cb = round_inputs(cb)
        for q0, q1 in _blocks(q_idx.shape[0], m, itemsize):
            qb = _dense(q_idx[q0:q1], q_val[q0:q1], m, dtype)
            if round_inputs is not None:
                qb = round_inputs(qb)
            out[q0:q1, c0:c1] = qb @ cb.T
            del qb
        del cb
    return out


def join_scores(idx, val, m: int) -> torch.Tensor:
    """The self-join's float64 scores, the diagonal (a row with itself)
    set to ``-inf``."""
    s = scores(idx, val, idx, val, m)
    s.fill_diagonal_(float("-inf"))
    return s


def query_scores(q_idx, q_val, c_idx, c_val, m: int) -> torch.Tensor:
    """A query pool's float64 scores against the corpus."""
    return scores(q_idx, q_val, c_idx, c_val, m)


class Verdict(NamedTuple):
    value_gap: float
    rows_wrong: int
    row_gap: torch.Tensor    # (N,) f64: each row's largest value gap
    row_wrong: torch.Tensor  # (N,) bool


def judge(values, indices, counts, S, rows, *, t: float, k: int, mu: float,
          chunk: int = 4096) -> Verdict:
    """Judge ``N`` answered rows (``values``/``indices (N, k)``, ``counts
    (N,)``, on any device) against the float64 score rows ``S[rows]``."""
    dev = S.device
    n = S.shape[1]
    gaps, wrongs = [], []
    for a in range(0, values.shape[0], chunk):
        v = values[a:a + chunk].to(dev, torch.float64)
        i = indices[a:a + chunk].to(dev, torch.int64)
        c = counts[a:a + chunk].to(dev, torch.int64)
        s = S[rows[a:a + chunk].to(dev)]
        valid = i >= 0
        in_range = valid & (i < n)
        sref = torch.where(in_range, s.gather(1, i.clamp(0, n - 1)), float("-inf"))
        gap = torch.where(valid, (v - sref).abs(), 0.0).nan_to_num(nan=float("inf"))
        gaps.append(gap.amax(dim=1))
        kk = min(k, n)
        s_k = s.topk(kk, dim=1).values[:, kk - 1].clamp_min(t)
        need_at = s_k + mu
        bad = (c < (s >= t + mu).sum(1)) | (c > (s >= t - mu).sum(1))
        bad |= valid.sum(1) != c.clamp_max(k)
        bad |= (~valid[:, :-1] & valid[:, 1:]).any(1)
        bad |= (~valid & ((v != float("-inf")) | (i != -1))).any(1)
        bad |= (valid & ~in_range).any(1)
        srt = torch.where(valid, i, -1 - torch.arange(k, device=dev)).sort(dim=1).values
        bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
        bad |= (valid & (sref < s_k[:, None] - mu)).any(1)
        bad |= (valid & (sref >= need_at[:, None])).sum(1) != (s >= need_at[:, None]).sum(1)
        bad |= (valid[:, 1:] & (v[:, 1:] > v[:, :-1])).any(1)
        wrongs.append(bad)
    row_gap = torch.cat(gaps) if gaps else torch.zeros(0, dtype=torch.float64)
    row_wrong = torch.cat(wrongs) if wrongs else torch.zeros(0, dtype=torch.bool)
    return Verdict(float(row_gap.max()) if row_gap.numel() else 0.0,
                   int(row_wrong.sum()), row_gap, row_wrong)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32)


def control_matches(q_idx, q_val, c_idx, c_val, m: int, *, t: float, k: int,
                    exclude_self: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The control's ``(values, indices, counts)``: the reference's answer
    from TF32-rounded inputs and float32 sums, top ``k`` by value, ties to
    the lower id."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 sums of the rounded inputs
    try:
        s = scores(q_idx, q_val, c_idx, c_val, m, dtype=torch.float32, round_inputs=tf32_round)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if exclude_self:
        s.fill_diagonal_(float("-inf"))
    ok = s >= torch.tensor(t, dtype=torch.float32).item()
    s = torch.where(ok, s, float("-inf"))
    v, pos = torch.sort(s, dim=1, descending=True, stable=True)
    v, pos = v[:, :k], pos[:, :k]
    ids = torch.where(v > float("-inf"), pos, -1).to(torch.int32)
    return v, ids, ok.sum(1, dtype=torch.int32)
