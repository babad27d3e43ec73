"""Sparse corpus representation and sparse APSS scoring primitives (PyTorch).

The paper's experimental regime is sparse text (density below 1 %, its
Table 1). A dense ``(n, m)`` tensor spends ``n·m`` floats on ``n·avg_nnz``
of payload, so the sparse self-join keeps the corpus in
:class:`SparseCorpus`: padded CSR (ELL). Every row stores exactly ``cap``
``(index, value)`` slots, real entries first, padding slots holding the
inert ``(0, 0.0)`` (scatter adds 0, gathers multiply by 0, maxweight maxes
with 0). ``nnz`` keeps the exact per-row count, which makes the minsize
bound exact (``core.pruning``).

Scoring never builds ``(n, m)``:

- :func:`densify_rows` scatters ONE row block to dense ``(rows, m)``;
- :func:`gather_dot` scores a dense query block against a CSR corpus block
  in ``O(rows · cols · cap)`` operations.

:func:`sparse_similarity_topk` composes them into the blocked join behind
``apss_blocked(sp, use_kernel=False)``; the pruned worklist path with
kernel K3 is ``kernels/apss_block/sparse.py``.

Duplicate coordinates within a row are legal and mean summation (the COO
convention): :func:`to_dense` scatter-adds and :func:`gather_dot` sums every
slot. Consumers of per-component magnitudes (norms, maxweight bounds)
combine duplicates first with :func:`dedupe_rows`.

Functions work on the device the corpus lies on. :func:`from_dense` takes
``device=`` (default ``"cuda"``, which raises without a card) and
:meth:`SparseCorpus.to` moves a corpus.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.matches import Matches, empty_matches, extract_matches, merge_matches
from repro_torch.interop import device_of


class SparseCorpus(NamedTuple):
    """Padded-CSR (ELL) corpus.

    Attributes:
      indices: ``(n, cap)`` int32 dimension ids; padding slots hold 0.
      values:  ``(n, cap)`` float32 weights; padding slots hold 0.0.
      nnz:     ``(n,)`` int32 exact per-row stored-entry count.
      m:       number of dimensions.
    """

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

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.m)

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to(self, device: str | torch.device) -> SparseCorpus:
        """The same corpus on ``device``, with int32 ids and f32 values."""
        dev = device_of(device)
        return SparseCorpus(
            self.indices.to(dev, torch.int32).contiguous(),
            self.values.to(dev, torch.float32).contiguous(),
            self.nnz.to(dev, torch.int32).contiguous(),
            int(self.m),
        )

    def __repr__(self) -> str:
        return f"SparseCorpus(n={self.n}, m={self.m}, cap={self.cap})"


def from_dense(D, cap: int | None = None, *, device: str | torch.device = "cuda"):
    """Dense → padded-CSR conversion (row indices sorted), on ``device``.

    ``cap`` may only widen the layout (extra inert padding slots); a cap
    below the largest row nnz would drop values and break the exact-``nnz``
    contract, so it raises instead.
    """
    dev = device_of(device)
    D = D.to(dev) if isinstance(D, torch.Tensor) else torch.tensor(np.asarray(D), device=dev)
    n, m = D.shape
    nz = D != 0
    nnz = nz.sum(dim=1, dtype=torch.int32)
    need = max(1, int(nnz.max())) if n else 1
    if cap is not None and cap < need:
        raise ValueError(f"cap={cap} would truncate rows (max nnz {need})")
    cap = int(cap if cap is not None else need)
    rows, cols = torch.nonzero(nz, as_tuple=True)  # row-major: cols ascend per row
    start = torch.cumsum(nnz, 0, dtype=torch.int64) - nnz
    slot = torch.arange(rows.numel(), device=D.device) - start[rows]
    indices = torch.zeros((n, cap), dtype=torch.int32, device=D.device)
    values = torch.zeros((n, cap), dtype=torch.float32, device=D.device)
    indices[rows, slot] = cols.to(torch.int32)
    values[rows, slot] = D[rows, cols].float()
    return SparseCorpus(indices, values, nnz, m)


def to_dense(sp: SparseCorpus) -> torch.Tensor:
    """CSR → dense ``(n, m)`` f32 scatter; duplicate coordinates sum."""
    out = torch.zeros(sp.shape, dtype=torch.float32, device=sp.device)
    rows = torch.arange(sp.n, device=sp.device)[:, None].expand(-1, sp.cap)
    out.index_put_((rows, sp.indices.long()), sp.values.float(), accumulate=True)
    return out


def dedupe_rows(
    indices: torch.Tensor, values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine duplicate coordinates within each row: run-sums in place.

    Returns same-shape ``(indices, values)`` where each distinct dimension's
    slots are summed into the run's last slot and every other slot becomes
    the inert ``(0, 0.0)``. Sort + cumsum per row, never densified.
    """
    si, order = torch.sort(indices, dim=1, stable=True)
    sv = torch.gather(values.float(), 1, order)
    c = torch.cumsum(sv, dim=1)
    pos = torch.arange(si.shape[1], device=si.device).expand_as(si)
    step = si[:, 1:] != si[:, :-1]
    edge = torch.ones_like(si[:, :1], dtype=torch.bool)
    first = torch.cat([edge, step], dim=1)
    last = torch.cat([step, edge], dim=1)
    start = torch.cummax(torch.where(first, pos, 0), dim=1).values
    run_sum = c - torch.gather(c - sv, 1, start)  # Σ of the run
    return torch.where(last, si, 0), torch.where(last, run_sum, 0.0)


def normalize_sparse(sp: SparseCorpus, eps: float = 1e-12) -> SparseCorpus:
    """L2-normalize rows in CSR form (the paper's ``||x|| = 1``).

    Norms are taken over per-component sums (:func:`dedupe_rows`), so
    duplicate coordinates are handled; uniform slot scaling scales every
    component uniformly.
    """
    _, comp = dedupe_rows(sp.indices, sp.values)
    nrm = torch.sqrt(torch.sum(comp * comp, dim=1))
    scale = 1.0 / torch.clamp_min(nrm, eps)
    return SparseCorpus(sp.indices, sp.values * scale[:, None], sp.nnz, sp.m)


def pad_rows_sparse(sp: SparseCorpus, multiple: int) -> tuple[SparseCorpus, int]:
    """Zero-pad rows to a multiple; padding rows are empty (nnz 0)."""
    n = sp.n
    rem = (-n) % multiple
    if rem:
        pad = torch.nn.functional.pad
        sp = SparseCorpus(
            pad(sp.indices, (0, 0, 0, rem)),
            pad(sp.values, (0, 0, 0, rem)),
            pad(sp.nnz, (0, rem)),
            sp.m,
        )
    return sp, n


def density(sp: SparseCorpus) -> float:
    """Exact density (stored entries / n·m)."""
    return float(sp.nnz.sum()) / float(sp.n * sp.m)


def shard_dims(
    sp: SparseCorpus, p: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side vertical (dimension) split into ``p`` contiguous slices.

    The paper's 1-D vertical distribution: device ``d`` owns dimensions
    ``[d·m/p, (d+1)·m/p)``, a contiguous shard of the inverted index, and
    sees every row restricted to that slice.

    Returns stacked ``(p, n, cap_loc)`` indices (slice-relative) and values,
    ``(p, n)`` local nnz, and ``m_loc = m // p``. ``cap_loc`` is the largest
    per-slice per-row count (one for all slices, so the stack is
    rectangular).
    """
    if sp.m % p:
        raise ValueError(f"m={sp.m} must be a multiple of p={p}")
    m_loc = sp.m // p
    idx = sp.indices.cpu().numpy()
    val = sp.values.cpu().numpy()
    nnz = sp.nnz.cpu().numpy()
    n, cap = idx.shape
    valid = np.arange(cap)[None, :] < nnz[:, None]
    owner = idx // m_loc
    counts = np.stack([(valid & (owner == d)).sum(axis=1) for d in range(p)])  # (p, n)
    cap_loc = max(1, int(counts.max(initial=1)))
    out_idx = np.zeros((p, n, cap_loc), np.int32)
    out_val = np.zeros((p, n, cap_loc), np.float32)
    for d in range(p):
        sel = valid & (owner == d)
        # Stable-pack the selected slots to the front of each row.
        order = np.argsort(~sel, axis=1, kind="stable")[:, :cap_loc]
        packed = np.take_along_axis(sel, order, axis=1)
        out_idx[d] = np.where(packed, np.take_along_axis(idx, order, axis=1) - d * m_loc, 0)
        out_val[d] = np.where(packed, np.take_along_axis(val, order, axis=1), 0.0)
    return out_idx, out_val, counts.astype(np.int32), m_loc


def dim_slices(sp: SparseCorpus, p: int) -> list[SparseCorpus]:
    """The ``p`` per-slice corpora of :func:`shard_dims`, on ``sp``'s device.

    Slice ``d`` holds every row restricted to dimensions ``[d·m/p,
    (d+1)·m/p)`` with slice-relative indices and ``m = m/p``: the cells of
    one checkerboard column of ``apss_2d``.
    """
    idx_s, val_s, nnz_s, m_loc = shard_dims(sp, p)
    dev = sp.device
    return [
        SparseCorpus(torch.from_numpy(idx_s[d]).to(dev), torch.from_numpy(val_s[d]).to(dev),
                     torch.from_numpy(nnz_s[d]).to(dev), m_loc)
        for d in range(p)
    ]


# ---------------------------------------------------------------------------
# Scoring primitives
# ---------------------------------------------------------------------------


def densify_rows(sp: SparseCorpus, start: int, rows: int) -> torch.Tensor:
    """Scatter rows ``[start, start + rows)`` to dense ``(rows, m)`` f32.

    The only densification the sparse join performs: one query block at a
    time, never the corpus.
    """
    idx = sp.indices[start:start + rows].long()
    val = sp.values[start:start + rows].float()
    r = torch.arange(idx.shape[0], device=sp.device)[:, None].expand_as(idx)
    out = torch.zeros((idx.shape[0], sp.m), dtype=torch.float32, device=sp.device)
    return out.index_put_((r, idx), val, accumulate=True)


def gather_dot(
    qd: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, *, chunk: int = 32
) -> torch.Tensor:
    """Sparse tile scores: dense query block × CSR corpus block.

    ``s[r, c] = Σ_k qd[r, idx[c, k]] · val[c, k]``: ``O(rows · cols · cap)``
    operations; padding slots (value 0) add nothing, duplicate coordinates
    sum. The cap axis is folded in ``chunk``-sized pieces, so the gathered
    intermediate stays ``O(rows · cols · chunk)``.
    """
    rows = qd.shape[0]
    cols, cap = idx.shape
    acc = torch.zeros((rows, cols), dtype=torch.float32, device=qd.device)
    for a in range(0, cap, chunk):
        g = qd[:, idx[:, a:a + chunk].long()]  # (rows, cols, chunk)
        acc += torch.einsum("rck,ck->rc", g, val[:, a:a + chunk].float())
    return acc


def sparse_similarity_topk(
    Q: SparseCorpus,
    C: SparseCorpus,
    threshold: float,
    k: int = 32,
    *,
    block_rows: int = 512,
    exclude_self: bool = False,
    row_offset: int = 0,
    col_offset: int = 0,
) -> Matches:
    """Blocked sparse similarity join of ``Q (nq, m)`` vs ``C (nc, m)``.

    The sparse twin of ``core.apss.similarity_topk``: query blocks are
    densified one at a time (:func:`densify_rows`), corpus blocks stay CSR
    and are scored with :func:`gather_dot`, so operations and peak memory
    are ``O(block² · cap)`` and ``O(block · m)``, never ``O(n · m)``.
    """
    if Q.m != C.m:
        # Out-of-range gathers would otherwise fail far from the cause.
        raise ValueError(f"dimension mismatch: Q.m={Q.m} vs C.m={C.m}")
    nq = Q.n
    Qp, _ = pad_rows_sparse(Q, block_rows)
    Cp, nc = pad_rows_sparse(C, block_rows)
    dev = Cp.device
    parts = []
    for q0 in range(0, Qp.n, block_rows):
        qd = densify_rows(Qp, q0, block_rows)
        mm = empty_matches(block_rows, k, dev)
        for c0 in range(0, Cp.n, block_rows):
            s = gather_dot(
                qd, Cp.indices[c0:c0 + block_rows], Cp.values[c0:c0 + block_rows]
            )
            col_valid = torch.arange(c0, c0 + block_rows, device=dev) < nc
            mm = merge_matches(mm, extract_matches(
                s, threshold, k,
                row_offset=int(row_offset) + q0, col_offset=int(col_offset) + c0,
                exclude_self=exclude_self, col_valid=col_valid,
            ))
        parts.append(mm)
    return Matches(*(torch.cat(f)[:nq] for f in zip(*parts)))

