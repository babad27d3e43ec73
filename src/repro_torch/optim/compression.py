"""Top-k gradient compression with error feedback.

The paper's local-pruning insight — threshold partial scores locally, then
communicate only the survivors — applied to data-parallel gradient
synchronization: each rank keeps its top-k gradient coordinates (by
magnitude, after adding the error-feedback residual), all-gathers the
compacted ``(index, value)`` pairs (volume ``2·k·p`` instead of the dense
``n``), and adds them into the synchronized gradient. The dropped mass is
carried to the next step (error feedback), which preserves convergence
(Stich et al., arXiv:1809.07599; Lin et al. DGC, arXiv:1712.01887).

The reference's ``repro.optim.compression`` over the port's collective
layer (``core/distributed.py``): every rank of ``mesh`` calls these
functions, and ``axis`` names the mesh axis the gradients are reduced over.
The top-k puts the lower index first among equal magnitudes, as
``lax.top_k``; the gathered coordinates are added rank by rank, in rank
order (each rank's k indices are distinct), so every coordinate's sum has
the reference's order and the same bits on every run: no atomics.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.distributed import _all_gather, _axis_size, _psum
from repro_torch.core.matches import stable_topk
from repro_torch.optim.optimizer import tree_leaves, tree_map, tree_unflatten


class CompressionState(NamedTuple):
    error: Any  # tree like the grads (f32): this rank's untransmitted residual


def compression_init(grads_like) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _topk_sparsify(flat: torch.Tensor, k: int):
    """The k largest-|.| entries of a flat vector, lower index first on
    ties; returns ``(vals, idx)``."""
    _, idx = stable_topk(flat.abs(), k)
    return flat[idx], idx.to(torch.int32)


def compressed_psum_mean(
    g: torch.Tensor,
    error: torch.Tensor,
    mesh,
    axis,
    *,
    ratio: float = 0.01,
    min_size: int = 4096,
):
    """Mean-reduce one gradient leaf over ``axis`` of ``mesh`` with top-k
    compression. Leaves smaller than ``min_size`` take a dense psum
    (compression bookkeeping would cost more than it saves). Returns
    ``(g_synced_mean, new_error)``."""
    p = _axis_size(mesh, axis)
    n = g.numel()
    if n < min_size:
        return _psum(g.float(), mesh, axis) / p, torch.zeros_like(error)

    k = max(1, int(n * ratio))
    acc = g.float().reshape(-1) + error.reshape(-1)
    vals, idx = _topk_sparsify(acc, k)
    # Residual: what this rank did NOT transmit (error feedback).
    transmitted = torch.zeros(n, dtype=torch.float32, device=g.device)
    transmitted[idx.long()] = vals
    new_error = (acc - transmitted).reshape(error.shape)
    # Exchange compacted coordinates: 2·k·p words vs n dense.
    all_vals = _all_gather(vals, mesh, axis).reshape(p, k)
    all_idx = _all_gather(idx, mesh, axis).reshape(p, k).long()
    dense = torch.zeros(n, dtype=torch.float32, device=g.device)
    for r in range(p):
        dense[all_idx[r]] = dense[all_idx[r]] + all_vals[r]
    return (dense / p).reshape(g.shape), new_error


def compress_tree(
    grads,
    state: CompressionState,
    mesh,
    axis,
    *,
    ratio: float = 0.01,
    min_size: int = 4096,
):
    """:func:`compressed_psum_mean` leaf by leaf; returns ``(synced, state)``."""
    synced, errs = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(state.error), strict=True):
        s, ne = compressed_psum_mean(g, e, mesh, axis, ratio=ratio, min_size=min_size)
        synced.append(s.to(g.dtype))
        errs.append(ne)
    return tree_unflatten(grads, synced), CompressionState(error=tree_unflatten(grads, errs))


def compression_comm_bytes(grads, *, ratio: float = 0.01, min_size: int = 4096,
                           p: int = 2) -> dict:
    """Napkin accounting: dense vs compressed collective volume (bytes)."""
    dense = 0
    compressed = 0
    for g in tree_leaves(grads):
        n = g.numel()
        if n < min_size:
            dense += 4 * n
            compressed += 4 * n
        else:
            k = max(1, int(n * ratio))
            dense += 4 * n
            compressed += 8 * k * p  # idx + val, gathered from p ranks
    return {"dense_bytes": dense, "compressed_bytes": compressed,
            "ratio": compressed / max(dense, 1)}
