"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

Serves the two MoE architectures:
- arctic-480b: 128 experts, top-2, plus a parallel dense residual FFN
  (``models/transformer.py``);
- deepseek-moe-16b: 64 fine-grained routed experts, top-6, plus 2 shared
  experts that every token passes through.

Dispatch is the reference's static-shape sort/capacity scheme, decision for
decision: tokens are ranked within their expert by a stable sort, kept
below ``capacity = max(1, int(T·k·cf / E))``, scattered into an
``(E, C, d)`` buffer (dropped tokens go to a trash row), multiplied through
the stacked expert weights with one ``torch.bmm`` per matrix (the
reference's einsums, which no Pallas kernel computes), and combined back
with the router gates. A dropped (over-capacity) token gets zero expert
output for that slot. Each token's ``k`` weighted outputs are summed in
slot order, never by atomics, so the bits do not vary from run to run.

Expert parallelism over a mesh (``moe_ffn_ep``) waits for ROADMAP queue 1
item 9.4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.matches import stable_topk
from repro_torch.core.precision import exact_f32


class MoEParams(nn.Module):
    """Router ``(d, E)`` in f32; expert stacks ``w_gate``, ``w_up``
    ``(E, d, f)`` and ``w_down`` ``(E, f, d)`` in the model's dtype (the
    reference's orientation: no transpose)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, dtype, device):
        super().__init__()

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = empty(d_model, n_experts, dt=torch.float32)
        self.w_gate = empty(n_experts, d_model, d_ff)
        self.w_up = empty(n_experts, d_model, d_ff)
        self.w_down = empty(n_experts, d_ff, d_model)


@torch.no_grad()
def init_moe(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.bfloat16, device=None) -> MoEParams:
    """The reference's init laws: router normal × √(2/(d+E)) in f32, each
    expert matrix normal × √(2/(d_in+d_out))."""
    p = MoEParams(d_model, d_ff, n_experts, dtype, device)
    p.router.copy_(torch.randn(p.router.shape, generator=generator, device=device)
                   * (2.0 / (d_model + n_experts)) ** 0.5)
    for w in (p.w_gate, p.w_up, p.w_down):
        a, b = w.shape[1:]
        w.copy_((torch.randn(w.shape, generator=generator, device=device)
                 * (2.0 / (a + b)) ** 0.5).to(dtype))
    return p


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor     # load-balancing loss (Switch-style)
    dropped_frac: torch.Tensor


class MoERoute(NamedTuple):
    """The routing decisions of one :func:`moe_ffn` call."""

    probs: torch.Tensor        # (T, E) f32 softmax of the router logits
    expert_ids: torch.Tensor   # (T, k) int64, by gate desc, lower id first on ties
    gates: torch.Tensor        # (T, k) f32
    order: torch.Tensor        # (T·k,) stable sort of the flat expert ids
    slot: torch.Tensor         # (T·k,) buffer row of each sorted entry; E·C = dropped
    keep: torch.Tensor         # (T·k,) bool, in sorted order
    capacity: int


def capacity(tokens: int, top_k: int, capacity_factor: float, n_experts: int) -> int:
    """Slots per expert, truncated as the reference truncates."""
    return max(1, int(tokens * top_k * capacity_factor / n_experts))


def moe_route(params: MoEParams, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, router_dtype=torch.float32) -> MoERoute:
    exact_f32()
    T = x.shape[0]
    E = params.router.shape[1]
    C = capacity(T, top_k, capacity_factor, E)
    logits = torch.matmul(x.to(router_dtype), params.router.to(router_dtype))
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = stable_topk(probs, top_k)
    flat_expert = expert_ids.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = torch.bincount(flat_expert, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * top_k, device=x.device) - starts[sorted_expert]
    keep = rank < C
    slot = torch.where(keep, sorted_expert * C + rank, E * C)
    return MoERoute(probs, expert_ids, gates, order, slot, keep, C)


@torch.no_grad()
def moe_ffn(
    params: MoEParams,
    x: torch.Tensor,            # (T, d) flattened tokens
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    router_dtype=torch.float32,
) -> MoEOut:
    T, d = x.shape
    E = params.router.shape[1]
    r = moe_route(params, x, top_k=top_k, capacity_factor=capacity_factor,
                  router_dtype=router_dtype)
    C = r.capacity

    # Load-balance aux loss: E * Σ_e f_e·p_e  (Switch Transformer eq. 4).
    me = r.probs.mean(dim=0)
    ce = F.one_hot(r.expert_ids[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    dropped = 1.0 - r.keep.float().mean()

    flat_token = torch.arange(T, device=x.device).repeat_interleave(top_k)[r.order]
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[r.slot] = x[flat_token]            # only the trash row takes several writes
    buf = buf[:E * C].reshape(E, C, d)

    g = torch.bmm(buf, params.w_gate)
    u = torch.bmm(buf, params.w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    y_flat = torch.bmm(h, params.w_down).reshape(E * C, d)

    gathered = torch.where(r.keep[:, None], y_flat[r.slot.clamp(max=E * C - 1)], 0.0)
    weighted = gathered.float() * r.gates.reshape(-1)[r.order][:, None]
    per_slot = torch.empty_like(weighted)
    per_slot[r.order] = weighted           # back to (token, slot) order: a permutation
    y = per_slot.reshape(T, top_k, d).sum(dim=1)
    return MoEOut(y=y.to(x.dtype), aux_loss=aux, dropped_frac=dropped)
