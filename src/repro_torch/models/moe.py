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

``moe_ffn`` is differentiable, as the reference's: the gradient reaches
the router through the gate values and through the aux loss's ``probs``,
and the experts through the dispatch buffer. The routing decisions (top-k,
the stable sort, the capacity) carry none.

:func:`moe_ffn_ep` is the reference's expert-parallel dispatch: under a
mesh with a ``model`` axis each rank routes its data shard's tokens, keeps
the slots of its own ``E / p_model`` experts, runs them and adds its part
of the combine; one all-reduce over ``model`` sums the parts. Counts are
a ``scatter_add_`` of ones (``torch.bincount`` has no meta kernel; the
bits are the same).

On a rank's ``Transformer(cfg, device, mesh)`` (``models.transformer``) a
``MoEParams`` holds its block of the reference's specs
(:func:`moe_param_specs` with ``fsdp``): ``E / p_model`` experts, and with
FSDP the second dimension of the stacks and the router's first split over
the data axes; each call gathers them over those axes before use
(``sharding.weight_for_use``), so routing is the reference's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.matches import stable_topk
from repro_torch.core.precision import exact_f32
from repro_torch.distributed.sharding import weight_for_use
from repro_torch.models.layers import count_ids, take


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


def moe_param_specs(fsdp: bool = False) -> dict:
    """Specs of :class:`MoEParams`' parameters, by name: the experts over
    the model axis (expert parallelism); with ``fsdp`` each stack's second
    dimension and the router's first over ``("pod", "data")`` (the
    reference's ``param_specs``), else the router replicated."""
    f = ("pod", "data") if fsdp else None
    return {"router": (f, None), "w_gate": ("model", f, None),
            "w_up": ("model", f, None), "w_down": ("model", f, None)}


def local_experts(params: MoEParams, mesh, model_axis: str = "model") -> MoEParams:
    """The rank's part of ``params`` on ``mesh``: the whole router and the
    stacks of experts ``[me · E_loc, (me + 1) · E_loc)``, copied, where
    ``me`` is the rank's place on ``model_axis``. :func:`moe_ffn_ep` takes
    it as it takes the whole stacks."""
    lo, hi = _expert_range(params.router.shape[1], mesh, model_axis)
    out = MoEParams(params.router.shape[0], params.w_gate.shape[2], 0, params.w_gate.dtype,
                    "meta")
    out.router = params.router
    for name in ("w_gate", "w_up", "w_down"):
        w = getattr(params, name)
        setattr(out, name, nn.Parameter(w[lo:hi].clone(), requires_grad=w.requires_grad))
    return out


def _expert_range(n_experts: int, mesh, model_axis: str) -> tuple[int, int]:
    from repro_torch.core.distributed import _axis_size

    p = _axis_size(mesh, model_axis)
    if n_experts % p:
        raise ValueError(f"{n_experts} experts do not split over {p} {model_axis!r} ranks")
    me = mesh.get_local_rank(model_axis)
    return me * (n_experts // p), (me + 1) * (n_experts // p)


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
    router = weight_for_use(params.router)
    logits = torch.matmul(x.to(router_dtype), router.to(router_dtype))
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = stable_topk(probs, top_k)
    flat_expert = expert_ids.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = count_ids(flat_expert, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * top_k, device=x.device) - starts[sorted_expert]
    keep = rank < C
    slot = torch.where(keep, sorted_expert * C + rank, E * C)
    return MoERoute(probs, expert_ids, gates, order, slot, keep, C)


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
    buf[r.slot] = take(x, flat_token)      # only the trash row takes several writes
    buf = buf[:E * C].reshape(E, C, d)

    g = torch.bmm(buf, weight_for_use(params.w_gate))
    u = torch.bmm(buf, weight_for_use(params.w_up))
    h = F.silu(g.float()).to(x.dtype) * u
    y_flat = torch.bmm(h, weight_for_use(params.w_down)).reshape(E * C, d)

    gathered = torch.where(r.keep[:, None], take(y_flat, r.slot.clamp(max=E * C - 1)), 0.0)
    weighted = gathered.float() * r.gates.reshape(-1)[r.order][:, None]
    per_slot = torch.empty_like(weighted)
    per_slot[r.order] = weighted           # back to (token, slot) order: a permutation
    y = per_slot.reshape(T, top_k, d).sum(dim=1)
    return MoEOut(y=y.to(x.dtype), aux_loss=aux, dropped_frac=dropped)


# ---------------------------------------------------------------------------
# Expert-parallel dispatch (the reference's shard_map)
# ---------------------------------------------------------------------------


def moe_ffn_ep(
    params: MoEParams,
    x: torch.Tensor,            # (T_loc, d): this rank's data shard of the tokens
    *,
    top_k: int,
    capacity_factor: float,
    mesh,
    data_axes: tuple,
    model_axis: str = "model",
    router_dtype=torch.float32,
) -> MoEOut:
    """Replicated-activation expert parallelism, rank by rank.

    Every rank of a ``(data…, model)`` mesh holds its data shard's tokens
    ``x`` (the same on every ``model`` rank) and the whole router. It
    routes its tokens, keeps only the slots of its own experts
    ``[me · E_loc, (me + 1) · E_loc)``, runs them (three ``bmm``s) and adds
    its partial combine in the fixed slot order; then one all-reduce over
    ``model`` in the activation dtype, summed in rank order, gives ``y``
    (``T_loc × d`` a layer: the only traffic). ``params`` holds either every
    expert (the rank slices its own) or only the rank's (:func:`local_experts`).

    Capacity is per (expert × data shard): ``C = max(1, int(T_loc·k·cf /
    E))``, equal to :func:`moe_ffn`'s dispatch whenever nothing drops.
    ``aux`` is the mean over the data axes of each shard's aux loss and
    ``dropped_frac`` the mean over data and model of each rank's drops
    among its experts' slots, as the reference's ``pmean``s.

    The gradients are ``shard_map``'s: the router, ``x`` and a whole expert
    stack enter with a backward that sums their gradient over ``model``;
    ``y``'s all-reduce passes its gradient through; ``aux`` passes
    ``1 / p_model`` of it to each rank (the ``model`` ranks compute it
    alike, and the router's sum over ``model`` adds their shares). The
    caller averages the gradients over the data axes.
    """
    from repro_torch.core.distributed import (
        _axis_size,
        enter_replicated,
        pmean,
        psum_in_order,
        psum_replicated,
    )

    exact_f32()
    T_loc, d = x.shape
    E = params.router.shape[1]
    lo, hi = _expert_range(E, mesh, model_axis)
    E_loc = hi - lo
    me = lo // E_loc
    p_m = _axis_size(mesh, model_axis)
    model = (model_axis,)
    daxes = tuple(a for a in data_axes if a in mesh.mesh_dim_names)
    C = capacity(T_loc, top_k, capacity_factor, E)

    x_in = enter_replicated(x, mesh, model)
    router = enter_replicated(weight_for_use(params.router), mesh, model)
    stacks = [weight_for_use(w) for w in (params.w_gate, params.w_up, params.w_down)]
    if params.w_gate.shape[0] == E:
        w_gate, w_up, w_down = (enter_replicated(w, mesh, model)[lo:hi] for w in stacks)
    else:
        w_gate, w_up, w_down = stacks

    logits = torch.matmul(x_in.to(router_dtype), router.to(router_dtype))
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = stable_topk(probs, top_k)
    ce = F.one_hot(expert_ids[:, 0], E).float().mean(dim=0)
    aux = pmean(E * torch.sum(probs.mean(dim=0) * ce), mesh, daxes, grad_scale=1.0 / p_m)

    flat_e = expert_ids.reshape(-1)
    owned = torch.div(flat_e, E_loc, rounding_mode="floor") == me
    local_e = torch.where(owned, flat_e - me * E_loc, E_loc)       # E_loc = trash
    order = torch.argsort(local_e, stable=True)
    sorted_e = local_e[order]
    counts = count_ids(local_e, E_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T_loc * top_k, device=x.device) - starts[sorted_e]
    keep = (sorted_e < E_loc) & (rank < C)
    with torch.no_grad():
        drop_local = owned.float().sum() - keep.float().sum()
        dropped = drop_local / max(T_loc * top_k / p_m, 1.0)
        dropped = psum_in_order(dropped, mesh, daxes + model) / _axis_size(mesh, daxes + model)

    slot = torch.where(keep, sorted_e * C + rank, E_loc * C)
    flat_token = torch.arange(T_loc, device=x.device).repeat_interleave(top_k)[order]
    buf = torch.zeros((E_loc * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = take(x_in, flat_token)     # only the trash row takes several writes
    buf = buf[:E_loc * C].reshape(E_loc, C, d)

    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    y_flat = torch.bmm(h, w_down).reshape(E_loc * C, d)

    gathered = torch.where(keep[:, None], take(y_flat, slot.clamp(max=E_loc * C - 1)), 0.0)
    weighted = gathered.float() * gates.reshape(-1)[order][:, None]
    per_slot = torch.empty_like(weighted)
    per_slot[order] = weighted
    y_part = per_slot.reshape(T_loc, top_k, d).sum(dim=1)
    # summed in the activation dtype, as the reference's psum: each token's
    # slots lie on disjoint ranks, so this is the one rounding of a bf16 combine
    y = psum_replicated(y_part.to(x.dtype), mesh, model)
    return MoEOut(y=y, aux_loss=aux, dropped_frac=dropped)
