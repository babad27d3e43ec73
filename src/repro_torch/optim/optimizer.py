"""AdamW (+ schedules and global-norm clipping) as plain functions over
trees of tensors.

A tree is a dict (walked in sorted key order, as JAX flattens one), a list,
a tuple or a named tuple, with tensors at its leaves; the trainer passes
``dict(model.named_parameters())``. Optimizer moments are f32 whatever the
parameters' dtype (bf16-safe), and every step of the update is the
reference's (``repro.optim.optimizer``) in its order: clip in f32 and cast
back, bias corrections ``1 − b**t`` in f32, the update in f32 and one
rounding to the parameter's dtype.

Unlike the reference, which returns new trees, :func:`adamw_update` writes
the parameters and the moments in place, a slice of at most ``CHUNK``
elements at a time: an embedding table of 10 GB then needs a few hundred MB
of temporaries, not three more copies of itself.

On a mesh every rank updates its own blocks (a rank's ``Transformer(mesh=)``
and, with FSDP, its blocks of the moments): the update is elementwise, so
only the global norm of the clip crosses ranks (``split``, ``mesh``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

CHUNK = 1 << 26  # elements of one leaf updated per slice (256 MB of f32)


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flattening order (``None`` has none)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero f32 moments of each leaf's shape, on its device; step 0."""
    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros(), v=zeros())


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """Σ g² in f32 with no temporary of ``g``'s size: a dot product per
    slice of ``CHUNK`` elements (cuBLAS takes at most 2³¹ − 1), summed in
    slice order."""
    flat = g.reshape(-1)
    parts = [torch.dot(c, c) for c in (flat[lo:lo + CHUNK].float()
                                        for lo in range(0, flat.numel(), CHUNK))]
    return sum(parts[1:], parts[0])


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, *, split: list | None = None, mesh=None,
                        repeats: list | None = None):
    """Scale ``grads`` in place so their global f32 norm is at most
    ``max_norm``; returns ``(grads, norm)``. Each leaf is scaled in f32 and
    cast back to its dtype.

    On a mesh whose ranks hold blocks of the leaves, ``split`` names, leaf
    by leaf in :func:`tree_leaves` order, the axes that split each one
    (``sharding.split_axes``; ``()`` for a whole leaf): each leaf's sum of
    squares is summed over those axes in rank order (one all-reduce per
    set of axes), never over the axes that replicate it, and the leaves'
    sums are added in leaf order, so every rank gets the same norm.
    ``repeats`` marks, leaf by leaf, a block that a lower rank of those
    axes holds too (``sharding.repeats_block``: a shared kv head): it adds
    0, so each head counts once."""
    leaves = tree_leaves(grads)
    sq = [torch.zeros((), dtype=torch.float32, device=g.device)
          if repeats is not None and repeats[i] else _sum_of_squares(g)
          for i, g in enumerate(leaves)]
    if split is not None and any(split):
        from repro_torch.core.distributed import psum_in_order

        for axes in sorted(set(split) - {()}):
            idx = [i for i, a in enumerate(split) if a == axes]
            summed = psum_in_order(torch.stack([sq[i] for i in idx]), mesh, axes)
            for j, i in enumerate(idx):
                sq[i] = summed[j]
    norm = torch.sqrt(sum(sq[1:], sq[0]))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


@torch.no_grad()
def _update_leaf(p, g, m, v, *, lr, b1, b2, eps, weight_decay, bc1, bc2) -> None:
    pf, mf, vf = (t.view(-1) for t in (p, m, v))
    gf = g.reshape(-1)
    for lo in range(0, pf.numel(), CHUNK):
        sl = slice(lo, lo + CHUNK)
        gc = gf[sl].float()
        m_new = b1 * mf[sl] + (1 - b1) * gc
        v_new = b2 * vf[sl] + (1 - b2) * gc * gc
        mh = m_new / bc1
        vh = v_new / bc2
        p32 = pf[sl].float()
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p32
        pf[sl] = (p32 - lr * delta).to(p.dtype)
        mf[sl] = m_new
        vf[sl] = v_new


def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
    split: list | None = None,
    mesh=None,
    repeats: list | None = None,
):
    """One AdamW step; returns ``(params, new_state, metrics)``. ``params``,
    ``state.m``, ``state.v`` (and ``grads``, by the clip) are written in
    place; the step count is a new tensor. ``metrics`` holds ``grad_norm``
    (with ``clip_norm``) and ``lr`` as f32 scalars. ``split``, ``mesh`` and
    ``repeats`` go to :func:`clip_by_global_norm` (leaves that are a rank's
    blocks)."""
    metrics = {}
    if clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, clip_norm, split=split, mesh=mesh,
                                           repeats=repeats)
        metrics["grad_norm"] = gnorm
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    flat_p = tree_leaves(params)
    for p, g, m, v in zip(flat_p, tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), strict=True):
        _update_leaf(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                     bc1=bc1, bc2=bc2)
    metrics["lr"] = lr
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics


def linear_warmup(step, base_lr: float, warmup_steps: int) -> torch.Tensor:
    s = torch.as_tensor(step).float()
    return base_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(
    step, base_lr: float, warmup_steps: int, total_steps: int,
    final_frac: float = 0.1,
) -> torch.Tensor:
    """Linear warm-up to ``base_lr``, then a cosine decay to ``final_frac ·
    base_lr`` at ``total_steps``; f32 on ``step``'s device."""
    s = torch.as_tensor(step).float()
    warm = linear_warmup(step, base_lr, warmup_steps)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup_steps, warm, base_lr * cos)
