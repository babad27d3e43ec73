"""Shared layers of the LM transformer, as plain functions over tensors.

Attention comes in two regimes, as in the reference package:

- :func:`chunked_attention` -- the flash algorithm in plain PyTorch (a loop
  over KV chunks with running ``(m, l, acc)``): the model's prefill path
  off the card, and on the card when the caller asks for the plain path.
  K8 (:mod:`repro_torch.kernels.flash_attention`) computes the same
  function on the card.
- :func:`decode_attention_xla` -- one new token against a KV cache; K9
  (:mod:`repro_torch.kernels.decode_attention`) takes its place on the card.

Matrices keep the reference's ``(d_in, d_out)`` orientation in these
functions; the LM stores them as ``nn.Linear`` weights ``(d_out, d_in)``,
the recsys and GNN models in the reference's orientation, in a
:class:`ParamTree`.

Gathers and segment sums whose backward adds into one row from several
places (an embedding lookup, a per-edge gather, a segment sum) are written
so that the adds come in a fixed order on every device: :func:`take` is
``F.embedding`` (its backward sums each row serially on the CPU and after a
sort on the card, where advanced indexing's CPU backward adds with atomics),
and :func:`segment_sum` sorts by segment and sums each segment serially. A
training step then has the same bits on every run, which a resumed run
needs.

On a mesh a :class:`ParamTree` holds the rank's blocks of the reference's
specs (:func:`cut_param_tree`): each parameter carries its ``.spec`` and
``.mesh``, and the functions below read them. :func:`lookup` is ``take``
on a table whose rows are split over ``model`` (each id read by the rank
that holds it, the ranks' rows summed: exactly one rank contributes to
each element, so the result is one process's lookup bit for bit);
:func:`column_parallel` and :func:`row_parallel` are Megatron's pair, and
:func:`mlp` runs a tower whose matrices are split by columns (the
activation gathered over ``model`` after each layer) or by a column and
row pair. Without a mesh they are ``take`` and plain products.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.precision import exact_f32
from repro_torch.kernels.decode_attention.decode_attention import decode_attention_plain

NEG_LARGE = -0.5e30


# -- norms -------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """QK-norm: RMS over the head dim of ``(..., H, D)`` activations."""
    return rms_norm(x, scale, eps)


# -- rotary position embedding -------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(
    x: torch.Tensor,          # (B, S, H, D)
    positions: torch.Tensor,  # (B, S)
    theta: float = 1e6,
) -> torch.Tensor:
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)            # (D/2,)
    angles = positions[..., None].float() * freqs           # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------


def _divisor_chunk(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def chunked_attention(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, Dv)
    *,
    causal: bool = True,
    scale: float | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    probs_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Flash attention in plain PyTorch: exact softmax, one ``(q_chunk,
    kv_chunk)`` score block live at a time.

    As in the reference, q is scaled in its own dtype, scores and the
    softmax statistics are f32, and every KV chunk is visited (causally dead
    chunks are masked, not skipped). ``probs_dtype`` rounds the
    probabilities before the value product, which still sums in f32.
    """
    exact_f32()
    b, hq, s, d = q.shape
    dv = v.shape[-1]
    hkv = k.shape[1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qc = _divisor_chunk(s, q_chunk)
    kc = _divisor_chunk(s, kv_chunk)
    qg = q.reshape(b, hkv, group, s, d)
    kf, vf = k.float(), v.float()
    outs = []
    for qi in range(s // qc):
        qq = (qg[:, :, :, qi * qc:(qi + 1) * qc] * scale).float()
        m = torch.full((b, hkv, group, qc, 1), NEG_LARGE, device=q.device)
        l = torch.zeros((b, hkv, group, qc, 1), device=q.device)
        acc = torch.zeros((b, hkv, group, qc, dv), device=q.device)
        for ki in range(s // kc):
            kk = kf[:, :, None, ki * kc:(ki + 1) * kc]
            vv = vf[:, :, None, ki * kc:(ki + 1) * kc]
            sij = torch.matmul(qq, kk.transpose(-1, -2))
            if causal:
                qpos = qi * qc + torch.arange(qc, device=q.device)
                kpos = ki * kc + torch.arange(kc, device=q.device)
                sij = torch.where(qpos[:, None] >= kpos[None, :], sij, NEG_LARGE)
            m_new = torch.maximum(m, sij.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sij - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = p if probs_dtype is None else p.to(probs_dtype).float()
            acc = acc * alpha + torch.matmul(pv, vv)
            m = m_new
        outs.append((acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, hq, s, dv)


def decode_attention_xla(
    q: torch.Tensor,        # (B, Hq, D)
    k: torch.Tensor,        # (B, Hkv, L, D)
    v: torch.Tensor,        # (B, Hkv, L, D)
    lengths: torch.Tensor,  # (B,)
    *,
    scale: float | None = None,
    with_partials: bool = False,
):
    """Single-token decode attention over the whole cache, masked to
    ``lengths`` (the reference's XLA path). Its partials are K9's function,
    so this is K9's plain version, normalised unless ``with_partials``."""
    acc, m, l = decode_attention_plain(q, k, v, lengths, scale=scale)
    if with_partials:
        return acc, m, l
    return (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    """SwiGLU MLP (LLaMA/Qwen FFN); weights ``(d_in, d_out)``."""
    exact_f32()
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)


# -- gathers and segment reductions ---------------------------------------------


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` for a table of any rank ≥ 2 (rows
    by ``ids``), by ``F.embedding`` (fixed-order backward)."""
    flat = table.reshape(table.shape[0], -1)
    out = F.embedding(ids.long(), flat)
    return out.reshape(*ids.shape, *table.shape[1:])


def model_split(t: torch.Tensor, dim: int) -> bool:
    """Whether ``t`` is a rank's block whose dimension ``dim`` its ``.spec``
    splits over ``model``."""
    from repro_torch.distributed.sharding import on_axis

    spec = getattr(t, "spec", None)
    if spec is None or len(spec) <= dim:
        return False
    return on_axis(spec[dim], "model")


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """:func:`take` on ``table``, which may be a rank's block of rows split
    over ``model`` (``table.spec``): ids outside the rank's rows read zeros
    and the ranks' results are summed over ``model`` in rank order, so
    each element is the one rank's row that holds it, bit for bit. The
    gradient passes to every rank alike and adds into the rank's own rows
    in :func:`take`'s fixed order."""
    if not model_split(table, 0):
        return take(table, ids)
    from repro_torch.core.distributed import psum_replicated

    n = table.shape[0]
    local = ids.long() - table.mesh.get_local_rank("model") * n
    own = (local >= 0) & (local < n)
    rows = take(table, torch.where(own, local, 0))
    rows = torch.where(own.reshape(*own.shape, *([1] * (table.dim() - 1))), rows, 0.0)
    return psum_replicated(rows, table.mesh, ("model",))


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` (ids in ``[0, n)``) as a
    ``scatter_add_`` of ones: the same counts, and it runs on the meta
    device, where ``bincount`` has no kernel."""
    ids = ids.long()
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """``jax.ops.segment_sum`` over axis 0 in a fixed order: the rows are
    stably sorted by segment and each segment summed serially in its rows'
    order (``torch.segment_reduce``), which is the order of the reference's
    scatter-add; an empty segment sums to 0. Ids must lie in
    ``[0, num_segments)``."""
    ids = segment_ids.long()
    order = torch.argsort(ids, stable=True)
    lengths = count_ids(ids, num_segments)
    return torch.segment_reduce(take(data, order), "sum", lengths=lengths, axis=0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """``jax.ops.segment_max`` over axis 0: a scatter max (exact in any
    order); an empty segment holds −inf, as the reference's."""
    ids = segment_ids.long().reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    init = torch.full((num_segments, *data.shape[1:]), float("-inf"), dtype=data.dtype,
                      device=data.device)
    return init.scatter_reduce(0, ids, data, "amax", include_self=True)


# -- MLP ----------------------------------------------------------------------


def column_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x · w`` where ``w`` may hold the rank's output columns (``(None,
    "model")``): Megatron's ``f``, ``x`` (alike on every ``model`` rank)
    entering a split product, its gradient summed over ``model``. The
    result is the rank's columns."""
    if model_split(w, 1):
        from repro_torch.core.distributed import enter_replicated

        x = enter_replicated(x, w.mesh, ("model",))
    return torch.matmul(x, w)


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x · w`` where ``w`` may hold the rank's input rows (``("model",
    None)``) and ``x`` the matching columns: Megatron's ``g``. Each rank's
    partial product is taken in f32, the partials added over ``model`` in
    rank order in f32 (the gradient passes) and rounded once to ``x``'s
    dtype, as one rank's product accumulates in f32 and rounds once."""
    if not model_split(w, 0):
        return torch.matmul(x, w)
    from repro_torch.core.distributed import psum_replicated

    y = torch.matmul(x.float(), w.float())
    return psum_replicated(y, w.mesh, ("model",)).to(x.dtype)


def gather_columns(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The rank's columns ``y`` of a product by ``like`` (split by columns
    over ``model``) gathered to the whole width; ``y`` unchanged else."""
    if not model_split(like, 1):
        return y
    from repro_torch.core.distributed import gather_replicated

    return gather_replicated(y, like.mesh, ("model",), y.dim() - 1)


def mlp(x: torch.Tensor, ws, bs, act=torch.relu) -> torch.Tensor:
    """Plain MLP tower (recsys): ``act`` on every layer but the last;
    weights ``(d_in, d_out)``. On a rank's blocks a matrix split by columns
    over ``model`` is :func:`column_parallel` with its bias block; if the
    next matrix is split by rows the pair is Megatron's (the activation
    stays the rank's columns, :func:`row_parallel` sums it), else the
    activation is gathered over ``model`` (:func:`gather_columns`)."""
    exact_f32()
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = row_parallel(h, w) + b if model_split(w, 0) else column_parallel(h, w) + b
        if i + 1 == len(ws) or not model_split(ws[i + 1], 0):
            h = gather_columns(h, w)
        if i < len(ws) - 1:
            h = act(h)
    return h


# -- init helpers ---------------------------------------------------------------


def dense_init(
    generator: torch.Generator, d_in: int, d_out: int, dtype=torch.bfloat16, device=None
) -> torch.Tensor:
    """``(d_in, d_out)``: standard normal times ``sqrt(2 / (d_in + d_out))``."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def embed_init(
    generator: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16, device=None
) -> torch.Tensor:
    """``(vocab, d)``: standard normal times 0.02."""
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# -- parameter trees --------------------------------------------------------------


class ParamTree(nn.Module):
    """A reference parameter tree (dicts of tensors, lists of tensors, lists
    of dicts) as a module, leaf for leaf: a dict becomes a ``ParamTree``, a
    list of tensors an ``nn.ParameterList``, a list of dicts an
    ``nn.ModuleList``. ``tree["key"]`` reads as ``tree.key``, so a model
    function reads the tree as the reference reads its dict, and
    ``named_parameters`` names each leaf by its path (``blocks.0.wq``)."""

    mesh = None  # a rank's blocks: the mesh they are cut for (cut_param_tree)

    def __init__(self, tree: dict, *, requires_grad: bool = True):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(key, nn.Parameter(value, requires_grad=requires_grad))
            elif isinstance(value, dict):
                self.add_module(key, ParamTree(value, requires_grad=requires_grad))
            elif all(isinstance(v, torch.Tensor) for v in value):
                self.add_module(key, nn.ParameterList(
                    nn.Parameter(v, requires_grad=requires_grad) for v in value))
            else:
                self.add_module(key, nn.ModuleList(
                    ParamTree(v, requires_grad=requires_grad) for v in value))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def keys(self) -> list:
        return [*self._parameters, *self._modules]

    def device(self) -> torch.device:
        return next(self.parameters()).device

    def tree(self) -> dict:
        """The nested dict (and lists) of this tree's tensors."""
        def unwrap(node):
            if isinstance(node, ParamTree):
                return node.tree()
            if isinstance(node, (nn.ParameterList, nn.ModuleList)):
                return [unwrap(v) for v in node]
            return node
        return {key: unwrap(self[key]) for key in self.keys()}

    def rebuild(self, device, mesh=None) -> "ParamTree":
        """This tree's model made again by its family's init (the ``build``
        an init function attached, with its config) on ``device`` and cut
        for ``mesh``: how a dry run builds a rank's blocks, which
        ``Module.to_empty`` would strip of their ``.spec`` tags."""
        return self.build(device=device, mesh=mesh)


def _map_named(fn, tree, prefix: str = ""):
    """``tree`` (dicts and lists of tensors) with each tensor replaced by
    ``fn(name, tensor)``, named as ``named_parameters`` names it."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(fn, v, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def layout_of(specs: dict, tree: ParamTree, mesh) -> dict:
    """``specs`` (by parameter name) as a rank of ``mesh`` holds ``tree``'s
    parameters: axes the mesh lacks and dimensions their axes do not divide
    replicate (``elastic``'s rule)."""
    from repro_torch.distributed.elastic import _filter_spec_for

    return {name: _filter_spec_for(mesh, tuple(specs[name]), tuple(p.shape))
            for name, p in tree.named_parameters()}


def cut_param_tree(whole: ParamTree, layout: dict, mesh) -> ParamTree:
    """This rank's :class:`ParamTree` on ``mesh``: every parameter of
    ``whole`` cut to the rank's block by ``layout`` (filtered specs, by
    name; ``sharding.block_of``), copied, and tagged with its ``.spec`` and
    ``.mesh``; the tree's ``mesh`` is ``mesh``. ``whole`` itself when no
    parameter splits. Every rank of the mesh calls this with the same
    tree; no collective runs."""
    from repro_torch.distributed.sharding import block_of

    if not any(any(part is not None for part in spec) for spec in layout.values()):
        return whole
    with torch.no_grad():
        tree = _map_named(lambda name, p: block_of(p.detach(), layout[name], mesh).clone(),
                          whole.tree())
    local = ParamTree(tree, requires_grad=next(whole.parameters()).requires_grad)
    for name, p in local.named_parameters():
        p.spec, p.mesh = layout[name], mesh
    local.mesh = mesh
    for key in ("cfg", "build"):
        if hasattr(whole, key):
            setattr(local, key, getattr(whole, key))
    return local


def gather_param_tree(local: ParamTree) -> ParamTree:
    """The whole :class:`ParamTree` of a rank's blocks, gathered over the
    mesh in rank order (every rank calls this; each gets it); ``local``
    itself when it holds no blocks."""
    from repro_torch.distributed.sharding import gather_tree

    if local.mesh is None:
        return local
    named = dict(local.named_parameters())
    whole = gather_tree({n: p.detach() for n, p in named.items()},
                        {n: p.spec for n, p in named.items()}, local.mesh)
    out = ParamTree(_map_named(lambda name, p: whole[name], local.tree()),
                    requires_grad=next(local.parameters()).requires_grad)
    for key in ("cfg", "build"):
        if hasattr(local, key):
            setattr(out, key, getattr(local, key))
    return out


def flat_specs(tree, prefix: str = "") -> dict:
    """A spec tree of a :class:`ParamTree`'s shape (dicts, lists; a tuple is
    a spec) as ``{parameter name: spec}``, named as ``named_parameters``
    names them (``blocks.0.wq``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(flat_specs(value, f"{prefix}.{key}" if prefix else key))
    return out


def as_input(params: ParamTree, a, dtype=None) -> torch.Tensor:
    """A batch entry (numpy or tensor) as a tensor on ``params``' device,
    cast to ``dtype`` when given."""
    t = torch.as_tensor(a, device=params.device())
    return t if dtype is None else t.to(dtype)
