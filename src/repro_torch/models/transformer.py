"""Decoder-only LM transformer covering the five LM architectures.

The reference's ``models/transformer.py`` as ``torch.nn.Module``s and the
same functions over them: ``transformer_logits`` and ``prefill`` over a
prompt, ``make_cache`` and ``decode_step`` for serving,
``transformer_loss`` for training, ``count_params`` and
``count_active_params``. Feature matrix:

- GQA attention with optional QK-norm (qwen3-1.7b, qwen3-8b);
- MLA latent attention with absorbed decode (minicpm3-4b);
- MoE FFN (``models/moe.py``): top-k routed experts, optional shared
  experts and a leading run of dense layers (deepseek-moe-16b), optional
  parallel dense residual FFN (arctic-480b).

Attention runs through the port's kernels on the card: K8
(``kernels/flash_attention``) where the reference calls
``chunked_attention``, and K9 (``kernels/decode_attention``) where it calls
``decode_attention_xla``. MLA's prefill pads its head dims into one of K8's
(:func:`_mla_flash`); MLA's absorbed decode attends in latent space with
plain torch products, as the reference does with XLA einsums: K9 takes
neither its width nor its unequal key and value dims, so that path has no
kernel by design. ``use_kernel=None`` takes the kernels when the model lies
on a CUDA device and the plain functions of ``models/layers.py`` on the
CPU; ``use_kernel=False`` runs the plain functions on the card, and
``use_kernel=True`` on the CPU raises.

On a mesh (``distributed.sharding.use_mesh``), every rank runs these
functions on its local tensors. ``moe_impl="ep"`` under a mesh with a
``model`` axis runs ``moe_ffn_ep`` (experts split over ``model``); the
loss normalises by the global token count; and a cache made with
``make_cache(mesh=, seq_axes=)`` holds the rank's slice of the sequence:
:func:`decode_step` then runs K9's partials over the slice and merges the
ranks' partials in rank order (the reference's sequence-parallel decode,
where GSPMD turns the softmax's reductions into all-reduces: the paper's
vertical accumulation of partial scores, over the sequence).

A rank's model on a mesh, ``Transformer(cfg, device, mesh)`` (or
``init_transformer(mesh=)``, ``shard_transformer``, ``interop`` with
``mesh=``), holds its blocks of the reference's ``param_specs``
(:func:`layout_specs`), plain local tensors whose collectives go through
``core.distributed`` in rank order. Over ``model``: the q/k/v projections
by head rows and ``wo`` by columns (Megatron's column- then row-parallel
pair: the input's gradient summed over ``model`` on the way in, the
partial outputs summed over ``model`` on the way out), MLA's per-head
``wq_b``/``wkv_b`` likewise, FFN columns then rows (the shared experts and
the dense residual too), the experts (``moe_ffn_ep`` on the rank's
experts), the embedding's width (all-gathered after the lookup) and the
head's vocab (logits all-gathered for a caller; a vocab-parallel
log-sum-exp in the loss). K8 runs on the rank's heads. Heads split only
whole (``sharding.HeadLayout``): where ``model`` does not divide them the
q heads, and where needed whole kv groups, are zero-padded to a count it
does (zero rows of ``wq``/``wq_b``/``wkv_b`` and ``wk``/``wv``, zero
columns of ``wo``), and each rank holds only the kv heads its q heads
read, one kv head shared by the ranks of its group with its gradient
summed over them (:func:`layout_specs`, :func:`layout_replications`). A
padded head's output is masked to exactly zero before ``wo``, so its
weights, gradients and AdamW moments stay exactly zero; trees that leave
the ranks (:func:`unshard_transformer`, ``interop``, the checkpoints) are
the reference's, unpadded. Decode keeps the reference's cache specs (the
sequence over ``model``) and head geometry: each layer all-gathers the
ranks' q heads and new k/v rows in one collective and drops the padding
and the repeated kv heads, K9's partials run over the rank's sequence
block for every head, and after the merge each rank keeps its heads of
``o`` (zeros for its padded ones) for ``wo``. With ``cfg.fsdp`` each
matrix's other dimension (``param_specs``' ``("pod", "data")``) is split
over the data axes too and gathered before use
(``sharding.weight_for_use``), its gradient reduce-scattered back in rank
order. A model built whole runs as before on every rank.

Training (:func:`transformer_loss`) attends through the plain
``chunked_attention`` on every device, as the reference trains through
XLA: K8 and K9 have no backward pass, and their wrappers raise on inputs
that require a gradient. With ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so a
block's forward runs again in the backward pass: a block returns its MoE
statistics instead of recording them, and does nothing else a second run
would repeat. The serving functions run under ``torch.no_grad``; the
parameters are built without ``requires_grad``, which the trainer turns on.

Weights are ``nn.Linear`` weights ``(d_out, d_in)``: the transpose of the
reference's ``(d_in, d_out)`` matrices (``interop`` carries them across);
the expert stacks keep the reference's orientation. The cache is written in
place (see :func:`decode_step`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.precision import exact_f32
from repro_torch.distributed.elastic import _filter_spec_for
from repro_torch.distributed.sharding import (
    HeadLayout,
    active_mesh,
    axis_sizes,
    cut_tree,
    data_axes,
    gather_tree,
    local_shape,
    use_mesh,
    weight_for_use,
)
from repro_torch.interop import device_of
from repro_torch.kernels.decode_attention.ops import (
    combine_partials,
    decode_attention,
    decode_attention_partials,
)
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (
    NEG_LARGE,
    apply_rope,
    chunked_attention,
    decode_attention_xla,
    dense_init,
    embed_init,
    model_split,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import MoEParams, init_moe, moe_ffn, moe_ffn_ep, moe_param_specs


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    attention: str = "gqa"          # "gqa" | "mla"
    qk_norm: bool = False
    rope_theta: float = 1e6
    # MLA dims (minicpm3/deepseek style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    first_k_dense: int = 0          # deepseek: leading dense layers
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    moe_impl: str = "gspmd"         # "gspmd" | "ep" (moe_ffn_ep under a mesh with "model")
    # numerics / memory
    dtype: Any = torch.bfloat16
    remat: bool = True              # training: recompute each block in the backward
    q_chunk: int = 512              # the plain path's attention chunks
    kv_chunk: int = 1024
    loss_chunk: int = 2048          # training: sequence positions per logits chunk
    bf16_probs: bool = False        # plain path only (K8 raises)
    grad_accum: int = 1             # training: microbatches per step
    # parallelism
    fsdp: bool = False              # param_specs over ("pod", "data") (a rank's Transformer(mesh=))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (padded ids are never emitted as labels)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def qk_head_dim(self) -> int:
        if self.attention == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.attention == "mla" else self.head_dim


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _linear(d_in: int, d_out: int, cfg: TransformerConfig, device) -> nn.Linear:
    return torch.nn.utils.skip_init(
        nn.Linear, d_in, d_out, bias=False, device=device, dtype=cfg.dtype
    )


def _ones(n: int, cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=cfg.dtype, device=device), requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = _linear(d, cfg.n_heads * hd, cfg, device)
        self.wk = _linear(d, cfg.n_kv_heads * hd, cfg, device)
        self.wv = _linear(d, cfg.n_kv_heads * hd, cfg, device)
        self.wo = _linear(cfg.n_heads * hd, d, cfg, device)
        if cfg.qk_norm:
            self.q_scale = _ones(hd, cfg, device)
            self.k_scale = _ones(hd, cfg, device)


class MLAAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        self.wq_a = _linear(d, cfg.q_lora_rank, cfg, device)
        self.q_norm = _ones(cfg.q_lora_rank, cfg, device)
        self.wq_b = _linear(cfg.q_lora_rank, h * cfg.qk_head_dim, cfg, device)
        self.wkv_a = _linear(d, cfg.kv_lora_rank + cfg.qk_rope_dim, cfg, device)
        self.kv_norm = _ones(cfg.kv_lora_rank, cfg, device)
        self.wkv_b = _linear(cfg.kv_lora_rank, h * (cfg.qk_nope_dim + cfg.v_head_dim), cfg,
                             device)
        self.wo = _linear(h * cfg.v_head_dim, d, cfg, device)


class FFN(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, d_ff: int | None = None):
        super().__init__()
        f = cfg.d_ff if d_ff is None else d_ff
        self.w_gate = _linear(cfg.d_model, f, cfg, device)
        self.w_up = _linear(cfg.d_model, f, cfg, device)
        self.w_down = _linear(f, cfg.d_model, cfg, device)


class MoEFFN(nn.Module):
    """Routed experts, plus the shared experts (one SwiGLU of width
    ``n_shared_experts · d_ff_expert``) and the dense residual (width
    ``d_ff``) where the config has them."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.moe = MoEParams(cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.dtype, device)
        self.shared = (FFN(cfg, device, cfg.n_shared_experts * cfg.d_ff_expert)
                       if cfg.n_shared_experts else None)
        self.dense = FFN(cfg, device) if cfg.dense_residual else None


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, *, dense_only: bool = False):
        super().__init__()
        self.attn_norm = _ones(cfg.d_model, cfg, device)
        self.attn = (MLAAttention if cfg.attention == "mla" else Attention)(cfg, device)
        self.ffn_norm = _ones(cfg.d_model, cfg, device)
        self.ffn = MoEFFN(cfg, device) if cfg.moe and not dense_only else FFN(cfg, device)


class Transformer(nn.Module):
    """The parameters of a transformer, uninitialised (norms are ones):
    ``dense_layers`` (the first ``first_k_dense`` blocks, dense FFNs of width
    ``d_ff``) ahead of ``layers`` (the other blocks), as the reference's
    ``init_transformer`` builds them. :func:`init_transformer` and
    ``interop`` fill them."""

    def __init__(self, cfg: TransformerConfig, device, mesh=None):
        super().__init__()
        if cfg.attention not in ("gqa", "mla"):
            raise ValueError(f"unknown attention {cfg.attention!r}")
        self.cfg = cfg
        specs = layout_specs(cfg, mesh) if mesh is not None else None
        cut = specs is not None and any(any(part is not None for part in spec)
                                        for spec in specs.values())
        self.mesh = mesh if cut else None
        final_device, device = device, ("meta" if cut else device)
        self.embed = nn.Parameter(
            torch.empty(cfg.padded_vocab, cfg.d_model, dtype=cfg.dtype, device=device),
            requires_grad=False,
        )
        self.dense_layers = nn.ModuleList(
            Block(cfg, device, dense_only=True) for _ in range(cfg.first_k_dense))
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers - cfg.first_k_dense))
        self.final_norm = _ones(cfg.d_model, cfg, device)
        self.lm_head = _linear(cfg.d_model, cfg.padded_vocab, cfg, device)
        if cut:
            self._cut(specs, mesh, final_device)
        self.requires_grad_(False)

    def blocks(self):
        """Every block in order: the dense ones, then the others."""
        return [*self.dense_layers, *self.layers]

    def _cut(self, specs: dict, mesh, device) -> None:
        """Replace every parameter by an empty one of this rank's block
        (``local_shape`` of its layout spec) on ``device``, tagged with its
        spec and mesh (``sharding.weight_for_use``), and give each attention,
        FFN and MoE module its :class:`Cut`."""
        dev = device_of(device) if device != "meta" else torch.device("meta")
        for name, p in list(self.named_parameters()):
            owner_name, _, leaf = name.rpartition(".")
            owner = self.get_submodule(owner_name) if owner_name else self
            local = nn.Parameter(torch.empty(local_shape(tuple(p.shape), specs[name], mesh),
                                             dtype=p.dtype, device=dev), requires_grad=False)
            local.spec, local.mesh = specs[name], mesh
            setattr(owner, leaf, local)
        m = axis_sizes(mesh).get("model", 1)
        me = mesh.get_local_rank("model") if m > 1 and hasattr(mesh, "get_local_rank") else 0
        cfg = self.cfg
        attn = Cut(mesh, m > 1, _head_geometry(cfg, m, me))
        for blk in self.blocks():
            blk.attn.cut = attn
            ffns = [blk.ffn] if isinstance(blk.ffn, FFN) else \
                [f for f in (blk.ffn.shared, blk.ffn.dense) if f is not None]
            for f in ffns:
                f.cut = Cut(mesh, model_split(f.w_down.weight, 1))
            if isinstance(blk.ffn, MoEFFN):
                blk.ffn.moe.cut = Cut(mesh, model_split(blk.ffn.moe.w_gate, 0))


@dataclasses.dataclass(frozen=True)
class Heads:
    """An attention module's heads on one rank of ``model`` (every head, on
    a model built whole): ``q`` the q head of each head the rank holds, in
    order, from padded place ``q0``, and ``kv`` the kv head of each kv head
    it holds (``-1`` a zero head: padding); ``shared`` the ``model`` places
    that hold its kv heads too, itself included (``()`` when no other
    does); ``q_keep`` and ``kv_keep`` where each q and kv head lies among
    every rank's held heads gathered in rank order (a decode step's
    gather drops the padding and the repeated kv heads by them)."""

    q: tuple
    q0: int
    kv: tuple
    shared: tuple = ()
    q_keep: tuple = ()
    kv_keep: tuple = ()

    @property
    def hq(self) -> int:
        return len(self.q)

    @property
    def hkv(self) -> int:
        return len(self.kv)

    @property
    def zeros(self) -> int:
        """How many of the rank's q heads are padding."""
        return sum(h < 0 for h in self.q)


@dataclasses.dataclass(frozen=True)
class Cut:
    """How one module of a rank's :class:`Transformer` is cut over the
    mesh's ``model`` axis: ``split`` when its model dimension (attention
    heads, FFN columns, experts) is; an attention module's ``heads`` are
    its :class:`Heads`."""

    mesh: Any
    split: bool
    heads: Heads | None = None


_HEAD_LEAVES = ("wq", "wk", "wv", "wo", "wq_b", "wkv_b")


def _head_layout(cfg: TransformerConfig, m: int) -> HeadLayout | None:
    """The heads over ``m`` model ranks (``None`` for one): MLA's kv heads
    are its q heads (one latent per head, no groups)."""
    if m == 1:
        return None
    hkv = cfg.n_heads if cfg.attention == "mla" else cfg.n_kv_heads
    return HeadLayout.of(cfg.n_heads, hkv, m)


def _head_width(cfg: TransformerConfig, leaf: str) -> int:
    """Elements of one head in an attention weight's ``model`` dimension."""
    if leaf == "wq_b":
        return cfg.qk_head_dim
    if leaf == "wkv_b":
        return cfg.qk_nope_dim + cfg.v_head_dim
    return cfg.v_dim if leaf == "wo" else cfg.head_dim


def _head_geometry(cfg: TransformerConfig, m: int, me: int) -> Heads:
    """:class:`Cut`'s ``heads`` for the rank at place ``me`` of ``m``."""
    lay = _head_layout(cfg, m)
    if lay is None:
        hkv = cfg.n_heads if cfg.attention == "mla" else cfg.n_kv_heads
        return Heads(tuple(range(cfg.n_heads)), 0, tuple(range(hkv)))
    shared = lay.sharers(me)
    return Heads(lay.q_heads(me), me * lay.q_per_rank, lay.kv_heads(me),
                 shared if len(shared) > 1 else (),
                 tuple(lay.q_blocks(1).gathered_rows()), tuple(lay.kv_blocks(1).gathered_rows()))


def layout_specs(cfg: TransformerConfig, mesh) -> dict:
    """:func:`param_specs` as a rank of ``mesh`` holds the parameters:
    axes the mesh lacks and dimensions their axes do not divide replicate
    (``elastic``'s rule), and attention weights split only whole heads
    (:func:`_head_layout`): where ``model`` does not split them evenly the
    weight's ``model`` entry is a ``HeadBlocks`` of the rank's padded q
    heads (``wq``, ``wo``, ``wq_b``, ``wkv_b``) or of the kv heads its q
    heads read (``wk``, ``wv``)."""
    lay = _head_layout(cfg, axis_sizes(mesh).get("model", 1))
    base = param_specs(cfg)
    out = {}
    for name, p in Transformer(cfg, "meta").named_parameters():
        spec, parts = base[name], name.split(".")
        leaf = parts[-2] if parts[-1] == "weight" else parts[-1]
        if lay is not None and "attn" in parts and leaf in _HEAD_LEAVES:
            kv = leaf in ("wk", "wv")
            if not (lay.even_kv if kv else lay.even_q):
                blocks = (lay.kv_blocks if kv else lay.q_blocks)(_head_width(cfg, leaf))
                spec = tuple(blocks if part == "model" else part for part in spec)
        out[name] = _filter_spec_for(mesh, spec, tuple(p.shape))
    return out


def layout_replications(cfg: TransformerConfig, mesh) -> dict:
    """``{name: reason}`` of the parameters whose layout spec
    (:func:`layout_specs`) holds more than ``local_shape`` of
    :func:`param_specs` would place on a rank: whole heads where ``model``
    does not split them evenly (zero heads padding a rank's block, a kv
    head the ranks of its group each hold)."""
    m = axis_sizes(mesh).get("model", 1)
    lay = _head_layout(cfg, m)
    layout, base = layout_specs(cfg, mesh), param_specs(cfg)
    out = {}
    for name, p in Transformer(cfg, "meta").named_parameters():
        shape = tuple(p.shape)
        held, even = (torch.Size(local_shape(shape, spec[name], mesh)).numel()
                      for spec in (layout, base))
        if held <= even:
            continue
        if name.split(".")[-2] in ("wk", "wv"):
            why = [f"{cfg.n_kv_heads} kv heads over model={m}: a rank holds the "
                   f"{lay.kv_per_rank} its q heads read"]
            if lay.hkv_pad > lay.hkv:
                why.append(f"{lay.hkv_pad - lay.hkv} zero kv groups")
            if len(lay.sharers(0)) > 1:
                why.append(f"one whole kv head shared by {len(lay.sharers(0))} ranks")
            out[name] = ", ".join(why)
        else:
            out[name] = (f"{cfg.n_heads} q heads zero-padded to {lay.hkv_pad * lay.g_pad} "
                         f"over model={m}: {lay.q_per_rank} a rank")
    return out


def shard_transformer(model: Transformer, mesh, *, device=None) -> Transformer:
    """This rank's :class:`Transformer` on ``mesh``: every parameter of a
    whole ``model`` cut to the rank's block (:func:`layout_specs`), copied
    to ``device`` (``model``'s by default). Every rank of the mesh calls
    this with the same model."""
    cfg = model.cfg
    local = Transformer(cfg, model.embed.device if device is None else device, mesh)
    if local.mesh is None:
        return model if device is None else model.to(device_of(device))
    blocks = cut_tree(dict(model.named_parameters()), layout_specs(cfg, mesh), mesh)
    with torch.no_grad():
        for name, p in local.named_parameters():
            p.copy_(blocks[name])
    return local


def unshard_transformer(model: Transformer) -> Transformer:
    """The whole :class:`Transformer` of a rank's one, its blocks gathered
    over the mesh in rank order (every rank calls this; each gets it)."""
    if model.mesh is None:
        return model
    full = Transformer(model.cfg, model.embed.device)
    specs = {name: p.spec for name, p in model.named_parameters()}
    whole = gather_tree({n: p.detach() for n, p in model.named_parameters()}, specs, model.mesh)
    with torch.no_grad():
        for name, p in full.named_parameters():
            p.copy_(whole[name])
    return full


def init_transformer(
    cfg: TransformerConfig,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> Transformer:
    """A model with the reference's init laws, drawn from ``generator`` (on
    ``device``; seed 0 when omitted): matrices normal × √(2/(d_in+d_out)),
    the router likewise in f32, the embedding 0.02 × normal, norms ones.
    Torch's generators give other numbers than ``jax.random``; ``interop``
    carries a JAX model across. With a ``mesh`` (every rank calls this) the
    whole model is drawn and cut to the rank's blocks
    (:func:`shard_transformer`), so the ranks hold one model."""
    if mesh is not None:
        whole = init_transformer(cfg, generator=generator, device=device)
        return shard_transformer(whole, mesh)
    dev = device_of(device)
    model = Transformer(cfg, dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)

    with torch.no_grad():
        model.embed.copy_(embed_init(generator, cfg.padded_vocab, cfg.d_model, cfg.dtype, dev))
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                d_out, d_in = mod.weight.shape
                mod.weight.copy_(dense_init(generator, d_in, d_out, cfg.dtype, dev).T)
            elif isinstance(mod, MoEParams):
                fresh = init_moe(generator, cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                                 cfg.dtype, dev)
                mod.load_state_dict(fresh.state_dict())
    return model


def count_params(cfg: TransformerConfig) -> int:
    """Parameters of the model ``cfg`` describes (built on the meta device,
    so a config of any size allocates nothing)."""
    return sum(p.numel() for p in Transformer(cfg, "meta").parameters())


def count_active_params(cfg: TransformerConfig) -> int:
    """Active params per token (MoE: top_k + shared of the routed pool)."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    n_scanned = cfg.n_layers - cfg.first_k_dense
    routed_all = n_scanned * cfg.n_experts * per_expert
    routed_active = n_scanned * cfg.top_k * per_expert
    return total - routed_all + routed_active


def param_specs(cfg: TransformerConfig) -> dict:
    """The reference's parameter layout (``param_specs``: tensor parallel
    over ``model``, + FSDP over ``("pod", "data")`` with ``cfg.fsdp``) as the
    port's specs, keyed by :class:`Transformer`'s parameter names.
    ``nn.Linear`` weights are the transpose of the reference's matrices, so
    their specs are reversed; the reference's stacked ``layers`` dim is one
    module a layer here. A rank's ``Transformer(cfg, device, mesh)`` holds
    its block of each parameter by :func:`layout_specs` of these."""
    f = ("pod", "data") if cfg.fsdp else None
    specs = {}
    for name, p in Transformer(cfg, "meta").named_parameters():
        parts = name.split(".")
        leaf = parts[-2] if parts[-1] == "weight" else parts[-1]
        if name == "embed":
            spec = (None, "model")
        elif name == "lm_head.weight":
            spec = ("model", None)
        elif p.dim() == 1:
            spec = (None,)
        elif "moe" in parts:
            spec = moe_param_specs(cfg.fsdp)[leaf]
        elif leaf in ("wq_a", "wkv_a"):
            spec = (None, f)
        elif leaf in ("wo", "w_down"):
            spec = (f, "model")
        else:                                   # wq wk wv wq_b wkv_b w_gate w_up
            spec = ("model", f)
        specs[name] = spec
    return specs


def cache_specs(cfg: TransformerConfig, *, seq_axes=("model",),
                batch_axes=("pod", "data")) -> dict:
    """The cache's specs (the reference's ``cache_specs``): batch over
    ``batch_axes``, sequence over ``seq_axes``; keys as :func:`make_cache`'s."""
    seq, bat = tuple(seq_axes) or None, tuple(batch_axes) or None
    if cfg.attention == "mla":
        specs = {"c_kv": (None, bat, seq, None), "k_pe": (None, bat, seq, None)}
    else:
        specs = {"k": (None, bat, None, seq, None), "v": (None, bat, None, seq, None)}
    if cfg.first_k_dense:
        specs.update({f"dense_{key}": spec for key, spec in list(specs.items())})
    specs["length"] = (bat,)
    return specs


def _use_kernel(use_kernel: bool | None, device: torch.device) -> bool:
    on_card = device.type == "cuda"
    if use_kernel is None:
        return on_card
    if use_kernel and not on_card:
        raise ValueError(
            "use_kernel=True needs the model on a CUDA device; on the CPU the "
            "plain path runs (use_kernel=None or False)"
        )
    return bool(use_kernel)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _cut_of(p):
    return getattr(p, "cut", None)


def _lin(layer: nn.Linear, x):
    """``layer(x)`` on the weight as the rank uses it (FSDP blocks gathered)."""
    return F.linear(x, weight_for_use(layer.weight))


def _enter(x, cut: Cut | None):
    """Megatron's ``f``: ``x`` (alike on every ``model`` rank) entering a
    module split over ``model``; the backward sums its gradient there."""
    if cut is None or not cut.split:
        return x
    from repro_torch.core.distributed import enter_replicated

    return enter_replicated(x, cut.mesh, ("model",))


def _row_parallel(weight: torch.Tensor, x, cut: Cut | None):
    """``x · weightᵀ`` where ``weight`` holds the rank's input columns
    (``wo``, ``w_down``): Megatron's ``g``. Each rank's partial product is
    taken in f32 and the partials added over ``model`` in rank order in
    f32 (the gradient passes), then rounded once to ``x``'s dtype, as one
    rank's product accumulates in f32 and rounds once."""
    w = weight_for_use(weight)
    if cut is None or not cut.split:
        return F.linear(x, w)
    from repro_torch.core.distributed import psum_replicated

    y = torch.matmul(x.float(), w.float().T)
    return psum_replicated(y, cut.mesh, ("model",)).to(x.dtype)


def _heads(p, cfg: TransformerConfig) -> Heads:
    """The :class:`Heads` of an attention module on this rank (every head
    without a cut)."""
    cut = _cut_of(p)
    return _head_geometry(cfg, 1, 0) if cut is None else cut.heads


def _kv_weight(layer: nn.Linear, cut):
    """``wk``/``wv`` as the rank uses it: its block of the kv heads its q
    heads read; a kv head that the ranks of its group each hold enters with
    its gradient summed over them in rank order (each rank's q heads use
    it their own way)."""
    w = weight_for_use(layer.weight)
    if cut is None or not cut.split or not cut.heads.shared:
        return w
    from repro_torch.core.distributed import enter_shared

    return enter_shared(w, cut.mesh, ("model",), cut.heads.shared)


def _zero_padded(o: torch.Tensor, heads: Heads, dim: int) -> torch.Tensor:
    """``o`` with the rank's padded heads (along ``dim``) exactly zero: a
    padded GQA head reads a real kv head (its scores are 0, so it outputs
    the mean of ``v``), and MLA's its shared rope key; masked, nothing
    flows into ``wo``'s zero columns or back into the padding."""
    if not heads.zeros:
        return o
    pad = torch.tensor([h < 0 for h in heads.q], device=o.device)
    return o.masked_fill(pad.reshape(*[1] * dim, -1, *[1] * (o.dim() - dim - 1)), 0.0)


def _gqa_qkv(p: Attention, cfg: TransformerConfig, x, positions):
    b, s, _ = x.shape
    cut = _cut_of(p)
    heads = _heads(p, cfg)
    x = _enter(x, cut)
    q = _lin(p.wq, x).reshape(b, s, heads.hq, cfg.head_dim)
    k = F.linear(x, _kv_weight(p.wk, cut)).reshape(b, s, heads.hkv, cfg.head_dim)
    v = F.linear(x, _kv_weight(p.wv, cut)).reshape(b, s, heads.hkv, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, _enter(p.q_scale, cut))
        k = rms_norm(k, _enter(p.k_scale, cut))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mla_qkv(p: MLAAttention, cfg: TransformerConfig, x, positions):
    """MLA projections (prefill path, explicit K/V): q, k ``(B, S, H,
    qk_head_dim)``, v ``(B, S, H, v_head_dim)``, ``H`` the rank's heads. The
    latent projections (``wq_a``, ``wkv_a``) are whole on every rank, the
    per-head ones (``wq_b``, ``wkv_b``) the rank's rows."""
    b, s, _ = x.shape
    cut = _cut_of(p)
    h = _heads(p, cfg).hq
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cq = rms_norm(_lin(p.wq_a, x), p.q_norm)
    q = _lin(p.wq_b, _enter(cq, cut)).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    kv_a = _lin(p.wkv_a, x)
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank], p.kv_norm)
    k_pe = apply_rope(kv_a[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                      cfg.rope_theta)  # one shared head
    kv = _lin(p.wkv_b, _enter(c_kv, cut)).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, _enter(k_pe, cut).expand(b, s, h, dr)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    return q, k, v


def _mla_flash(q, k, v, *, scale: float) -> torch.Tensor:
    """K8 on MLA's unequal head dims: q and k ``(B, H, S, Dqk)`` and v
    ``(B, H, S, Dv)`` zero-padded to the smallest of K8's head dims that
    holds both, ``scale`` passed as it is (K8's default would take the
    padded dim), the output sliced back to ``Dv``. Zero products add exact
    zeros, so the padding changes no score; a shape no head dim holds
    raises."""
    dqk, dv = q.shape[-1], v.shape[-1]
    fits = [d for d in HEAD_DIMS if d >= max(dqk, dv)]
    if not fits:
        raise ValueError(f"K8 takes head dims {HEAD_DIMS}; MLA needs {max(dqk, dv)}")
    d = fits[0]
    q, k, v = (F.pad(a, (0, d - a.shape[-1])) for a in (q, k, v))
    return flash_attention(q, k, v, causal=True, scale=scale)[..., :dv]


def _attention(p, cfg: TransformerConfig, x, positions, use_kernel: bool):
    b, s, _ = x.shape
    qkv = _mla_qkv(p, cfg, x, positions) if cfg.attention == "mla" else \
        _gqa_qkv(p, cfg, x, positions)
    q, k, v = (a.transpose(1, 2) for a in qkv)  # (B, H, S, D)
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    if use_kernel:
        if cfg.bf16_probs:
            raise ValueError("K8 has no bf16 probabilities: bf16_probs runs the plain path")
        if cfg.attention == "mla":
            o = _mla_flash(q, k, v, scale=scale)
        else:
            o = flash_attention(q, k, v, causal=True, scale=scale)
    else:
        o = chunked_attention(
            q, k, v, causal=True, scale=scale,
            q_chunk=min(cfg.q_chunk, s), kv_chunk=min(cfg.kv_chunk, s),
            probs_dtype=torch.bfloat16 if cfg.bf16_probs else None,
        )
    heads = _heads(p, cfg)
    o = _zero_padded(o, heads, 1).transpose(1, 2).reshape(b, s, heads.hq * cfg.v_dim)
    return _row_parallel(p.wo.weight, o, _cut_of(p))


def _swiglu(p: FFN, x):
    """SwiGLU (``layers.swiglu``), column-parallel then row-parallel on a
    rank's block."""
    cut = _cut_of(p)
    if cut is None or not cut.split:
        return swiglu(x, weight_for_use(p.w_gate.weight).T, weight_for_use(p.w_up.weight).T,
                      weight_for_use(p.w_down.weight).T)
    x = _enter(x, cut)
    g, u = _lin(p.w_gate, x), _lin(p.w_up, x)
    return _row_parallel(p.w_down.weight, F.silu(g.float()).to(x.dtype) * u, cut)


def _ffn(p, cfg: TransformerConfig, x):
    """FFN: dense, or MoE (+ shared experts / + dense residual); returns
    ``(y, stats)``, ``stats`` the MoE call's ``MoEOut`` without ``y`` (aux
    loss, drops) or ``None``. The MoE runs over the ``B·S`` flattened
    tokens, so its capacity follows them; with ``moe_impl="ep"`` under a
    mesh with a ``model`` axis it is ``moe_ffn_ep`` over the rank's tokens,
    as the reference's ``_ffn``; a rank that holds only its experts
    (``Transformer(mesh=)``) runs ``moe_ffn_ep`` on them whatever
    ``moe_impl`` says. Else, on a mesh, each rank routes its own tokens by
    ``moe_ffn``."""
    if isinstance(p, FFN):
        return _swiglu(p, x), None
    b, s, d = x.shape
    mesh, cut = active_mesh(), _cut_of(p.moe)
    if cut is not None and cut.split:
        out = moe_ffn_ep(p.moe, x.reshape(b * s, d), top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, mesh=cut.mesh,
                         data_axes=tuple(a for a in ("pod", "data")
                                         if a in axis_sizes(cut.mesh)))
    elif cfg.moe_impl == "ep" and "model" in axis_sizes(mesh):
        out = moe_ffn_ep(p.moe, x.reshape(b * s, d), top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, mesh=mesh,
                         data_axes=data_axes())
    else:
        out = moe_ffn(p.moe, x.reshape(b * s, d), top_k=cfg.top_k,
                      capacity_factor=cfg.capacity_factor)
    y = out.y.reshape(b, s, d)
    if p.shared is not None:
        y = y + _swiglu(p.shared, x)
    if p.dense is not None:
        y = y + _swiglu(p.dense, x)
    return y, out._replace(y=None)


def _block(p: Block, cfg: TransformerConfig, x, positions, use_kernel: bool):
    """One block; returns ``(x, stats)`` (see :func:`_ffn`). It has no side
    effect, so that a checkpointed block may run twice."""
    h = x + _attention(p.attn, cfg, rms_norm(x, p.attn_norm), positions, use_kernel)
    f, stats = _ffn(p.ffn, cfg, rms_norm(h, p.ffn_norm))
    return h + f, stats


def _block_on(mesh, p: Block, cfg: TransformerConfig, x, positions, use_kernel: bool):
    """:func:`_block` under ``use_mesh(mesh)``: a checkpointed block runs
    again in the backward pass, and on a CUDA device autograd runs it in
    its own thread, which does not see the forward thread's mesh."""
    with use_mesh(mesh):
        return _block(p, cfg, x, positions, use_kernel)


def _backbone(params: Transformer, cfg: TransformerConfig, tokens, use_kernel: bool,
              moe_stats: list | None = None, remat: bool = False):
    """Embed + all blocks + final norm → ``(hidden states (B, S, d), aux)``,
    ``aux`` the f32 sum of the MoE layers' aux losses (0 without MoE).
    ``moe_stats``, a list, receives each MoE layer's stats in layer order;
    ``remat`` checkpoints each block."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    x = _embed(params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blk in params.blocks():
        if remat:
            x, stats = checkpoint(_block_on, active_mesh(), blk, cfg, x, positions,
                                  use_kernel, use_reentrant=False)
        else:
            x, stats = _block(blk, cfg, x, positions, use_kernel)
        if stats is not None:
            aux = aux + stats.aux_loss
            if moe_stats is not None:
                moe_stats.append(stats)
    return rms_norm(x, params.final_norm), aux


def _tokens(params: Transformer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device)


def _embed(params: Transformer, tokens) -> torch.Tensor:
    """Token embeddings ``(…, d)``: a rank holding ``d / p`` columns
    (``(None, "model")``) looks its columns up and all-gathers the width
    over ``model``."""
    x = F.embedding(tokens.long(), weight_for_use(params.embed))
    if model_split(params.embed, 1):
        from repro_torch.core.distributed import gather_replicated

        x = gather_replicated(x, params.mesh, ("model",), x.dim() - 1)
    return x


def _whole_vocab(params: Transformer, logits: torch.Tensor) -> torch.Tensor:
    """Logits whose vocab ``lm_head`` splits over ``model``, all-gathered to
    the whole vocab (every rank gets them)."""
    if not model_split(params.lm_head.weight, 0):
        return logits
    from repro_torch.core.distributed import gather_replicated

    return gather_replicated(logits, params.mesh, ("model",), logits.dim() - 1)


@torch.no_grad()
def transformer_logits(
    params: Transformer, cfg: TransformerConfig, tokens, *, use_kernel: bool | None = None
) -> torch.Tensor:
    """Full logits ``(B, S, V)`` in the model's dtype (small configs, tests
    and parity runs: O(B·S·V) memory)."""
    exact_f32()
    tokens = _tokens(params, tokens)
    x, _ = _backbone(params, cfg, tokens, _use_kernel(use_kernel, tokens.device))
    return _whole_vocab(params, _lin(params.lm_head, x))


def _logits_f32(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """``x · lm_head`` with f32 output: products of the model's dtype summed
    in f32, as the reference's ``preferred_element_type=f32``; the whole
    vocab on every rank."""
    w = weight_for_use(params.lm_head.weight)
    return _whole_vocab(params, torch.matmul(x.float(), w.float().T))


@torch.no_grad()
def prefill(
    params: Transformer, cfg: TransformerConfig, tokens, *, use_kernel: bool | None = None,
    moe_stats: list | None = None,
) -> torch.Tensor:
    """Run the backbone over a prompt ``(B, S)``; last-position logits
    ``(B, V)`` f32. Like the reference, it fills no cache (serving feeds the
    prompt through :func:`decode_step`). ``moe_stats``, a list, receives
    each MoE layer's ``MoEOut`` (``y`` dropped) in layer order."""
    exact_f32()
    tokens = _tokens(params, tokens)
    x, _ = _backbone(params, cfg, tokens, _use_kernel(use_kernel, tokens.device), moe_stats)
    return _logits_f32(params, x[:, -1, :])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _chunk_nll(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Masked next-token NLL summed over one chunk: ``x (B, c, d)`` against
    the head ``w (V, d)`` with f32 logits (products of the model's dtype
    summed in f32, as the reference's ``preferred_element_type=f32``)."""
    logits = torch.matmul(x.float(), w.float().T)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((lse - gold) * mask)


def _chunk_nll_split(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, mesh, vocab_lo: int) -> torch.Tensor:
    """:func:`_chunk_nll` with the head's vocab split over ``model``: the
    rank's logits ``(B, c, V / p)``, their log-sum-exp over the ranks (max,
    then the sum of exponentials in rank order) and the label's logit
    from the rank that holds it; the result is alike on every rank."""
    from repro_torch.core.distributed import (
        enter_replicated,
        vocab_parallel_logsumexp,
        vocab_parallel_pick,
    )

    logits = torch.matmul(enter_replicated(x, mesh, ("model",)).float(), w.float().T)
    lse = vocab_parallel_logsumexp(logits, mesh, "model")
    gold = vocab_parallel_pick(logits, labels, mesh, "model", vocab_lo)
    return torch.sum((lse - gold) * mask)


def transformer_loss(params: Transformer, cfg: TransformerConfig, batch: dict, *,
                     moe_stats: list | None = None):
    """Next-token CE plus ``aux_loss_weight`` × the MoE aux loss; returns
    ``(total, {"ce_loss", "aux_loss", "tokens"})`` as the reference's.

    ``batch["tokens"] (B, S)``; ``labels`` default to the tokens shifted by
    one (0 at the end) and ``loss_mask`` to ones but the last position.
    The CE runs over ``loss_chunk`` positions at a time, each chunk under
    ``torch.utils.checkpoint``: its ``(B, chunk, V)`` f32 logits are made
    again in the backward pass, so one chunk's logits are live at a time.
    Attention takes the plain path on every device (K8 has no backward).
    ``moe_stats``, a list, receives each MoE layer's stats (aux loss,
    ``dropped_frac``) in layer order, from the forward pass only.

    Under a mesh with data axes the batch is the rank's rows, ``tokens``
    the global count (an all-reduce) and ``ce_loss`` the rank's CE sum over
    it times the data ranks: the mean over the data axes is the global CE.
    """
    exact_f32()
    tokens = _tokens(params, batch["tokens"])
    b, s = tokens.shape
    x, aux = _backbone(params, cfg, tokens, False, moe_stats, remat=cfg.remat)
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    labels = _tokens(params, labels).long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
        mask[:, -1] = 0.0
    mask = _tokens(params, mask).float()

    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of loss_chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=tokens.device)
    cnt = torch.zeros((), dtype=torch.float32, device=tokens.device)
    head = weight_for_use(params.lm_head.weight)
    split = model_split(params.lm_head.weight, 0)
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        if split:
            vocab_lo = params.mesh.get_local_rank("model") * head.shape[0]
            tot = tot + checkpoint(_chunk_nll_split, x[:, sl], head, labels[:, sl],
                                   mask[:, sl], params.mesh, vocab_lo, use_reentrant=False)
        else:
            tot = tot + checkpoint(_chunk_nll, x[:, sl], head, labels[:, sl], mask[:, sl],
                                   use_reentrant=False)
        cnt = cnt + torch.sum(mask[:, sl])
    mesh, daxes = active_mesh(), data_axes()
    if daxes:
        # A rank's share of the global CE: its sum over the global count,
        # times the number of data ranks, so that the trainer's mean over
        # the data axes is the global mean
        from repro_torch.core.distributed import _axis_size, psum_in_order

        cnt = psum_in_order(cnt.detach(), mesh, daxes)
        loss = tot / torch.clamp(cnt, min=1.0) * _axis_size(mesh, daxes)
    else:
        loss = tot / torch.clamp(cnt, min=1.0)
    total = loss + cfg.aux_loss_weight * aux
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# serving: decode with a KV cache
# ---------------------------------------------------------------------------


def _cache_keys(cfg: TransformerConfig) -> tuple[str, str]:
    return ("c_kv", "k_pe") if cfg.attention == "mla" else ("k", "v")


@dataclasses.dataclass
class CacheLayout:
    """Where a rank's cache lies in the global one (``cache["layout"]`` of a
    cache made on a mesh): positions ``[offset, offset + local_len)`` of
    ``max_len``, the rows of its ``batch_axes`` block, over ``mesh``.
    ``last_partials`` holds the last attention layer's local ``(m, l)``
    (references, no copy) for a caller to inspect."""

    mesh: Any
    seq_axes: tuple
    batch_axes: tuple
    offset: int
    local_len: int
    max_len: int
    last_partials: tuple | None = None


def _mesh_axes(mesh, axes) -> tuple:
    sizes = axis_sizes(mesh)
    return tuple(a for a in axes if a in sizes)


def cache_layout(mesh, max_len: int, *, seq_axes=(), batch_axes=()) -> CacheLayout:
    """The layout of this rank's cache on ``mesh`` (a ``DeviceMesh``): the
    sequence split over ``seq_axes`` (row-major, axes the mesh lacks
    dropped), this rank's block of it from its place in that group."""
    from repro_torch.core.distributed import _axis_index, _axis_size

    seq, bat = _mesh_axes(mesh, seq_axes), _mesh_axes(mesh, batch_axes)
    p = _axis_size(mesh, seq) if seq else 1
    if max_len % p:
        raise ValueError(f"max_len={max_len} does not split over {p} ranks of {seq}")
    local = max_len // p
    offset = _axis_index(mesh, seq) * local if seq else 0
    return CacheLayout(mesh, seq, bat, offset, local, max_len)


def make_cache(
    cfg: TransformerConfig, batch: int, max_len: int, *, device: str | torch.device = "cuda",
    mesh=None, seq_axes=(), batch_axes=(),
) -> dict:
    """An empty cache in the model's dtype, stacked over the non-dense layers
    (``L'``), with ``dense_*`` entries over the ``first_k_dense`` layers.
    GQA: ``k``/``v`` ``(L', B, Hkv, S, D)``. MLA: the latent ``c_kv (L', B,
    S, r)`` and ``k_pe (L', B, S, dr)``. ``length (B,)`` int32.

    With a ``mesh`` (a ``DeviceMesh``; every rank calls this) it is the
    rank's block: ``S = max_len / p`` positions from ``r · S``, ``p`` the
    product of the ``seq_axes`` sizes and ``r`` the rank's row-major place
    over them, and ``batch / q`` rows for the ``q`` ranks of
    ``batch_axes``; ``cache["layout"]`` (:class:`CacheLayout`) says so, and
    ``length`` holds the global positions of the rank's rows."""
    dev = device_of(device)
    layout = None
    if mesh is not None:
        from repro_torch.core.distributed import _axis_size

        layout = cache_layout(mesh, max_len, seq_axes=seq_axes, batch_axes=batch_axes)
        q = _axis_size(mesh, layout.batch_axes) if layout.batch_axes else 1
        if batch % q:
            raise ValueError(f"batch={batch} does not split over {q} ranks of "
                             f"{layout.batch_axes}")
        batch, max_len = batch // q, layout.local_len

    def zeros(layers):
        if cfg.attention == "mla":
            shapes = ((layers, batch, max_len, cfg.kv_lora_rank),
                      (layers, batch, max_len, cfg.qk_rope_dim))
        else:
            shape = (layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
            shapes = (shape, shape)
        return [torch.zeros(s, dtype=cfg.dtype, device=dev) for s in shapes]

    keys = _cache_keys(cfg)
    cache = dict(zip(keys, zeros(cfg.n_layers - cfg.first_k_dense)))
    if cfg.first_k_dense:
        cache.update(zip((f"dense_{key}" for key in keys), zeros(cfg.first_k_dense)))
    cache["length"] = torch.zeros(batch, dtype=torch.int32, device=dev)
    if layout is not None:
        cache["layout"] = layout
    return cache


def _write_row(cache: torch.Tensor, pos: torch.Tensor, row: torch.Tensor,
               layout: CacheLayout | None) -> None:
    """``cache[b, ..., pos[b], :] = row[b]`` in place (the sequence dim is
    ``cache``'s second-last). On a sharded cache only the rank whose block
    holds ``pos[b]`` writes it, at its local position; the others write the
    row's old value back (no host sync)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    row = row.to(cache.dtype)
    if layout is None:
        cache[bidx, ..., pos.long(), :] = row
        return
    local = pos.long() - layout.offset
    mine = (local >= 0) & (local < layout.local_len)
    at = local.clamp(0, layout.local_len - 1)
    old = cache[bidx, ..., at, :]
    cache[bidx, ..., at, :] = torch.where(mine.reshape(-1, *[1] * (row.dim() - 1)), row, old)


def _local_lengths(lengths: torch.Tensor, layout: CacheLayout | None) -> torch.Tensor:
    """Live positions of each row in this rank's block (``lengths + 1`` is
    the global count, the new token included)."""
    if layout is None:
        return lengths + 1
    return (lengths + 1 - layout.offset).clamp(0, layout.local_len)


def _combine_over_seq(acc, m, l, layout: CacheLayout) -> torch.Tensor:
    """Merge every rank's ``(acc (B, H, W), m, l)`` over the layout's
    sequence group: one all-gather of ``B × H × (W + 2)`` f32, then
    ``combine_partials`` in rank order (the bits do not depend on timing)."""
    from repro_torch.core.distributed import _all_gather

    layout.last_partials = (m, l)
    if not layout.seq_axes:
        return acc / torch.where(l == 0.0, 1.0, l)[..., None]
    b, h, w = acc.shape
    packed = torch.cat([acc, m[..., None], l[..., None]], dim=-1)[None]
    parts = _all_gather(packed, layout.mesh, layout.seq_axes)        # (P, B, H, W + 2)
    return combine_partials(parts[..., :w], parts[..., w], parts[..., w + 1])


def _gqa_decode_attn(p: Attention, cfg, x, k_cache, v_cache, lengths, use_kernel: bool,
                     layout: CacheLayout | None = None):
    """One-token GQA attention against one layer's cache (+ the new token,
    written into the cache in place at each sequence's position). On a
    sharded cache: K9's partials over the rank's block, merged over the
    ranks (:func:`_combine_over_seq`)."""
    b = x.shape[0]
    cut = _cut_of(p)
    heads = _heads(p, cfg)
    q = _lin(p.wq, x).reshape(b, 1, heads.hq, cfg.head_dim)
    k_new = F.linear(x, _kv_weight(p.wk, cut)).reshape(b, 1, heads.hkv, cfg.head_dim)
    v_new = F.linear(x, _kv_weight(p.wv, cut)).reshape(b, 1, heads.hkv, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_scale)
        k_new = rms_norm(k_new, p.k_scale)
    posb = lengths[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)[:, 0]             # (B, H, D)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)[:, 0]     # (B, Hkv, D)
    v_new = v_new[:, 0]
    if cut is not None and cut.split:      # every head's q and new row on every rank
        q, k_new, v_new = _gather_heads(cut, (q, heads.q_keep), (k_new, heads.kv_keep),
                                        (v_new, heads.kv_keep))
    _write_row(k_cache, lengths, k_new, layout)
    _write_row(v_cache, lengths, v_new, layout)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    live = _local_lengths(lengths, layout)
    if layout is not None:
        partials = (decode_attention_partials if use_kernel else
                    lambda *a, **k: decode_attention_xla(*a, **k, with_partials=True))
        o = _combine_over_seq(*partials(q, k_cache, v_cache, live, scale=scale), layout)
    elif use_kernel:
        o = decode_attention(q, k_cache, v_cache, live, scale=scale)
    else:
        o = decode_attention_xla(q, k_cache, v_cache, live, scale=scale)
    o = _rank_heads(o, heads)              # the rank's heads for the row-parallel wo
    return _row_parallel(p.wo.weight, o.reshape(b, heads.hq * cfg.head_dim).to(x.dtype), cut)


def _gather_heads(cut: Cut, *parts) -> list:
    """Each ``(x, keep)`` of ``parts``, ``x (B, h, D)`` the rank's heads,
    all-gathered over ``model`` (one collective for all the parts) to
    ``(B, len(keep), D)``: every rank's heads side by side in rank order,
    then the places ``keep`` (the reference's heads, without the padding
    and the repeats)."""
    from repro_torch.core.distributed import gather_heads

    b = parts[0][0].shape[0]
    flat = torch.cat([x.reshape(b, -1) for x, _ in parts], dim=1)
    got = gather_heads(flat, cut.mesh, "model", dim=1)
    got = got.view(b, got.shape[1] // flat.shape[1], flat.shape[1])
    out, lo = [], 0
    for x, keep in parts:
        n = x.shape[1] * x.shape[2]
        every = got[:, :, lo:lo + n].reshape(b, -1, x.shape[2])
        out.append(every.index_select(1, torch.tensor(keep, dtype=torch.long, device=x.device)))
        lo += n
    return out


def _rank_heads(o: torch.Tensor, heads: Heads) -> torch.Tensor:
    """The rank's heads of ``o (B, H, …)`` (every head, the reference's
    geometry) in its padded order, zeros for its padded ones."""
    idx = torch.tensor([h if h >= 0 else o.shape[1] for h in heads.q], dtype=torch.long,
                       device=o.device)
    if not heads.zeros:
        return o.index_select(1, idx)
    return torch.cat([o, o.new_zeros((o.shape[0], 1, *o.shape[2:]))], dim=1).index_select(1, idx)


def _mla_decode_attn(p: MLAAttention, cfg, x, c_cache, pe_cache, lengths,
                     layout: CacheLayout | None = None):
    """Absorbed MLA decode: attention entirely in latent space, in plain
    torch products (f32, as the reference's einsums; no kernel by design).

    Scores ``s[b,h,l] = (q_nope·W_kᵀ)·c_kv[l] + q_pe·k_pe[l]``; output
    ``o[b,h] = (Σ_l p_l·c_kv[l])·W_v``: K/V are never materialized. The new
    latent row is written into ``c_cache``/``pe_cache`` in place. On a
    sharded cache each rank forms the unnormalised ``(Σ_l p_l·c_kv[l], m,
    l)`` of its block and the ranks merge them as K9's partials.
    """
    b = x.shape[0]
    cut = _cut_of(p)
    heads = _heads(p, cfg)
    h = heads.hq
    dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    posb = lengths[:, None]

    cq = rms_norm(_lin(p.wq_a, x), p.q_norm)
    q = _lin(p.wq_b, cq).reshape(b, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe[:, None], posb, cfg.rope_theta)[:, 0]

    kv_a = _lin(p.wkv_a, x)
    c_new = rms_norm(kv_a[..., :r], p.kv_norm)
    pe_new = apply_rope(kv_a[..., r:][:, None, None, :], posb, cfg.rope_theta)[:, 0, 0]

    _write_row(c_cache, lengths, c_new, layout)
    _write_row(pe_cache, lengths, pe_new, layout)

    wkv_b = weight_for_use(p.wkv_b.weight).T.reshape(r, h, dn + dv).float()
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]               # (r, h, dn), (r, h, dv)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_k)
    q_pe = q_pe.float()
    if cut is not None and cut.split:      # every head's latent query on every rank
        q_lat, q_pe = _gather_heads(cut, (q_lat, heads.q_keep), (q_pe, heads.q_keep))
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    c32 = c_cache.float()
    s = (torch.einsum("bhr,blr->bhl", q_lat, c32)
         + torch.einsum("bhr,blr->bhl", q_pe, pe_cache.float())) * scale
    L = c_cache.shape[1]
    live = _local_lengths(lengths, layout)
    valid = torch.arange(L, device=x.device)[None, None, :] < live[:, None, None]
    s = torch.where(valid, s, NEG_LARGE)
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.where(valid, torch.exp(s - m), 0.0)
    if layout is None:
        pr = pr / pr.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o_lat = torch.einsum("bhl,blr->bhr", pr, c32)
    else:
        o_lat = _combine_over_seq(torch.einsum("bhl,blr->bhr", pr, c32), m[..., 0],
                                  pr.sum(dim=-1), layout)
    o = torch.einsum("bhr,rhv->bhv", _rank_heads(o_lat, heads), w_v)
    return _row_parallel(p.wo.weight, o.reshape(b, h * dv).to(x.dtype), cut)


def _decode_block(p: Block, cfg, x, cache_a, cache_b, lengths, use_kernel: bool, layout):
    xn = rms_norm(x, p.attn_norm)
    if cfg.attention == "mla":
        attn = _mla_decode_attn(p.attn, cfg, xn, cache_a, cache_b, lengths, layout)
    else:
        attn = _gqa_decode_attn(p.attn, cfg, xn, cache_a, cache_b, lengths, use_kernel, layout)
    h = x + attn
    return h + _ffn(p.ffn, cfg, rms_norm(h, p.ffn_norm)[:, None, :])[0][:, 0, :]


@torch.no_grad()
def decode_step(
    params: Transformer, cfg: TransformerConfig, cache: dict, tokens,
    *, use_kernel: bool | None = None,
):
    """One decode step: ``tokens (B,)`` → next-token logits ``(B, V)`` f32.

    Unlike the reference, which returns a new cache, this writes the new
    rows into the cache (``k``/``v`` or ``c_kv``/``k_pe``, and their
    ``dense_*`` twins) and adds one to ``cache["length"]`` in place, and
    returns the same dict: a functional update would copy the whole cache
    every step. Where the reference drops a write at a position ≥ the
    cache's length, this raises ``ValueError`` before any write. An MoE
    layer routes the ``B`` tokens of the step, so its capacity follows
    ``B``.

    On a cache made on a mesh (``make_cache(mesh=)``; every rank of the
    mesh calls this with its rows' tokens) the new K/V row is written only
    by the rank whose block holds ``lengths[b]``, each rank runs K9's
    partials entry (its plain version on the CPU) over its block with
    local lengths ``clamp(lengths + 1 − offset, 0, S)``, and the ranks'
    ``(acc, m, l)`` are all-gathered over the sequence group and merged by
    ``combine_partials`` in rank order. A rank whose block lies past a
    sequence's length contributes ``m = NEG_LARGE``, ``l = 0``.
    """
    exact_f32()
    tokens = _tokens(params, tokens)
    use = _use_kernel(use_kernel, tokens.device)
    lengths = cache["length"]
    layout = cache.get("layout")
    a, b = _cache_keys(cfg)
    max_len = layout.max_len if layout else cache[a].shape[3 if cfg.attention == "gqa" else 2]
    if not lengths.is_meta and int(lengths.max()) >= max_len:
        raise ValueError(f"a sequence has filled its cache of {max_len} positions")
    x = _embed(params, tokens)
    for i, blk in enumerate(params.dense_layers):
        x = _decode_block(blk, cfg, x, cache[f"dense_{a}"][i], cache[f"dense_{b}"][i],
                          lengths, use, layout)
    for i, blk in enumerate(params.layers):
        x = _decode_block(blk, cfg, x, cache[a][i], cache[b][i], lengths, use, layout)
    logits = _logits_f32(params, rms_norm(x, params.final_norm))
    lengths.add_(1)
    return logits, cache
