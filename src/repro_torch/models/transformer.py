"""Decoder-only LM transformer covering the five LM architectures.

The reference's ``models/transformer.py`` as ``torch.nn.Module``s and the
same functions over them: ``transformer_logits`` and ``prefill`` over a
prompt, ``make_cache`` and ``decode_step`` for serving, ``count_params``
and ``count_active_params``. Feature matrix:

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
``use_kernel=True`` on the CPU raises. Training, ``moe_ffn_ep`` and the
mesh-sharded cells wait for ROADMAP queue 1 items 9.4-9.8.

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

from repro_torch.core.precision import exact_f32
from repro_torch.interop import device_of
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (
    NEG_LARGE,
    apply_rope,
    chunked_attention,
    decode_attention_xla,
    dense_init,
    embed_init,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import MoEParams, init_moe, moe_ffn


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
    aux_loss_weight: float = 0.01   # training (item 9.5)
    moe_impl: str = "gspmd"         # "ep" runs moe_ffn too until item 9.4 (no mesh)
    # numerics
    dtype: Any = torch.bfloat16
    q_chunk: int = 512              # the plain path's attention chunks
    kv_chunk: int = 1024
    bf16_probs: bool = False        # plain path only (K8 raises)

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

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        if cfg.attention not in ("gqa", "mla"):
            raise ValueError(f"unknown attention {cfg.attention!r}")
        self.cfg = cfg
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
        self.requires_grad_(False)

    def blocks(self):
        """Every block in order: the dense ones, then the others."""
        return [*self.dense_layers, *self.layers]


def init_transformer(
    cfg: TransformerConfig,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> Transformer:
    """A model with the reference's init laws, drawn from ``generator`` (on
    ``device``; seed 0 when omitted): matrices normal × √(2/(d_in+d_out)),
    the router likewise in f32, the embedding 0.02 × normal, norms ones.
    Torch's generators give other numbers than ``jax.random``; ``interop``
    carries a JAX model across."""
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


def _gqa_qkv(p: Attention, cfg: TransformerConfig, x, positions):
    b, s, _ = x.shape
    q = p.wq(x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = p.wk(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = p.wv(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_scale)
        k = rms_norm(k, p.k_scale)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mla_qkv(p: MLAAttention, cfg: TransformerConfig, x, positions):
    """MLA projections (prefill path, explicit K/V): q, k ``(B, S, H,
    qk_head_dim)``, v ``(B, S, H, v_head_dim)``."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cq = rms_norm(p.wq_a(x), p.q_norm)
    q = p.wq_b(cq).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    kv_a = p.wkv_a(x)
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank], p.kv_norm)
    k_pe = apply_rope(kv_a[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                      cfg.rope_theta)  # one shared head
    kv = p.wkv_b(c_kv).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_pe.expand(b, s, h, dr)], dim=-1)
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
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.v_dim)
    return p.wo(o)


def _swiglu(p: FFN, x):
    return swiglu(x, p.w_gate.weight.T, p.w_up.weight.T, p.w_down.weight.T)


def _ffn(p, cfg: TransformerConfig, x, moe_stats: list | None = None):
    """FFN: dense, or MoE (+ shared experts / + dense residual). The MoE
    runs over the ``B·S`` flattened tokens, so its capacity follows them.
    ``moe_stats`` collects each MoE call's ``MoEOut`` (aux loss, drops)."""
    if isinstance(p, FFN):
        return _swiglu(p, x)
    b, s, d = x.shape
    out = moe_ffn(p.moe, x.reshape(b * s, d), top_k=cfg.top_k,
                  capacity_factor=cfg.capacity_factor)
    if moe_stats is not None:
        moe_stats.append(out._replace(y=None))
    y = out.y.reshape(b, s, d)
    if p.shared is not None:
        y = y + _swiglu(p.shared, x)
    if p.dense is not None:
        y = y + _swiglu(p.dense, x)
    return y


def _block(p: Block, cfg: TransformerConfig, x, positions, use_kernel: bool, moe_stats):
    h = x + _attention(p.attn, cfg, rms_norm(x, p.attn_norm), positions, use_kernel)
    return h + _ffn(p.ffn, cfg, rms_norm(h, p.ffn_norm), moe_stats)


def _backbone(params: Transformer, cfg: TransformerConfig, tokens, use_kernel: bool,
              moe_stats: list | None = None):
    """Embed + all blocks + final norm → hidden states (B, S, d)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    x = F.embedding(tokens.long(), params.embed)
    for blk in params.blocks():
        x = _block(blk, cfg, x, positions, use_kernel, moe_stats)
    return rms_norm(x, params.final_norm)


def _tokens(params: Transformer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device)


@torch.no_grad()
def transformer_logits(
    params: Transformer, cfg: TransformerConfig, tokens, *, use_kernel: bool | None = None
) -> torch.Tensor:
    """Full logits ``(B, S, V)`` in the model's dtype (small configs, tests
    and parity runs: O(B·S·V) memory)."""
    exact_f32()
    tokens = _tokens(params, tokens)
    x = _backbone(params, cfg, tokens, _use_kernel(use_kernel, tokens.device))
    return params.lm_head(x)


def _logits_f32(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """``x · lm_head`` with f32 output: products of the model's dtype summed
    in f32, as the reference's ``preferred_element_type=f32``."""
    return torch.matmul(x.float(), params.lm_head.weight.float().T)


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
    x = _backbone(params, cfg, tokens, _use_kernel(use_kernel, tokens.device), moe_stats)
    return _logits_f32(params, x[:, -1, :])


# ---------------------------------------------------------------------------
# serving: decode with a KV cache
# ---------------------------------------------------------------------------


def _cache_keys(cfg: TransformerConfig) -> tuple[str, str]:
    return ("c_kv", "k_pe") if cfg.attention == "mla" else ("k", "v")


def make_cache(
    cfg: TransformerConfig, batch: int, max_len: int, *, device: str | torch.device = "cuda"
) -> dict:
    """An empty cache in the model's dtype, stacked over the non-dense layers
    (``L'``), with ``dense_*`` entries over the ``first_k_dense`` layers.
    GQA: ``k``/``v`` ``(L', B, Hkv, S, D)``. MLA: the latent ``c_kv (L', B,
    S, r)`` and ``k_pe (L', B, S, dr)``. ``length (B,)`` int32."""
    dev = device_of(device)

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
    return cache


def _gqa_decode_attn(p: Attention, cfg, x, k_cache, v_cache, lengths, use_kernel: bool):
    """One-token GQA attention against one layer's cache (+ the new token,
    written into the cache in place at each sequence's position)."""
    b = x.shape[0]
    q = p.wq(x).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k_new = p.wk(x).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    v_new = p.wv(x).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_scale)
        k_new = rms_norm(k_new, p.k_scale)
    posb = lengths[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)[:, 0]             # (B, H, D)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)[:, 0]     # (B, Hkv, D)
    bidx = torch.arange(b, device=x.device)
    pos = lengths.long()
    k_cache[bidx, :, pos, :] = k_new.to(k_cache.dtype)
    v_cache[bidx, :, pos, :] = v_new[:, 0].to(v_cache.dtype)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    if use_kernel:
        o = decode_attention(q, k_cache, v_cache, lengths + 1, scale=scale)
    else:
        o = decode_attention_xla(q, k_cache, v_cache, lengths + 1, scale=scale)
    return p.wo(o.reshape(b, cfg.n_heads * cfg.head_dim).to(x.dtype))


def _mla_decode_attn(p: MLAAttention, cfg, x, c_cache, pe_cache, lengths):
    """Absorbed MLA decode: attention entirely in latent space, in plain
    torch products (f32, as the reference's einsums; no kernel by design).

    Scores ``s[b,h,l] = (q_nope·W_kᵀ)·c_kv[l] + q_pe·k_pe[l]``; output
    ``o[b,h] = (Σ_l p_l·c_kv[l])·W_v``: K/V are never materialized. The new
    latent row is written into ``c_cache``/``pe_cache`` in place.
    """
    b = x.shape[0]
    h, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    posb = lengths[:, None]

    cq = rms_norm(p.wq_a(x), p.q_norm)
    q = p.wq_b(cq).reshape(b, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe[:, None], posb, cfg.rope_theta)[:, 0]

    kv_a = p.wkv_a(x)
    c_new = rms_norm(kv_a[..., :r], p.kv_norm)
    pe_new = apply_rope(kv_a[..., r:][:, None, None, :], posb, cfg.rope_theta)[:, 0, 0]

    bidx = torch.arange(b, device=x.device)
    pos = lengths.long()
    c_cache[bidx, pos, :] = c_new.to(c_cache.dtype)
    pe_cache[bidx, pos, :] = pe_new.to(pe_cache.dtype)

    wkv_b = p.wkv_b.weight.T.reshape(r, h, dn + dv).float()
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]               # (r, h, dn), (r, h, dv)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_k)
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    c32 = c_cache.float()
    s = (torch.einsum("bhr,blr->bhl", q_lat, c32)
         + torch.einsum("bhr,blr->bhl", q_pe.float(), pe_cache.float())) * scale
    L = c_cache.shape[1]
    valid = torch.arange(L, device=x.device)[None, None, :] < (lengths + 1)[:, None, None]
    s = torch.where(valid, s, NEG_LARGE)
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.where(valid, torch.exp(s - m), 0.0)
    pr = pr / pr.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o_lat = torch.einsum("bhl,blr->bhr", pr, c32)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_v)
    return p.wo(o.reshape(b, h * dv).to(x.dtype))


def _decode_block(p: Block, cfg, x, cache_a, cache_b, lengths, use_kernel: bool):
    xn = rms_norm(x, p.attn_norm)
    if cfg.attention == "mla":
        attn = _mla_decode_attn(p.attn, cfg, xn, cache_a, cache_b, lengths)
    else:
        attn = _gqa_decode_attn(p.attn, cfg, xn, cache_a, cache_b, lengths, use_kernel)
    h = x + attn
    return h + _ffn(p.ffn, cfg, rms_norm(h, p.ffn_norm)[:, None, :])[:, 0, :]


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
    """
    exact_f32()
    tokens = _tokens(params, tokens)
    use = _use_kernel(use_kernel, tokens.device)
    lengths = cache["length"]
    a, b = _cache_keys(cfg)
    max_len = cache[a].shape[3 if cfg.attention == "gqa" else 2]
    if int(lengths.max()) >= max_len:
        raise ValueError(f"a sequence has filled its cache of {max_len} positions")
    x = F.embedding(tokens.long(), params.embed)
    for i, blk in enumerate(params.dense_layers):
        x = _decode_block(blk, cfg, x, cache[f"dense_{a}"][i], cache[f"dense_{b}"][i],
                          lengths, use)
    for i, blk in enumerate(params.layers):
        x = _decode_block(blk, cfg, x, cache[a][i], cache[b][i], lengths, use)
    logits = _logits_f32(params, rms_norm(x, params.final_norm))
    lengths.add_(1)
    return logits, cache
