"""Decoder-only LM transformer, dense GQA half (qwen3-1.7b, qwen3-8b).

The reference's ``models/transformer.py`` with its dense GQA path (optional
QK-norm, RoPE, SwiGLU FFN) as a ``torch.nn.Module`` and the same functions
over it: ``transformer_logits`` and ``prefill`` over a prompt,
``make_cache`` and ``decode_step`` for serving, ``count_params``. MLA
attention (minicpm3) and MoE FFNs (deepseek-moe, arctic) raise
``NotImplementedError``: they wait for ROADMAP queue 1 item 9.

Attention runs through the port's kernels on the card: K8
(``kernels/flash_attention``) where the reference calls
``chunked_attention`` and K9 (``kernels/decode_attention``) where it calls
``decode_attention_xla``. ``use_kernel=None`` takes the kernels when the
model lies on a CUDA device and the plain functions of ``models/layers.py``
on the CPU; ``use_kernel=False`` runs the plain functions on the card, and
``use_kernel=True`` on the CPU raises.

Weights are ``nn.Linear`` weights ``(d_out, d_in)``: the transpose of the
reference's ``(d_in, d_out)`` matrices (``interop`` carries them across).
The KV cache is written in place (see :func:`decode_step`).
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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (
    apply_rope,
    chunked_attention,
    decode_attention_xla,
    dense_init,
    embed_init,
    rms_norm,
    swiglu,
)


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
    attention: str = "gqa"          # "mla" raises until ROADMAP item 9
    qk_norm: bool = False
    rope_theta: float = 1e6
    moe: bool = False               # True raises until ROADMAP item 9
    first_k_dense: int = 0          # MoE only: nonzero raises likewise
    dtype: Any = torch.bfloat16
    q_chunk: int = 512              # the plain path's attention chunks
    kv_chunk: int = 1024
    bf16_probs: bool = False        # plain path only (K8 raises)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (padded ids are never emitted as labels)."""
        return ((self.vocab_size + 255) // 256) * 256


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.attention!r} attention is not ported yet (ROADMAP queue 1 item 9)"
        )
    if cfg.moe or cfg.first_k_dense:
        raise NotImplementedError("MoE FFNs are not ported yet (ROADMAP queue 1 item 9)")


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


class FFN(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.w_gate = _linear(cfg.d_model, cfg.d_ff, cfg, device)
        self.w_up = _linear(cfg.d_model, cfg.d_ff, cfg, device)
        self.w_down = _linear(cfg.d_ff, cfg.d_model, cfg, device)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.attn_norm = _ones(cfg.d_model, cfg, device)
        self.attn = Attention(cfg, device)
        self.ffn_norm = _ones(cfg.d_model, cfg, device)
        self.ffn = FFN(cfg, device)


class Transformer(nn.Module):
    """The parameters of a dense GQA transformer, uninitialised (norms are
    ones); :func:`init_transformer` and ``interop`` fill them."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(cfg.padded_vocab, cfg.d_model, dtype=cfg.dtype, device=device),
            requires_grad=False,
        )
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = _ones(cfg.d_model, cfg, device)
        self.lm_head = _linear(cfg.d_model, cfg.padded_vocab, cfg, device)
        self.requires_grad_(False)


def init_transformer(
    cfg: TransformerConfig,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> Transformer:
    """A model with the reference's init laws, drawn from ``generator`` (on
    ``device``; seed 0 when omitted): matrices normal × √(2/(d_in+d_out)),
    the embedding 0.02 × normal, norms ones. Torch's generators give other
    numbers than ``jax.random``; ``interop`` carries a JAX model across."""
    dev = device_of(device)
    model = Transformer(cfg, dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)

    def fill(lin: nn.Linear) -> None:
        d_out, d_in = lin.weight.shape
        lin.weight.copy_(dense_init(generator, d_in, d_out, cfg.dtype, dev).T)

    with torch.no_grad():
        model.embed.copy_(embed_init(generator, cfg.padded_vocab, cfg.d_model, cfg.dtype, dev))
        for blk in model.layers:
            for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                        blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_down):
                fill(lin)
        fill(model.lm_head)
    return model


def count_params(cfg: TransformerConfig) -> int:
    """Parameters of the model ``cfg`` describes (built on the meta device)."""
    return sum(p.numel() for p in Transformer(cfg, "meta").parameters())


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


def _attention(p: Attention, cfg: TransformerConfig, x, positions, use_kernel: bool):
    b, s, _ = x.shape
    q, k, v = (a.transpose(1, 2) for a in _gqa_qkv(p, cfg, x, positions))  # (B, H, S, D)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    if use_kernel:
        if cfg.bf16_probs:
            raise ValueError("K8 has no bf16 probabilities: bf16_probs runs the plain path")
        o = flash_attention(q, k, v, causal=True, scale=scale)
    else:
        o = chunked_attention(
            q, k, v, causal=True, scale=scale,
            q_chunk=min(cfg.q_chunk, s), kv_chunk=min(cfg.kv_chunk, s),
            probs_dtype=torch.bfloat16 if cfg.bf16_probs else None,
        )
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return p.wo(o)


def _ffn(p: FFN, x):
    """Dense SwiGLU FFN (the MoE variants wait for ROADMAP item 9)."""
    return swiglu(x, p.w_gate.weight.T, p.w_up.weight.T, p.w_down.weight.T)


def _block(p: Block, cfg: TransformerConfig, x, positions, use_kernel: bool):
    h = x + _attention(p.attn, cfg, rms_norm(x, p.attn_norm), positions, use_kernel)
    return h + _ffn(p.ffn, rms_norm(h, p.ffn_norm))


def _backbone(params: Transformer, cfg: TransformerConfig, tokens, use_kernel: bool):
    """Embed + all blocks + final norm → hidden states (B, S, d)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    x = F.embedding(tokens.long(), params.embed)
    for blk in params.layers:
        x = _block(blk, cfg, x, positions, use_kernel)
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
    params: Transformer, cfg: TransformerConfig, tokens, *, use_kernel: bool | None = None
) -> torch.Tensor:
    """Run the backbone over a prompt ``(B, S)``; last-position logits
    ``(B, V)`` f32. Like the reference, it fills no cache (serving feeds the
    prompt through :func:`decode_step`)."""
    exact_f32()
    tokens = _tokens(params, tokens)
    x = _backbone(params, cfg, tokens, _use_kernel(use_kernel, tokens.device))
    return _logits_f32(params, x[:, -1, :])


# ---------------------------------------------------------------------------
# serving: decode with a KV cache
# ---------------------------------------------------------------------------


def make_cache(
    cfg: TransformerConfig, batch: int, max_len: int, *, device: str | torch.device = "cuda"
) -> dict:
    """An empty KV cache: k and v ``(n_layers, B, Hkv, max_len, D)`` in the
    model's dtype, ``length (B,)`` int32."""
    _check_supported(cfg)
    dev = device_of(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "length": torch.zeros(batch, dtype=torch.int32, device=dev),
    }


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


def _decode_block(p: Block, cfg, x, k_cache, v_cache, lengths, use_kernel: bool):
    xn = rms_norm(x, p.attn_norm)
    h = x + _gqa_decode_attn(p.attn, cfg, xn, k_cache, v_cache, lengths, use_kernel)
    return h + _ffn(p.ffn, rms_norm(h, p.ffn_norm))


@torch.no_grad()
def decode_step(
    params: Transformer, cfg: TransformerConfig, cache: dict, tokens,
    *, use_kernel: bool | None = None,
):
    """One decode step: ``tokens (B,)`` → next-token logits ``(B, V)`` f32.

    Unlike the reference, which returns a new cache, this writes the new
    K/V rows into ``cache["k"]``/``cache["v"]`` and adds one to
    ``cache["length"]`` in place, and returns the same dict: a functional
    update would copy the whole cache every step. Where the reference drops
    a write at a position ≥ the cache's length, this raises ``ValueError``
    before any write.
    """
    exact_f32()
    tokens = _tokens(params, tokens)
    use = _use_kernel(use_kernel, tokens.device)
    lengths = cache["length"]
    max_len = cache["k"].shape[3]
    if int(lengths.max()) >= max_len:
        raise ValueError(f"a sequence has filled its cache of {max_len} positions")
    x = F.embedding(tokens.long(), params.embed)
    for i, blk in enumerate(params.layers):
        x = _decode_block(blk, cfg, x, cache["k"][i], cache["v"][i], lengths, use)
    logits = _logits_f32(params, rms_norm(x, params.final_norm))
    lengths.add_(1)
    return logits, cache
