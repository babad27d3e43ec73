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
functions; the model stores them as ``nn.Linear`` weights ``(d_out, d_in)``.
"""

from __future__ import annotations

import torch

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


# -- MLP ----------------------------------------------------------------------


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    """SwiGLU MLP (LLaMA/Qwen FFN); weights ``(d_in, d_out)``."""
    exact_f32()
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)


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
