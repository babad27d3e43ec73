"""Public wrappers: single-shard decode attention and the shard combine."""

from __future__ import annotations

import torch

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.decode_attention.decode_attention import decode_attention_kernel


def decode_attention(
    q: torch.Tensor,        # (B, Hq, D)
    k: torch.Tensor,        # (B, Hkv, L, D)
    v: torch.Tensor,        # (B, Hkv, L, D)
    lengths: torch.Tensor,  # (B,)
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Normalised decode attention over one cache shard ``(B, Hq, D)`` f32
    (K9 on CUDA tensors, its plain version on CPU ones)."""
    acc, m, l = decode_attention_partials(q, k, v, lengths, scale=scale)
    return acc / torch.where(l == 0.0, 1.0, l)[..., None]


def decode_attention_partials(q, k, v, lengths, *, scale=None):
    """Unnormalised flash-decode partials ``(acc, m, l)`` for the shard
    combine. The kernel walks each sequence to its length, so the cache
    needs no padding to a tile. Inputs that require a gradient raise
    ``ValueError`` under grad mode (K9 has no backward pass)."""
    refuse_autograd("decode_attention (K9)", q, k, v)
    return decode_attention_kernel(
        q.contiguous(), k.contiguous(), v.contiguous(), lengths, scale=scale
    )


def combine_partials(
    accs: torch.Tensor,  # (P, B, Hq, D)
    ms: torch.Tensor,    # (P, B, Hq)
    ls: torch.Tensor,    # (P, B, Hq)
) -> torch.Tensor:
    """Exact logsumexp-monoid merge of per-shard decode partials."""
    m_star = ms.amax(dim=0)
    w = torch.exp(ms - m_star[None])
    num = (accs * w[..., None]).sum(dim=0)
    den = (ls * w).sum(dim=0)
    return num / torch.where(den == 0.0, 1.0, den)[..., None]
