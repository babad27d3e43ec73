"""Plain-PyTorch oracles for flash-decode attention partials and their
combine (the reference's ``decode_attention/ref.py``)."""

from __future__ import annotations

import torch

from repro_torch.core.precision import exact_f32

NEG_LARGE = -0.5e30


def decode_partials_reference(
    q: torch.Tensor,        # (B, Hq, D) one new token per sequence
    k: torch.Tensor,        # (B, Hkv, L, D) local KV-cache shard
    v: torch.Tensor,        # (B, Hkv, L, D)
    lengths: torch.Tensor,  # (B,) valid cache length per sequence
    *,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalised partial ``(acc, m, l)`` over a local cache shard:
    ``acc = Σ exp(s - m)·v``, ``m = max s``, ``l = Σ exp(s - m)``."""
    exact_f32()
    b, hq, d = q.shape
    hkv, L = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kx = torch.repeat_interleave(k, group, dim=1).float()   # (B, Hq, L, D)
    vx = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhd,bhld->bhl", q.float(), kx) * scale
    valid = torch.arange(L, device=q.device)[None, None, :] < lengths.to(q.device)[:, None, None]
    s = torch.where(valid, s, NEG_LARGE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhl,bhld->bhd", p, vx)
    return acc, m[..., 0], l[..., 0]


def combine_partials_reference(
    accs: torch.Tensor,  # (P, B, Hq, D)
    ms: torch.Tensor,    # (P, B, Hq)
    ls: torch.Tensor,    # (P, B, Hq)
) -> torch.Tensor:
    m_star = ms.amax(dim=0)
    w = torch.exp(ms - m_star[None])
    num = (accs * w[..., None]).sum(dim=0)
    den = (ls * w).sum(dim=0)
    return num / torch.where(den == 0.0, 1.0, den)[..., None]


def decode_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Full (single-shard) decode attention oracle ``(B, Hq, D)``."""
    acc, m, l = decode_partials_reference(q, k, v, lengths, scale=scale)
    return acc / torch.where(l == 0.0, 1.0, l)[..., None]
