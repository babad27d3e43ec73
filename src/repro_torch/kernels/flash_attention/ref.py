"""Plain-PyTorch oracle for causal GQA attention (the reference's
``attention_reference``): the whole score matrix, softmax, then values."""

from __future__ import annotations

import torch

from repro_torch.core.precision import exact_f32


def attention_reference(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    exact_f32()
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    assert hq % hkv == 0, (hq, hkv)
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    logits = torch.matmul(q.float(), kx.float().transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(s, device=q.device)
        logits = torch.where(pos[:, None] >= pos[None, :], logits, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, vx.float()).to(q.dtype)
