"""Public wrapper for flash attention: the reference's padding, then K8."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_kernel


BLOCK = 512  # the reference's default tile, which sets the padding


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal GQA flash attention ``(B, Hq, S, D) → (B, Hq, S, D)``.

    The sequence is padded to the reference's tile (a power of two from 128
    up to :data:`BLOCK`); for causal attention the padded queries attend only
    to themselves and earlier keys and are sliced away, so padding never
    changes visible outputs. Non-causal attention raises on a sequence that
    would need padding, as the reference does. On CUDA tensors this is K8;
    on CPU tensors K8's plain version. Inputs that require a gradient raise
    ``ValueError`` under grad mode (K8 has no backward pass).
    """
    refuse_autograd("flash_attention (K8)", q, k, v)
    s = q.shape[2]
    pad = (-s) % min(BLOCK, max(128, 1 << (s - 1).bit_length()))
    if pad and not causal:
        # Zero-padded keys are only provably masked under causal attention.
        raise ValueError("non-causal flash_attention requires tile-divisible S")
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
    out = flash_attention_kernel(
        q.contiguous(), k.contiguous(), v.contiguous(), scale=scale, causal=causal
    )
    return out[:, :, :s, :]
