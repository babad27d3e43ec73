"""Full-float32 products.

Threshold decisions depend on full f32 scores: a TF32 product keeps about
three decimal digits and moves scores near ``t`` across it. Every plain
score or bound product of the port goes through :func:`dot_f32`, which turns
TF32 off before it multiplies; the LM's plain paths call :func:`exact_f32`.
"""

from __future__ import annotations

import torch


def exact_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN, so float32 products stay float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dot_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x · yᵀ`` over the last axis in full float32 (batched like matmul)."""
    exact_f32()
    return torch.matmul(x.float(), y.float().transpose(-1, -2))
