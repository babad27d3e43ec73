"""Kernel K7: the thresholded dense score matrix, tile-gated by a block mask.

:func:`apss_block_kernel` (``csrc/apss_block.cu``) writes
``where(X·Yᵀ ≥ t & live, X·Yᵀ, 0)`` as ``(n_rows, n_cols)`` f32, where
``live`` is the caller's ``(n_rows/block_m, n_cols/block_n)`` block mask
(0 ⇒ the tile is provably dead: no product, zeros written). It is the
dense-output path behind ``ops.apss_block_matmul``; its ``O(n²)`` output
makes it a validation and benchmark tool, not the self-join's main path.

The kernel runs on the tensor cores in 128 × 128 output tiles
(``K7_TILE``): bf16 inputs in one bf16 pass, f32 inputs split into TF32
parts ``x = hi + lo`` and summed as ``hi·hi + hi·lo + lo·hi`` in three
passes (``K7_PASSES``), which keeps every score of unit vectors within
about 1e-6 of the exact product. :func:`apss_block_split_plain` computes
that split in plain PyTorch; only the tests call it.

On a CPU tensor the wrapper returns :func:`apss_block_plain`, a copy of the
reference package's ``apss_block_reference``; on a CUDA tensor it launches
the kernel or raises, and adds one to ``LAUNCHES["apss_block"]``.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import dot_f32
from repro_torch.kernels.apss_block.fused import (
    _I,
    _TILE,
    _TK,
    _VP,
    _F,
    LAUNCHES,
    _check_operand,
    _entry,
    _f32,
    _suffix,
    lazy,
)
from repro_torch.launch import op_analysis


K7_TILE = (128, 128)  # rows and columns of the kernel's output tile (csrc/apss_block.cu)
K7_PASSES = {torch.float32: 3, torch.bfloat16: 1}  # tensor-core passes a score


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the
    dropped 13 bits' range to the magnitude bits and clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def apss_block_split_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    threshold: float,
    *,
    block_mask: torch.Tensor | None = None,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """:func:`apss_block_plain` with the kernel's f32 arithmetic: each operand
    split as ``hi = tf32(v)``, ``lo = tf32(v - hi)`` and the scores summed as
    ``hi·hi + hi·lo + lo·hi`` (products of TF32 parts are exact in f32).
    A bf16 operand has ``lo = 0`` and gives the plain product."""
    xh = tf32_round(x)
    yh = tf32_round(y)
    xl = tf32_round(x.float() - xh)
    yl = tf32_round(y.float() - yh)
    s = dot_f32(xh, yh) + dot_f32(xh, yl) + dot_f32(xl, yh)
    return _masked(torch.where(s >= _f32(threshold), s, 0.0), block_mask, block_m, block_n)


def _masked(out, block_mask, block_m, block_n):
    if block_mask is not None:
        live = torch.as_tensor(block_mask).to(out.device, torch.bool)
        live = live.repeat_interleave(block_m, 0).repeat_interleave(block_n, 1)
        out = torch.where(live, out, 0.0)
    return out


def apss_block_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    threshold: float,
    *,
    block_mask: torch.Tensor | None = None,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Thresholded similarity scores ``where(S ≥ t, S, 0)``, zeroed on the
    tiles where ``block_mask`` is 0."""
    s = dot_f32(x, y)
    return _masked(torch.where(s >= _f32(threshold), s, 0.0), block_mask, block_m, block_n)


def apss_block_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    block_mask: torch.Tensor,
    threshold: float,
    *,
    block_m: int = 256,
    block_n: int = 256,
) -> torch.Tensor:
    """K7 on padded inputs: ``x (n_rows, m)``, ``y (n_cols, m)``,
    ``block_mask (n_rows/block_m, n_cols/block_n)``. Returns
    ``(n_rows, n_cols)`` f32."""
    if x.device.type == "cpu":
        return apss_block_plain(
            x, y, threshold, block_mask=block_mask, block_m=block_m, block_n=block_n
        )
    _check_operand("x", x)
    _check_operand("y", y)
    n_rows, m = x.shape
    n_cols = y.shape[0]
    if y.device != x.device or y.dtype != x.dtype or y.shape[1] != m:
        raise ValueError("x and y must share device, dtype and width")
    if n_rows % block_m or n_cols % block_n:
        raise ValueError(
            f"({n_rows}, {n_cols}) not tile-divisible by ({block_m}, {block_n})"
        )
    if block_m % _TILE or block_n % _TILE or m % _TK:
        raise ValueError(
            f"block_m, block_n must be multiples of {_TILE} and m of {_TK}; "
            f"got {block_m}, {block_n}, {m}"
        )
    mask = block_mask.to(x.device, torch.int32).contiguous()
    if tuple(mask.shape) != (n_rows // block_m, n_cols // block_n):
        raise ValueError(f"block_mask shape {tuple(mask.shape)} is not the grid")
    out = torch.empty((n_rows, n_cols), dtype=torch.float32, device=x.device)
    fn, check = _entry(
        "apss_block", f"apss_block_{_suffix(x.dtype)}", [_VP] * 4 + [_I] * 5 + [_F, _VP]
    )
    status = fn(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(), out.data_ptr(),
        n_rows, n_cols, m, block_m, block_n, _f32(threshold),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(status)
    LAUNCHES["apss_block"] += 1
    if op_analysis.CENSUS is not None:
        live = lazy(lambda: int(mask.count_nonzero()))
        op_analysis.report_kernel(
            "apss_block", "apss_block",
            lambda: 2.0 * live() * block_m * block_n * m * K7_PASSES[x.dtype],
            lambda: live() * (block_m + block_n) * m * x.element_size()
            + 4 * n_rows * n_cols + 4 * mask.numel())
    return out
