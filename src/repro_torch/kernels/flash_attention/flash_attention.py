"""Kernel K8: causal GQA flash attention, forward (``csrc/flash_attention.cu``).

:func:`flash_attention_kernel` takes q ``(B, Hq, S, D)`` and k, v
``(B, Hkv, S, D)`` (kv head = q head // (Hq / Hkv)) and returns
``softmax(scale · q·kᵀ)·v`` in q's dtype: f32 scores and softmax statistics
with the finite ``NEG_LARGE`` mask, ``acc / (l or 1)``. The source holds two
kernels: bf16 runs on the tensor cores (warpgroup MMA, the scale applied to
the f32 scores, P rounded to bf16 for P·V), f32 on the FMA units (q scaled in
f32, everything f32). On a CUDA tensor it launches the kernel or raises, and
adds one to ``LAUNCHES["flash_attention"]`` (and, with an op census
active, reports :func:`flash_work` to ``launch.op_analysis``); on a CPU
tensor it returns :func:`flash_attention_plain`, the same function in plain
PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import exact_f32
from repro_torch.kernels import _build
from repro_torch.launch import op_analysis

NEG_LARGE = -0.5e30
TILE = 64                       # the kernel's q and kv tile (csrc)
HEAD_DIMS = (16, 32, 64, 128)   # head dims the kernel is built for

# Kernel launches; a launch is counted only where it happens.
LAUNCHES = {"flash_attention": 0}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = True,
    rows: int = 1024,
) -> torch.Tensor:
    """K8's function in plain PyTorch, ``rows`` query rows at a time (the
    whole score row at once, so the sums run in another order)."""
    exact_f32()
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, hq // hkv, s, d)
    kf = k.float()[:, :, None].transpose(-1, -2)
    vf = v.float()[:, :, None]
    kpos = torch.arange(s, device=q.device)
    outs = []
    for r0 in range(0, s, rows):
        sc = torch.matmul(qg[:, :, :, r0:r0 + rows].float() * scale, kf)
        if causal:
            qpos = kpos[r0:r0 + rows]
            sc = torch.where(qpos[:, None] >= kpos[None, :], sc, NEG_LARGE)
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p, vf)
        outs.append((acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, hq, s, d)


def _check(name: str, a: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, q on {device}")
    if a.dtype != dtype:
        raise ValueError(f"{name} is {a.dtype}, q is {dtype}")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """K8 on ``S`` a multiple of :data:`TILE` (``ops.flash_attention`` pads)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA or CPU tensor, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check(name, a, q.dtype, q.device)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or s % TILE or s == 0:
        raise ValueError(
            f"K8 takes head dims {HEAD_DIMS} and S a positive multiple of {TILE}; "
            f"got D={d}, S={s}"
        )
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    suffix = "bf16" if q.dtype == torch.bfloat16 else "f32"
    fn, check = _build.bind(
        "flash_attention", f"flash_attention_{suffix}",
        [_VP] * 4 + [_I] * 5 + [_F, _I, _VP], errors="attention_error_string",
    )
    check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, s, d, float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    LAUNCHES["flash_attention"] += 1
    if op_analysis.CENSUS is not None:
        op_analysis.report_kernel("flash_attention", "flash_attention",
                                  *flash_work(b, hq, s, d, q.element_size(), causal))
    return out


def flash_work(b: int, hq: int, s: int, d: int, itemsize: int, causal: bool):
    """FLOPs and bytes of one K8 launch: every (q tile, kv tile) pair it
    computes (on and below the diagonal when causal), two products each;
    q read and the output written once, a k and a v tile read per pair."""
    nt = s // TILE
    pairs = nt * (nt + 1) // 2 if causal else nt * nt
    flops = 4.0 * b * hq * d * TILE * TILE * pairs
    return flops, 2 * b * hq * s * d * itemsize + 2 * b * hq * pairs * TILE * d * itemsize
