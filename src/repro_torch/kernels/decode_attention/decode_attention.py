"""Kernel K9: flash-decode partials over a KV cache (``csrc/decode_attention.cu``).

:func:`decode_attention_kernel` takes q ``(B, Hq, D)``, a cache k, v
``(B, Hkv, L, D)`` and ``lengths (B,)`` and returns the unnormalised
partial ``(acc (B, Hq, D), m (B, Hq), l (B, Hq))`` in f32 over the first
``min(lengths[b], L)`` positions of each sequence, with kv head = q head //
(Hq / Hkv). ``ops.combine_partials`` merges partials of cache shards;
``ops.decode_attention`` normalises one. On a CUDA tensor the wrapper
launches the kernel or raises, and adds one to
``LAUNCHES["decode_attention"]``; on a CPU tensor it returns
:func:`decode_attention_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import exact_f32
from repro_torch.kernels import _build

NEG_LARGE = -0.5e30
HEAD_DIMS = (16, 32, 64, 128)   # head dims the kernel is built for
GROUPS = (1, 2, 4, 8)           # q heads per kv head it is built for

# Kernel launches; a launch is counted only where it happens.
LAUNCHES = {"decode_attention": 0}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
):
    """K9's function in plain PyTorch over the whole cache, masked."""
    exact_f32()
    b, hq, d = q.shape
    hkv, L = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, hq // hkv, d).float() * scale
    s = torch.matmul(qg, k.float().transpose(-1, -2))        # (B, Hkv, G, L)
    valid = (
        torch.arange(L, device=q.device)[None, None, None, :]
        < lengths.to(q.device)[:, None, None, None]
    )
    s = torch.where(valid, s, NEG_LARGE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    acc = torch.matmul(p, v.float())
    return acc.reshape(b, hq, d), m.reshape(b, hq), p.sum(dim=-1).reshape(b, hq)


def decode_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float | None = None,
):
    """K9: ``(acc, m, l)`` partials of one cache shard."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA or CPU tensor, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != q.device or a.dtype != q.dtype:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; q is {q.dtype} on {q.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, d = q.shape
    hkv, L = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or hq // hkv not in GROUPS or L == 0:
        raise ValueError(
            f"K9 takes head dims {HEAD_DIMS}, groups {GROUPS} and L > 0; "
            f"got D={d}, group={hq // hkv}, L={L}"
        )
    lengths = lengths.to(q.device, torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    acc = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    suffix = "bf16" if q.dtype == torch.bfloat16 else "f32"
    fn, check = _build.bind(
        "decode_attention", f"decode_attention_{suffix}",
        [_VP] * 7 + [_I] * 5 + [_F, _VP], errors="attention_error_string",
    )
    check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq, hkv, L, d, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    LAUNCHES["decode_attention"] += 1
    return acc, m, l
