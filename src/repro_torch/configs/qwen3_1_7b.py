"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B family; hf]"""

import torch

from repro_torch.configs.base import register
from repro_torch.configs.lm_common import lm_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-1.7b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-1.7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        qk_norm=True,
        dtype=torch.float32,
        q_chunk=32, kv_chunk=32, loss_chunk=32,
    )


ARCH = register(lm_arch("qwen3-1.7b", "hf:Qwen/Qwen3-1.7B", config, smoke_config))
