"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""

import torch

from repro_torch.configs.base import register
from repro_torch.configs.lm_common import lm_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-8b",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-8b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        qk_norm=True,
        dtype=torch.float32,
        q_chunk=32, kv_chunk=32, loss_chunk=32,
    )


ARCH = register(lm_arch("qwen3-8b", "hf:Qwen/Qwen3-8B", config, smoke_config))
