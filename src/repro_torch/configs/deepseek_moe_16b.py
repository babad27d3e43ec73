"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16, i.e. MHA)
fine-grained experts d_ff_expert=1408, layer 0 a dense FFN 8 experts wide,
vocab=102400, MoE: 2 shared + 64 routed top-6. [arXiv:2401.06066; hf]"""

import torch

from repro_torch.configs.base import register
from repro_torch.configs.lm_common import lm_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-moe-16b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408 * 8,          # layer-0 dense FFN (10944≈8 experts wide)
        vocab_size=102400,
        moe=True,
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared_experts=2,
        first_k_dense=1,
        capacity_factor=1.25,
        rope_theta=1e4,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-moe-16b-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        moe=True,
        n_experts=8,
        top_k=3,
        d_ff_expert=32,
        n_shared_experts=2,
        first_k_dense=1,
        capacity_factor=2.0,
        dtype=torch.float32,
        q_chunk=32, kv_chunk=32, loss_chunk=32,
    )


ARCH = register(lm_arch("deepseek-moe-16b", "arXiv:2401.06066", config, smoke_config))
