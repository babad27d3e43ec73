"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + a dense residual FFN (Arctic's
dense-MoE hybrid). About 480 B parameters: 960 GB in bf16, more than one
card or four hold, so only its smoke config runs; the full config is
counted on the meta device. [hf:Snowflake/snowflake-arctic-base; hf]"""

import torch

from repro_torch.configs.base import register
from repro_torch.configs.lm_common import lm_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        moe=True,
        n_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual=True,
        capacity_factor=1.25,
        rope_theta=1e6,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=96,
        vocab_size=512,
        moe=True,
        n_experts=8,
        top_k=2,
        d_ff_expert=96,
        dense_residual=True,
        capacity_factor=2.0,
        dtype=torch.float32,
        q_chunk=32, kv_chunk=32, loss_chunk=32,
    )


ARCH = register(lm_arch("arctic-480b", "hf:Snowflake/snowflake-arctic-base", config,
                        smoke_config))
