"""minicpm3-4b [dense] — 62L d_model=2560 40H (MLA) d_ff=6400 vocab=73448.
MLA dims follow the released model: q_lora 768, kv_lora 256, nope 64,
rope 32, v 64. [hf:openbmb/MiniCPM3-4B; hf]"""

import torch

from repro_torch.configs.base import ArchDef, register
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm3-4b",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=6400,
        vocab_size=73448,
        attention="mla",
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        rope_theta=1e6,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm3-4b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attention="mla",
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        dtype=torch.float32,
        q_chunk=32, kv_chunk=32,
    )


ARCH = register(ArchDef("minicpm3-4b", "lm", "hf:openbmb/MiniCPM3-4B", config, smoke_config))
