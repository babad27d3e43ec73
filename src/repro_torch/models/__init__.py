"""The port's LM models: shared layers, the transformer (dense GQA, MLA,
MoE) and the MoE layer (the recsys and GNN models wait for ROADMAP queue 1
item 9.6)."""

from repro_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    count_active_params,
    count_params,
    decode_step,
    init_transformer,
    make_cache,
    prefill,
    transformer_logits,
)
