"""The port's LM model: shared layers and the dense GQA transformer
(MLA, MoE, recsys and GNN models wait for ROADMAP queue 1 item 9)."""

from repro_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    count_params,
    decode_step,
    init_transformer,
    make_cache,
    prefill,
    transformer_logits,
)
