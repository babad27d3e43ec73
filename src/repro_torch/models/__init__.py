"""The port's models: shared layers, the LM transformer (dense GQA, MLA,
MoE) and the MoE layer, the recsys family (two-tower, BERT4Rec, DIN, BST)
and the GNN family (GAT). Expert parallelism over a mesh is
``moe.moe_ffn_ep``; the sequence-sharded decode is ``transformer.decode_step``
on a cache made with ``make_cache(mesh=)``."""

from repro_torch.models import gnn, recsys  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    count_active_params,
    count_params,
    decode_step,
    init_transformer,
    make_cache,
    prefill,
    transformer_logits,
    transformer_loss,
)
