"""bert4rec [recsys] — embed_dim=64 n_blocks=2 n_heads=2 seq_len=200,
bidirectional masked sequence model. [arXiv:1904.06690; paper]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef, register
from repro_torch.configs.recsys_common import recsys_shapes
from repro_torch.core.apss import similarity_topk
from repro_torch.models import recsys
from repro_torch.models.layers import as_input, lookup


def config() -> recsys.Bert4RecConfig:
    return recsys.Bert4RecConfig(
        name="bert4rec", embed_dim=64, n_blocks=2, n_heads=2,
        seq_len=200, n_items=60_000, d_ff=256,
    )


def smoke_config() -> recsys.Bert4RecConfig:
    return recsys.Bert4RecConfig(
        name="bert4rec-smoke", embed_dim=16, n_blocks=1, n_heads=2,
        seq_len=16, n_items=500, d_ff=32,
    )


def _score(cfg, params, batch):
    return recsys.bert4rec_score(params, cfg, batch)


@torch.no_grad()
def _retrieve(cfg, params, batch, candidate_ids):
    """Next-item retrieval: encode the session, APSS-score vs candidates
    (``similarity_topk``'s plain path, on the params' device)."""
    h = recsys.bert4rec_encode(params, cfg, batch["item_ids"])[:, -1]        # (1, d)
    cand = lookup(params["item_table"], as_input(params, candidate_ids))   # (N, d)
    return similarity_topk(h, cand, threshold=0.0, k=256, block_rows=h.shape[0],
                           exclude_self=False, device=h.device)


ARCH = register(ArchDef(
    name="bert4rec",
    family="recsys",
    source="arXiv:1904.06690",
    make_config=config,
    make_smoke_config=smoke_config,
    shapes=recsys_shapes("bert4rec", recsys.init_bert4rec, recsys.bert4rec_param_specs, _score, _retrieve),
))
