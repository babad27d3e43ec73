"""bst [recsys] — embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256, Behavior Sequence Transformer (Alibaba).
[arXiv:1905.06874; paper]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef, register
from repro_torch.configs.recsys_common import recsys_shapes
from repro_torch.core.matches import stable_topk
from repro_torch.models import recsys
from repro_torch.models.layers import as_input


def config() -> recsys.BSTConfig:
    return recsys.BSTConfig(
        name="bst", embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
        mlp_dims=(1024, 512, 256), n_items=1_000_000, d_ff=128,
    )


def smoke_config() -> recsys.BSTConfig:
    return recsys.BSTConfig(
        name="bst-smoke", embed_dim=16, seq_len=8, n_blocks=1, n_heads=2,
        mlp_dims=(32, 16, 8), n_items=500, d_ff=32,
    )


def _score(cfg, params, batch):
    return recsys.bst_logits(params, cfg, batch)


@torch.no_grad()
def _retrieve(cfg, params, batch, candidate_ids):
    """Pointwise CTR scoring of the candidates against one user history;
    the top 256 ``(values, ids)``, lower id first on ties (``lax.top_k``)."""
    ids = as_input(params, candidate_ids)
    hist = as_input(params, batch["history"]).expand(ids.shape[0], cfg.seq_len - 1)
    logits = recsys.bst_logits(params, cfg, {"history": hist, "item_ids": ids})
    return stable_topk(logits, 256)


ARCH = register(ArchDef(
    name="bst",
    family="recsys",
    source="arXiv:1905.06874",
    make_config=config,
    make_smoke_config=smoke_config,
    shapes=recsys_shapes("bst", recsys.init_bst, recsys.bst_param_specs, _score, _retrieve),
))
