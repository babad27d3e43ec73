"""din [recsys] — embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80,
target attention over user history. [arXiv:1706.06978; paper]"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef, register
from repro_torch.configs.recsys_common import recsys_shapes
from repro_torch.core.matches import stable_topk
from repro_torch.models import recsys
from repro_torch.models.layers import as_input


def config() -> recsys.DINConfig:
    return recsys.DINConfig(
        name="din", embed_dim=18, seq_len=100,
        attn_dims=(80, 40), mlp_dims=(200, 80), n_items=1_000_000,
    )


def smoke_config() -> recsys.DINConfig:
    return recsys.DINConfig(
        name="din-smoke", embed_dim=8, seq_len=12,
        attn_dims=(16, 8), mlp_dims=(32, 16), n_items=500,
    )


def _score(cfg, params, batch):
    return recsys.din_logits(params, cfg, batch)


@torch.no_grad()
def _retrieve(cfg, params, batch, candidate_ids):
    """Pointwise CTR scoring of the candidates against one user history;
    the top 256 ``(values, ids)``, lower id first on ties (``lax.top_k``)."""
    ids = as_input(params, candidate_ids)
    hist = as_input(params, batch["history"]).expand(ids.shape[0], cfg.seq_len)
    logits = recsys.din_logits(params, cfg, {"history": hist, "item_ids": ids})
    return stable_topk(logits, 256)


ARCH = register(ArchDef(
    name="din",
    family="recsys",
    source="arXiv:1706.06978",
    make_config=config,
    make_smoke_config=smoke_config,
    shapes=recsys_shapes("din", recsys.init_din, recsys.din_param_specs, _score, _retrieve),
))
