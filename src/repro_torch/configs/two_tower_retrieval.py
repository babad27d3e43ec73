"""two-tower-retrieval [recsys] — embed_dim=256 tower_mlp=1024-512-256
dot-product interaction, sampled-softmax retrieval. Item table 10M×256,
user-feature table 1M×256 (hashed). [RecSys'19 (YouTube/Yi et al.)]"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef, register
from repro_torch.configs.recsys_common import recsys_shapes
from repro_torch.models import recsys


def config() -> recsys.TwoTowerConfig:
    return recsys.TwoTowerConfig(
        name="two-tower-retrieval",
        embed_dim=256,
        tower_dims=(1024, 512, 256),
        n_items=10_000_000,
        n_user_fields=8,
        user_vocab=1_000_000,
        history_len=50,
    )


def smoke_config() -> recsys.TwoTowerConfig:
    return recsys.TwoTowerConfig(
        name="two-tower-smoke",
        embed_dim=16,
        tower_dims=(64, 32, 16),
        n_items=1000,
        n_user_fields=4,
        user_vocab=500,
        history_len=10,
    )


def _score(cfg, params, batch):
    return recsys.two_tower_score(params, cfg, batch)


def _retrieve(cfg, params, batch, candidate_ids):
    return recsys.retrieval_scores(params, cfg, batch, candidate_ids, k=256)


ARCH = register(ArchDef(
    name="two-tower-retrieval",
    family="recsys",
    source="RecSys'19 (Yi et al.)",
    make_config=config,
    make_smoke_config=smoke_config,
    shapes=recsys_shapes("two-tower-retrieval", recsys.init_two_tower, recsys.two_tower_param_specs, _score, _retrieve),
))
