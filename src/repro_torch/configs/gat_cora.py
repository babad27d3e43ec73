"""gat-cora [gnn] — 2L d_hidden=8 n_heads=8 attention aggregator
[arXiv:1710.10903; paper].

The reference's shapes (full_graph_sm: Cora's n=2708 e=10556 d_feat=1433;
minibatch_lg: 1,024 seeds at fanout 15-10 through the neighbor sampler;
ogb_products; molecule) are cells of ROADMAP queue 1 item 9.8: ``shapes={}``
until then. The message passing is ``models/gnn.py``'s fixed-order segment
sums over padded edge lists.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef, register
from repro_torch.models.gnn import GATConfig


def config() -> GATConfig:
    return GATConfig(
        name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
        d_feat=1433, n_classes=7,
    )


def smoke_config() -> GATConfig:
    return GATConfig(
        name="gat-cora-smoke", n_layers=2, d_hidden=4, n_heads=2,
        d_feat=32, n_classes=5,
    )


ARCH = register(ArchDef(
    name="gat-cora",
    family="gnn",
    source="arXiv:1710.10903",
    make_config=config,
    make_smoke_config=smoke_config,
))
