"""gat-cora [gnn] — 2L d_hidden=8 n_heads=8 attention aggregator
[arXiv:1710.10903; paper].

Shapes (the reference's):
  full_graph_sm   n=2708  e=10556     d_feat=1433  (full-batch, Cora)
  minibatch_lg    n=232965 e=114.6M   batch=1024 fanout 15-10 (sampled)
  ogb_products    n=2449029 e=61.9M   d_feat=100   (full-batch-large)
  molecule        n=30 e=64 batch=128              (batched-small-graphs)

Message passing is ``models/gnn.py``'s fixed-order segment sums over
padded edge lists. Sampled shapes take the padded batch the neighbor
sampler emits (``data.sampler.sampled_shape``). The reference shards the
nodes and edges of the large graphs over the data axes and lets GSPMD add
the cross-shard partials; the port cuts them the same way
(``layout``: ``gnn.graph_specs`` of ``gnn.graph_axes``) and its step adds
the partials itself (``gat_loss(graph_axes=)``: gathers, a max and sums
in rank order over the data axes, a reduce-scatter onto each node's
owner). ``full_graph_sm`` replicates its graph, as the reference's. The
weights replicate (``gat_param_specs``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import (
    ArchDef, CellBuild, ShapeCell, data_axes_of, meta, register, shardings_for,
)
from repro_torch.data.sampler import sampled_shape
from repro_torch.launch.train import make_gat_train_step, params_of
from repro_torch.models.gnn import GATConfig, gat_param_specs, graph_axes, graph_specs, init_gat
from repro_torch.optim import adamw_init
from repro_torch.optim.optimizer import AdamWState


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


def _graph(n_nodes: int, n_edges: int, d_feat: int) -> dict:
    return {
        "features": meta((n_nodes, d_feat), torch.float32),
        "edge_src": meta((n_edges,), torch.int32),
        "edge_dst": meta((n_edges,), torch.int32),
        "edge_mask": meta((n_edges,), torch.float32),
        "labels": meta((n_nodes,), torch.int32),
        "label_mask": meta((n_nodes,), torch.float32),
    }


def _build_graph_cell(cfg: GATConfig, mesh, *, n_nodes: int, n_edges: int, d_feat: int,
                      shard_edges: bool) -> CellBuild:
    cfg = dataclasses.replace(cfg, d_feat=d_feat)
    params = init_gat(cfg, device="meta")
    opt = adamw_init(params_of(params))
    ax = data_axes_of(mesh) if shard_edges else None
    batch_sh = {
        "features": (ax, None), "edge_src": (ax,), "edge_dst": (ax,), "edge_mask": (ax,),
        "labels": (ax,), "label_mask": (ax,),
    }
    axes = graph_axes(mesh, n_nodes, n_edges) if shard_edges else ((), ())
    specs = gat_param_specs(cfg)
    p_sh = shardings_for(mesh, specs)
    o_sh = shardings_for(mesh, AdamWState(step=(), m=specs, v=specs))
    # model flops: dominated by the dense projections, 2·nnz(W)·n_nodes per
    # layer, plus the per-edge attention and messages; ×3 for training
    l1 = 2 * n_nodes * d_feat * cfg.d_hidden * cfg.n_heads
    l2 = 2 * n_nodes * cfg.d_hidden * cfg.n_heads * cfg.n_classes
    edge_work = 4 * n_edges * cfg.n_heads * cfg.d_hidden
    return CellBuild(
        fn=make_gat_train_step(cfg, graph_axes=axes),
        args=(params, opt, _graph(n_nodes, n_edges, d_feat)),
        in_shardings=(p_sh, o_sh, shardings_for(mesh, batch_sh)),
        out_shardings=(p_sh, o_sh, None),
        static_info={"model_flops": 3 * (l1 + l2 + edge_work), "kind": "train",
                     "n_nodes": n_nodes, "n_edges": n_edges},
        layout=(None, None, graph_specs(axes)),
    )


_SAMPLED_N, _SAMPLED_E = sampled_shape(1024, (15, 10))
_MOL_N, _MOL_E = 30 * 128, 64 * 128 + 30 * 128  # + self loops

ARCH = register(ArchDef(
    name="gat-cora",
    family="gnn",
    source="arXiv:1710.10903",
    make_config=config,
    make_smoke_config=smoke_config,
    shapes={
        "full_graph_sm": ShapeCell(
            kind="train",
            desc="n=2708 e=10556 d_feat=1433 (full-batch); graph replicated "
                 "(Cora is tiny), params/compute sharded",
            build=lambda cfg, mesh: _build_graph_cell(
                cfg, mesh, n_nodes=2708, n_edges=2 * 10556 + 2708,
                d_feat=1433, shard_edges=False),
        ),
        "minibatch_lg": ShapeCell(
            kind="train",
            desc=f"sampled batch_nodes=1024 fanout 15-10 → padded "
                 f"n={_SAMPLED_N} e={_SAMPLED_E} (real neighbor sampler)",
            build=lambda cfg, mesh: _build_graph_cell(
                cfg, mesh, n_nodes=_SAMPLED_N, n_edges=_SAMPLED_E,
                d_feat=602, shard_edges=True),   # reddit-like d_feat
        ),
        "ogb_products": ShapeCell(
            kind="train",
            desc="n=2449029 e=61859140 d_feat=100 (full-batch-large), "
                 "nodes+edges sharded over data axes",
            build=lambda cfg, mesh: _build_graph_cell(
                cfg, mesh, n_nodes=2449408,      # padded to /512
                n_edges=61859840, d_feat=100, shard_edges=True),
        ),
        "molecule": ShapeCell(
            kind="train",
            desc="batch=128 graphs of n=30 e=64 (block-diagonal packing)",
            build=lambda cfg, mesh: _build_graph_cell(
                cfg, mesh, n_nodes=_MOL_N, n_edges=_MOL_E,
                d_feat=30, shard_edges=True),
        ),
    },
))
