"""GNN family: GAT (arXiv:1710.10903) via edge-index message passing.

The reference's ``models/gnn.py`` in PyTorch: per-edge attention scores
from the endpoint projections (SDDMM) → a softmax over each node's incoming
edges (``segment_max`` + ``segment_sum``) → an attention-weighted sum of
the source features (SpMM). The segment sums run in a fixed order on every
device (``models/layers.segment_sum``); the per-edge gathers are
``F.embedding`` lookups (``models/layers.take``), so a training step has
the same bits on every run.

Graph batches are dicts of padded arrays (numpy or tensors):
  features (N, F) · edge_src (E,) · edge_dst (E,) · edge_mask (E,) ·
  labels (N,) · label_mask (N,)

Parameters are a :class:`~repro_torch.models.layers.ParamTree` of the
reference's tree: ``{"layers": [{"w": (d_in, heads·d_out), "a_src": (heads,
d_out), "a_dst"}, ...]}``.

On a mesh the weights replicate (``gat_param_specs``) and the graph may be
cut over the data axes as the reference's cells place it
(:func:`graph_specs`): the nodes (``features``, ``labels``,
``label_mask``) and the edges (``edge_src``, ``edge_dst``, ``edge_mask``)
each into blocks, where the axes divide their count
(:func:`graph_axes`; :func:`cut_graph` gives a rank its blocks). Edge ids
stay global. ``gat_forward(graph_axes=)`` then runs each layer on the
rank's blocks under the active mesh: ``h`` and the attention terms of the
rank's nodes, gathered over the node axes for the per-edge lookups; the
segment max of the rank's edges, then the max over the edge axes; the
softmax denominators and the ``(N, H, D)`` aggregation partials summed
over the edge axes in rank order in f32, the aggregation onto each node's
owner (a reduce-scatter). Every collective's backward is its transpose, and
``gat_loss`` is the rank's masked NLL over the global label count times
the data ranks, so the trainer's mean over the data axes is the whole
graph's step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch
from torch.nn import functional as F

from repro_torch.core.precision import exact_f32
from repro_torch.distributed.sharding import active_mesh, block_of
from repro_torch.interop import device_of
from repro_torch.models.layers import (
    ParamTree,
    as_input,
    dense_init,
    flat_specs,
    segment_max,
    segment_sum,
    take,
)


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_feat: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: Any = torch.float32


def _layer_dims(cfg: GATConfig, i: int) -> tuple[int, int, bool]:
    """``(heads, d_out, last)`` of layer ``i``."""
    last = i == cfg.n_layers - 1
    return (1 if last else cfg.n_heads), (cfg.n_classes if last else cfg.d_hidden), last


def init_gat(cfg: GATConfig, *, generator: torch.Generator | None = None,
             device: str | torch.device = "cuda", mesh=None) -> ParamTree:
    """The reference's init laws (``w`` normal × √(2/(d_in+d_out)), the
    attention vectors normal × 0.1), drawn from ``generator`` (seed 0 when
    omitted) on ``device``. The weights replicate on a ``mesh``
    (``gat_param_specs``), so every rank holds them whole."""
    dev = device_of(device)
    if generator is None:
        generator = None if dev.type == "meta" else torch.Generator(dev).manual_seed(0)
    layers = []
    d_in = cfg.d_feat
    for i in range(cfg.n_layers):
        heads, d_out, last = _layer_dims(cfg, i)

        def vec():
            return (torch.randn((heads, d_out), generator=generator, device=dev)
                    * 0.1).to(cfg.dtype)

        layers.append({"w": dense_init(generator, d_in, heads * d_out, cfg.dtype, dev),
                       "a_src": vec(), "a_dst": vec()})
        d_in = d_out if last else cfg.d_hidden * cfg.n_heads
    tree = ParamTree({"layers": layers})
    tree.cfg, tree.build = cfg, functools.partial(init_gat, cfg)
    return tree


def gat_param_specs(cfg: GATConfig) -> dict:
    """Replicated, as the reference's (GAT's weights are tiny; its
    parallelism lies in the node and edge data), by parameter name."""
    return flat_specs({"layers": [{"w": (None, None), "a_src": (None, None),
                                   "a_dst": (None, None)} for _ in range(cfg.n_layers)]})


def graph_specs(axes: tuple = ((), ())) -> dict:
    """The placement of a graph batch's entries: nodes over ``axes[0]``,
    edges over ``axes[1]`` (``()``: replicated), as the reference's
    ``batch_sh``."""
    nodes, edges = (a if a else None for a in axes)
    return {"features": (nodes, None), "edge_src": (edges,), "edge_dst": (edges,),
            "edge_mask": (edges,), "labels": (nodes,), "label_mask": (nodes,)}


def graph_axes(mesh, n_nodes: int, n_edges: int) -> tuple:
    """``(node axes, edge axes)``: the mesh's data axes for the nodes and for
    the edges of a graph of ``n_nodes`` and ``n_edges``, each ``()`` where
    their size does not divide the count (``elastic``'s rule)."""
    from repro_torch.distributed.elastic import _axis_sizes, _filter_spec_for

    sizes = _axis_sizes(mesh)
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    if not daxes:
        return (), ()
    return tuple(_filter_spec_for(mesh, (daxes,), (n,))[0] or () for n in (n_nodes, n_edges))


def cut_graph(graph: dict, axes: tuple, mesh) -> dict:
    """This rank's blocks of a whole graph batch placed by
    ``graph_specs(axes)`` (views of numpy arrays or tensors)."""
    specs = graph_specs(axes)
    return {k: block_of(v, specs[k], mesh) if k in specs else v for k, v in graph.items()}


class _Split(NamedTuple):
    """A graph cut over a mesh's data axes (``graph_axes``)."""

    mesh: Any
    nodes: tuple
    edges: tuple


def segment_softmax(
    scores: torch.Tensor,       # (E, H)
    segments: torch.Tensor,     # (E,) destination node per edge
    num_segments: int,
    edge_mask: torch.Tensor,    # (E,)
    split: _Split | None = None,
) -> torch.Tensor:
    """Numerically stable softmax over the incoming edges of each node. With
    the edges cut over ``split.edges``, each rank's segment max is maxed
    over those axes (no gradient: the softmax does not depend on it) and
    its denominators summed over them in rank order."""
    from repro_torch.core.distributed import pmax_over, psum_shared

    neg = -1e30
    s = torch.where(edge_mask[:, None] > 0, scores.float(), neg)
    smax = segment_max(s, segments, num_segments)
    if split is not None and split.edges:
        smax = pmax_over(smax, split.mesh, split.edges)
    smax = torch.clamp(smax, min=neg)  # empty segments
    ex = torch.exp(s - take(smax, segments)) * edge_mask[:, None]
    denom = segment_sum(ex, segments, num_segments)
    if split is not None and split.edges:
        denom = psum_shared(denom, split.mesh, split.edges)
    return ex / torch.clamp(take(denom, segments), min=1e-16)


def _to_owner(agg: torch.Tensor, n_loc: int, split: _Split | None) -> torch.Tensor:
    """The whole graph's ``(N, …)`` aggregation partials of this rank's edges
    as the rank's nodes' sums: reduce-scattered onto the owners (nodes and
    edges cut), summed over the edge axes (edges cut), the rank's block
    (nodes cut), or as they are."""
    from repro_torch.core.distributed import (
        _axis_index,
        psum_shared,
        reduce_scatter_owned,
    )

    if split is None:
        return agg
    if split.nodes and split.edges:
        return reduce_scatter_owned(agg, split.mesh, split.nodes, 0)
    if split.edges:
        return psum_shared(agg, split.mesh, split.edges)
    if split.nodes:
        return agg.narrow(0, _axis_index(split.mesh, split.nodes) * n_loc, n_loc)
    return agg


def gat_layer(
    p: ParamTree,
    x: torch.Tensor,          # (N, F)
    edge_src: torch.Tensor,   # (E,)
    edge_dst: torch.Tensor,   # (E,)
    edge_mask: torch.Tensor,  # (E,)
    *,
    heads: int,
    d_out: int,
    negative_slope: float,
    concat: bool,
    split: _Split | None = None,
) -> torch.Tensor:
    n_loc = x.shape[0]
    h = torch.matmul(x, p["w"]).reshape(n_loc, heads, d_out)
    # SDDMM: per-edge attention logits from endpoint projections.
    h32 = h.float()
    alpha_src = torch.einsum("nhd,hd->nh", h32, p["a_src"].float())
    alpha_dst = torch.einsum("nhd,hd->nh", h32, p["a_dst"].float())
    if split is not None and split.nodes:
        # every node's terms for the rank's edges (gradients reduce-scattered)
        from repro_torch.core.distributed import gather_for_use

        h, alpha_src, alpha_dst = (gather_for_use(t, split.mesh, split.nodes, 0)
                                   for t in (h, alpha_src, alpha_dst))
    n = h.shape[0]
    e = take(alpha_src, edge_src) + take(alpha_dst, edge_dst)      # (E, H)
    e = F.leaky_relu(e, negative_slope)
    att = segment_softmax(e, edge_dst, n, edge_mask, split)        # (E, H)
    # SpMM: attention-weighted sum of source features, per destination.
    msg = take(h, edge_src).float() * att[..., None]               # (E, H, D)
    agg = _to_owner(segment_sum(msg, edge_dst, n), n_loc, split)   # (N_loc, H, D)
    if concat:
        return agg.reshape(n_loc, heads * d_out).to(x.dtype)
    return torch.mean(agg, dim=1).to(x.dtype)


def _split_of(graph_axes) -> _Split | None:
    if not graph_axes or not any(graph_axes):
        return None
    return _Split(active_mesh(), *(tuple(a) for a in graph_axes))


def gat_forward(params: ParamTree, cfg: GATConfig, batch: dict, *,
                graph_axes: tuple | None = None) -> torch.Tensor:
    """``(N, n_classes)`` logits of a graph batch; with ``graph_axes``
    (:func:`graph_axes`) the batch is this rank's blocks on the active mesh
    and the logits are its nodes'."""
    exact_f32()
    split = _split_of(graph_axes)
    x = as_input(params, batch["features"], cfg.dtype)
    src, dst = as_input(params, batch["edge_src"]), as_input(params, batch["edge_dst"])
    mask = as_input(params, batch["edge_mask"], torch.float32)
    for i, p in enumerate(params["layers"]):
        heads, d_out, last = _layer_dims(cfg, i)
        x = gat_layer(p, x, src, dst, mask, heads=heads, d_out=d_out,
                      negative_slope=cfg.negative_slope, concat=not last, split=split)
        if not last:
            x = F.elu(x)
    return x


def gat_loss(params: ParamTree, cfg: GATConfig, batch: dict, *,
             graph_axes: tuple | None = None):
    """Masked node-classification CE; returns ``(loss, {"loss", "acc"})``.
    With the nodes cut over the data axes (``graph_axes``) the loss and the
    accuracy are the rank's sums over the global label count times the data
    ranks (their mean over the data axes is the whole graph's)."""
    logits = gat_forward(params, cfg, batch, graph_axes=graph_axes).float()
    labels = as_input(params, batch["labels"]).long()
    mask = as_input(params, batch["label_mask"], torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    nll = (lse - gold) * mask
    cnt = torch.sum(mask)
    scale = 1.0
    nodes = graph_axes[0] if graph_axes else ()
    if nodes:
        from repro_torch.core.distributed import _axis_size, psum_in_order

        mesh = active_mesh()
        cnt = psum_in_order(cnt.detach(), mesh, tuple(nodes))
        scale = _axis_size(mesh, tuple(nodes))
    loss = torch.sum(nll) / torch.clamp(cnt, min=1.0) * scale
    pred = torch.argmax(logits, dim=-1)
    acc = torch.sum((pred == labels) * mask) / torch.clamp(cnt, min=1.0) * scale
    return loss, {"loss": loss, "acc": acc}
