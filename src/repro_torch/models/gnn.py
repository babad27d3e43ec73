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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.nn import functional as F

from repro_torch.core.precision import exact_f32
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
             device: str | torch.device = "cuda") -> ParamTree:
    """The reference's init laws (``w`` normal × √(2/(d_in+d_out)), the
    attention vectors normal × 0.1), drawn from ``generator`` (seed 0 when
    omitted) on ``device``."""
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
    return ParamTree({"layers": layers})


def gat_param_specs(cfg: GATConfig) -> dict:
    """Replicated, as the reference's (GAT's weights are tiny; its
    parallelism lies in the node and edge data), by parameter name."""
    return flat_specs({"layers": [{"w": (None, None), "a_src": (None, None),
                                   "a_dst": (None, None)} for _ in range(cfg.n_layers)]})


def segment_softmax(
    scores: torch.Tensor,       # (E, H)
    segments: torch.Tensor,     # (E,) destination node per edge
    num_segments: int,
    edge_mask: torch.Tensor,    # (E,)
) -> torch.Tensor:
    """Numerically stable softmax over the incoming edges of each node."""
    neg = -1e30
    s = torch.where(edge_mask[:, None] > 0, scores.float(), neg)
    smax = segment_max(s, segments, num_segments)
    smax = torch.clamp(smax, min=neg)  # empty segments
    ex = torch.exp(s - take(smax, segments)) * edge_mask[:, None]
    denom = segment_sum(ex, segments, num_segments)
    return ex / torch.clamp(take(denom, segments), min=1e-16)


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
) -> torch.Tensor:
    n = x.shape[0]
    h = torch.matmul(x, p["w"]).reshape(n, heads, d_out)
    # SDDMM: per-edge attention logits from endpoint projections.
    h32 = h.float()
    alpha_src = torch.einsum("nhd,hd->nh", h32, p["a_src"].float())
    alpha_dst = torch.einsum("nhd,hd->nh", h32, p["a_dst"].float())
    e = take(alpha_src, edge_src) + take(alpha_dst, edge_dst)      # (E, H)
    e = F.leaky_relu(e, negative_slope)
    att = segment_softmax(e, edge_dst, n, edge_mask)               # (E, H)
    # SpMM: attention-weighted sum of source features, per destination.
    msg = take(h, edge_src).float() * att[..., None]               # (E, H, D)
    agg = segment_sum(msg, edge_dst, n)                            # (N, H, D)
    if concat:
        return agg.reshape(n, heads * d_out).to(x.dtype)
    return torch.mean(agg, dim=1).to(x.dtype)


def gat_forward(params: ParamTree, cfg: GATConfig, batch: dict) -> torch.Tensor:
    """``(N, n_classes)`` logits of a graph batch."""
    exact_f32()
    x = as_input(params, batch["features"], cfg.dtype)
    src, dst = as_input(params, batch["edge_src"]), as_input(params, batch["edge_dst"])
    mask = as_input(params, batch["edge_mask"], torch.float32)
    for i, p in enumerate(params["layers"]):
        heads, d_out, last = _layer_dims(cfg, i)
        x = gat_layer(p, x, src, dst, mask, heads=heads, d_out=d_out,
                      negative_slope=cfg.negative_slope, concat=not last)
        if not last:
            x = F.elu(x)
    return x


def gat_loss(params: ParamTree, cfg: GATConfig, batch: dict):
    """Masked node-classification CE; returns ``(loss, {"loss", "acc"})``."""
    logits = gat_forward(params, cfg, batch).float()
    labels = as_input(params, batch["labels"]).long()
    mask = as_input(params, batch["label_mask"], torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    nll = (lse - gold) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    pred = torch.argmax(logits, dim=-1)
    acc = torch.sum((pred == labels) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"loss": loss, "acc": acc}
