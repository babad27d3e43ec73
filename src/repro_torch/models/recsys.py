"""RecSys model family: two-tower retrieval, BERT4Rec, DIN, BST.

The reference's ``models/recsys.py`` in PyTorch. The hot path in every
ranking and retrieval model is the sparse embedding lookup:
:func:`embedding_bag` (fixed-width multi-hot bags) and
:func:`embedding_bag_ragged` (a fixed-order segment sum) are built from
``models/layers.take`` (``F.embedding``), whose backward adds into a row in
a fixed order. History ids of −1 are padding: they are clamped to row 0
before a lookup and masked after it, as in the reference.

``retrieval_scores`` (one query × 10⁶ candidates) routes through the port's
``core.apss.similarity_topk`` on its plain path: candidate retrieval is the
paper's similarity problem.

Parameters are a :class:`~repro_torch.models.layers.ParamTree` of the
reference's tree (matrices ``(d_in, d_out)``), so ``interop`` carries a
reference tree across leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.nn import functional as F

from repro_torch.core.apss import similarity_topk
from repro_torch.core.matches import Matches
from repro_torch.core.precision import exact_f32
from repro_torch.interop import device_of
from repro_torch.models.layers import (
    ParamTree,
    as_input,
    chunked_attention,
    dense_init,
    embed_init,
    flat_specs,
    mlp,
    rms_norm,
    segment_sum,
    take,
)

# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------


def embedding_bag(
    table: torch.Tensor,            # (V, E)
    ids: torch.Tensor,              # (B, L) int, -1 = padding
    weights: torch.Tensor | None = None,  # (B, L)
    *,
    mode: str = "sum",
) -> torch.Tensor:
    """Fixed-width multi-hot bag lookup: gather rows, mask, reduce."""
    valid = (ids >= 0).to(table.dtype)
    emb = take(table, torch.clamp(ids, min=0))                 # (B, L, E)
    w = valid if weights is None else weights * valid
    emb = emb * w[..., None]
    s = torch.sum(emb, dim=1)
    if mode == "sum":
        return s
    if mode == "mean":
        return s / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
    raise ValueError(mode)


def embedding_bag_ragged(
    table: torch.Tensor,        # (V, E)
    flat_ids: torch.Tensor,     # (N,) int
    segment_ids: torch.Tensor,  # (N,) int bag index per id
    num_segments: int,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ragged EmbeddingBag: a lookup, then a fixed-order segment sum."""
    emb = take(table, flat_ids)
    if weights is not None:
        emb = emb * weights[:, None]
    return segment_sum(emb, segment_ids, num_segments)


def _generator(device, generator):
    """``(device, generator)``: seed 0 on ``device`` when ``generator`` is
    omitted; none on the meta device, whose tensors hold no values."""
    dev = device_of(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(dev).manual_seed(0)
    return dev, generator


def _stack(gen, dims, d_in: int, dtype, dev) -> dict:
    """An MLP's ``{"w": [...], "b": [...]}`` from ``d_in`` through ``dims``."""
    ws, bs = [], []
    for d_out in dims:
        ws.append(dense_init(gen, d_in, d_out, dtype, dev))
        bs.append(torch.zeros((d_out,), dtype=dtype, device=dev))
        d_in = d_out
    return {"w": ws, "b": bs}


# ---------------------------------------------------------------------------
# Two-tower retrieval (Yi et al., RecSys'19)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_dims: tuple = (1024, 512, 256)
    n_items: int = 10_000_000
    n_user_fields: int = 8
    user_vocab: int = 1_000_000
    history_len: int = 50
    temperature: float = 0.05
    dtype: Any = torch.float32


def init_two_tower(cfg: TwoTowerConfig, *, generator: torch.Generator | None = None,
                   device: str | torch.device = "cuda") -> ParamTree:
    """The reference's init laws on ``device`` (seed 0 when ``generator`` is
    omitted): tables 0.02 × normal, tower matrices normal × √(2/(d_in+d_out)),
    biases zero."""
    dev, gen = _generator(device, generator)
    d_user_in = cfg.embed_dim * (cfg.n_user_fields + 1)  # fields + history bag
    return ParamTree({
        "item_table": embed_init(gen, cfg.n_items, cfg.embed_dim, cfg.dtype, dev),
        "user_table": embed_init(gen, cfg.user_vocab, cfg.embed_dim, cfg.dtype, dev),
        "user_tower": _stack(gen, cfg.tower_dims, d_user_in, cfg.dtype, dev),
        "item_tower": _stack(gen, cfg.tower_dims, cfg.embed_dim, cfg.dtype, dev),
    })


def two_tower_param_specs(cfg: TwoTowerConfig) -> dict:
    """The reference's layout, by parameter name: tables row-sharded over
    ``model``, tower matrices column-sharded."""
    return flat_specs({
        "item_table": ("model", None),
        "user_table": ("model", None),
        "user_tower": {"w": [(None, "model")] * 3, "b": [("model",)] * 3},
        "item_tower": {"w": [(None, "model")] * 3, "b": [("model",)] * 3},
    })


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(torch.square(x.float()), dim=-1, keepdim=True))
    return x / torch.clamp(n, min=1e-6).to(x.dtype)


def user_embedding(params: ParamTree, cfg: TwoTowerConfig, batch) -> torch.Tensor:
    exact_f32()
    fields = take(params["user_table"], as_input(params, batch["user_fields"]))  # (B, F, E)
    hist = embedding_bag(params["item_table"], as_input(params, batch["history"]),
                         mode="mean")                                       # (B, E)
    x = torch.cat([fields.reshape(fields.shape[0], -1), hist], dim=-1)
    t = params["user_tower"]
    return _l2norm(mlp(x, t["w"], t["b"]))


def item_embedding(params: ParamTree, cfg: TwoTowerConfig, item_ids) -> torch.Tensor:
    exact_f32()
    x = take(params["item_table"], as_input(params, item_ids))
    t = params["item_tower"]
    return _l2norm(mlp(x, t["w"], t["b"]))


def two_tower_loss(params: ParamTree, cfg: TwoTowerConfig, batch):
    """In-batch sampled softmax with the logQ correction."""
    u = user_embedding(params, cfg, batch)              # (B, E)
    i = item_embedding(params, cfg, batch["item_ids"])  # (B, E)
    logits = torch.matmul(u, i.T).float() / cfg.temperature
    logq = batch.get("sampling_logq")
    if logq is not None:
        logits = logits - as_input(params, logq, torch.float32)[None, :]
    labels = torch.arange(u.shape[0], device=u.device)
    nll = -torch.diagonal(torch.log_softmax(logits, dim=-1))
    loss = torch.mean(nll)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return loss, {"loss": loss, "in_batch_acc": acc}


def two_tower_score(params: ParamTree, cfg: TwoTowerConfig, batch) -> torch.Tensor:
    """Pointwise (user, item) scores."""
    u = user_embedding(params, cfg, batch)
    i = item_embedding(params, cfg, batch["item_ids"])
    return torch.sum(u * i, dim=-1) / cfg.temperature


@torch.no_grad()
def retrieval_scores(
    params: ParamTree, cfg: TwoTowerConfig, batch, candidate_ids, *, k: int = 256,
    threshold: float = 0.0, block_rows: int = 4096,
) -> Matches:
    """Score one (or a few) queries against a large candidate corpus: the
    item tower embeds the candidates, then ``similarity_topk`` (plain path)
    keeps each query's top ``k`` at ``threshold`` on the params' device."""
    u = user_embedding(params, cfg, batch)              # (Q, E)
    c = item_embedding(params, cfg, candidate_ids)      # (N, E)
    return similarity_topk(u, c, threshold, k=k, block_rows=u.shape[0],
                           exclude_self=False, device=u.device)


# ---------------------------------------------------------------------------
# BERT4Rec (arXiv:1904.06690) — bidirectional masked sequence model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_items: int = 60_000
    d_ff: int = 256
    dtype: Any = torch.float32

    @property
    def mask_token(self) -> int:
        return self.n_items  # first padding row of the padded table

    @property
    def padded_items(self) -> int:
        """Table rows incl. [MASK], padded to 512 for vocab sharding."""
        return ((self.n_items + 1 + 511) // 512) * 512


def init_bert4rec(cfg: Bert4RecConfig, *, generator: torch.Generator | None = None,
                  device: str | torch.device = "cuda") -> ParamTree:
    dev, gen = _generator(device, generator)
    d, dt = cfg.embed_dim, cfg.dtype

    def ones(n):
        return torch.ones((n,), dtype=dt, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=dev)

    blocks = [{
        "attn_norm": ones(d),
        "wq": dense_init(gen, d, d, dt, dev),
        "wk": dense_init(gen, d, d, dt, dev),
        "wv": dense_init(gen, d, d, dt, dev),
        "wo": dense_init(gen, d, d, dt, dev),
        "ffn_norm": ones(d),
        "w1": dense_init(gen, d, cfg.d_ff, dt, dev),
        "b1": zeros(cfg.d_ff),
        "w2": dense_init(gen, cfg.d_ff, d, dt, dev),
        "b2": zeros(d),
    } for _ in range(cfg.n_blocks)]
    return ParamTree({
        "item_table": embed_init(gen, cfg.padded_items, d, dt, dev),
        "pos_table": embed_init(gen, cfg.seq_len, d, dt, dev),
        "blocks": blocks,
        "final_norm": ones(d),
    })


def bert4rec_param_specs(cfg: Bert4RecConfig) -> dict:
    """The reference's layout, by parameter name."""
    blk = {
        "attn_norm": (None,), "wq": (None, "model"), "wk": (None, "model"),
        "wv": (None, "model"), "wo": ("model", None), "ffn_norm": (None,),
        "w1": (None, "model"), "b1": ("model",),
        "w2": ("model", None), "b2": (None,),
    }
    return flat_specs({
        "item_table": ("model", None),
        "pos_table": (None, None),
        "blocks": [dict(blk) for _ in range(cfg.n_blocks)],
        "final_norm": (None,),
    })


def bert4rec_encode(params: ParamTree, cfg: Bert4RecConfig, item_ids) -> torch.Tensor:
    exact_f32()
    item_ids = as_input(params, item_ids)
    b, s = item_ids.shape
    x = take(params["item_table"], item_ids)
    x = x + params["pos_table"][None, :s]
    d, h = cfg.embed_dim, cfg.n_heads
    hd = d // h
    for p in params["blocks"]:
        xn = rms_norm(x, p["attn_norm"])
        q, k, v = (torch.matmul(xn, p[w]).reshape(b, s, h, hd).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        o = chunked_attention(q, k, v, causal=False, q_chunk=min(128, s),
                              kv_chunk=min(128, s))
        o = o.transpose(1, 2).reshape(b, s, d)
        x = x + torch.matmul(o, p["wo"])
        xn = rms_norm(x, p["ffn_norm"])
        hh = F.gelu(torch.matmul(xn, p["w1"]) + p["b1"], approximate="tanh")
        x = x + torch.matmul(hh, p["w2"]) + p["b2"]
    return rms_norm(x, params["final_norm"])


def bert4rec_loss(params: ParamTree, cfg: Bert4RecConfig, batch):
    """Masked-item prediction (cloze) CE over the masked positions."""
    h = bert4rec_encode(params, cfg, batch["item_ids"])     # (B, S, d)
    logits = torch.matmul(h.float(), params["item_table"][:cfg.n_items].float().T)
    labels = as_input(params, batch["labels"]).long()
    mask = as_input(params, batch["mask"], torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"loss": loss}


def bert4rec_score(params: ParamTree, cfg: Bert4RecConfig, batch) -> torch.Tensor:
    """Next-item scores from the final position (serving)."""
    h = bert4rec_encode(params, cfg, batch["item_ids"])
    return torch.matmul(h[:, -1].float(), params["item_table"][:cfg.n_items].float().T)


# ---------------------------------------------------------------------------
# DIN (arXiv:1706.06978) — target attention over user history
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_dims: tuple = (80, 40)
    mlp_dims: tuple = (200, 80)
    n_items: int = 1_000_000
    dtype: Any = torch.float32


def init_din(cfg: DINConfig, *, generator: torch.Generator | None = None,
             device: str | torch.device = "cuda") -> ParamTree:
    dev, gen = _generator(device, generator)
    e = cfg.embed_dim
    return ParamTree({
        "item_table": embed_init(gen, cfg.n_items, e, cfg.dtype, dev),
        "attn": _stack(gen, (*cfg.attn_dims, 1), 4 * e, cfg.dtype, dev),
        "mlp": _stack(gen, (*cfg.mlp_dims, 1), 2 * e, cfg.dtype, dev),
    })


def din_param_specs(cfg: DINConfig) -> dict:
    """The reference's layout, by parameter name."""
    return flat_specs({
        "item_table": ("model", None),
        "attn": {"w": [(None, None)] * 3, "b": [(None,)] * 3},
        "mlp": {"w": [(None, None)] * 3, "b": [(None,)] * 3},
    })


def din_logits(params: ParamTree, cfg: DINConfig, batch) -> torch.Tensor:
    exact_f32()
    history = as_input(params, batch["history"])
    hist = take(params["item_table"], torch.clamp(history, min=0))        # (B, S, E)
    valid = (history >= 0).float()
    target = take(params["item_table"], as_input(params, batch["item_ids"]))  # (B, E)
    t = target[:, None, :].expand(hist.shape)
    ai = torch.cat([hist, t, hist - t, hist * t], dim=-1)                 # (B, S, 4E)
    score = mlp(ai, params["attn"]["w"], params["attn"]["b"], act=torch.sigmoid)[..., 0]
    score = score * valid  # DIN: no softmax
    pooled = torch.einsum("bs,bse->be", score, hist)
    x = torch.cat([pooled, target], dim=-1)
    return mlp(x, params["mlp"]["w"], params["mlp"]["b"])[..., 0]


def _bce_with_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def din_loss(params: ParamTree, cfg: DINConfig, batch):
    logits = din_logits(params, cfg, batch)
    loss = _bce_with_logits(logits, as_input(params, batch["click"], torch.float32))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# BST (arXiv:1905.06874) — Behavior Sequence Transformer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20           # history (seq_len-1) + target
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple = (1024, 512, 256)
    n_items: int = 1_000_000
    d_ff: int = 128
    dtype: Any = torch.float32


def init_bst(cfg: BSTConfig, *, generator: torch.Generator | None = None,
             device: str | torch.device = "cuda") -> ParamTree:
    dev, gen = _generator(device, generator)
    e, dt = cfg.embed_dim, cfg.dtype
    blocks = [{
        "wq": dense_init(gen, e, e, dt, dev),
        "wk": dense_init(gen, e, e, dt, dev),
        "wv": dense_init(gen, e, e, dt, dev),
        "wo": dense_init(gen, e, e, dt, dev),
        "norm1": torch.ones((e,), dtype=dt, device=dev),
        "w1": dense_init(gen, e, cfg.d_ff, dt, dev),
        "b1": torch.zeros((cfg.d_ff,), dtype=dt, device=dev),
        "w2": dense_init(gen, cfg.d_ff, e, dt, dev),
        "b2": torch.zeros((e,), dtype=dt, device=dev),
        "norm2": torch.ones((e,), dtype=dt, device=dev),
    } for _ in range(cfg.n_blocks)]
    return ParamTree({
        "item_table": embed_init(gen, cfg.n_items, e, dt, dev),
        "pos_table": embed_init(gen, cfg.seq_len, e, dt, dev),
        "blocks": blocks,
        "mlp": _stack(gen, (*cfg.mlp_dims, 1), cfg.seq_len * e, dt, dev),
    })


def bst_param_specs(cfg: BSTConfig) -> dict:
    """The reference's layout, by parameter name."""
    blk = {
        "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
        "wo": ("model", None), "norm1": (None,),
        "w1": (None, "model"), "b1": ("model",),
        "w2": ("model", None), "b2": (None,), "norm2": (None,),
    }
    return flat_specs({
        "item_table": ("model", None),
        "pos_table": (None, None),
        "blocks": [dict(blk) for _ in range(cfg.n_blocks)],
        "mlp": {"w": [(None, "model"), ("model", None), (None, None), (None, None)],
                "b": [("model",), (None,), (None,), (None,)]},
    })


def bst_logits(params: ParamTree, cfg: BSTConfig, batch) -> torch.Tensor:
    """Sequence = history ++ target item; transformer; concat → MLP → logit."""
    exact_f32()
    seq = torch.cat([as_input(params, batch["history"]),
                     as_input(params, batch["item_ids"])[:, None]], dim=1)  # (B, S)
    b, s = seq.shape
    e, h = cfg.embed_dim, cfg.n_heads
    hd = e // h
    x = take(params["item_table"], torch.clamp(seq, min=0))
    x = x + params["pos_table"][None, :s]
    for p in params["blocks"]:
        q, k, v = (torch.matmul(x, p[w]).reshape(b, s, h, hd) for w in ("wq", "wk", "wv"))
        logits = torch.einsum("bqhe,bkhe->bhqk", q, k) / (hd ** 0.5)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhe->bqhe", w, v).reshape(b, s, e)
        x = rms_norm(x + torch.matmul(o, p["wo"]), p["norm1"])
        ff = torch.matmul(torch.relu(torch.matmul(x, p["w1"]) + p["b1"]), p["w2"]) + p["b2"]
        x = rms_norm(x + ff, p["norm2"])
    flat = x.reshape(b, s * e)
    return mlp(flat, params["mlp"]["w"], params["mlp"]["b"], act=F.leaky_relu)[..., 0]


def bst_loss(params: ParamTree, cfg: BSTConfig, batch):
    logits = bst_logits(params, cfg, batch)
    loss = _bce_with_logits(logits, as_input(params, batch["click"], torch.float32))
    return loss, {"loss": loss}
