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

On a mesh (``init_*(mesh=)``, ``interop.recsys_params_from_numpy(mesh=)``)
a rank holds its blocks of the reference's ``*_param_specs``
(:func:`layout_specs`), each parameter tagged with ``.spec`` and
``.mesh``, and the forwards split where the tags say:

  - every table's rows over ``model``: a vocab-parallel lookup
    (``layers.lookup``), BERT4Rec's logits against the rank's rows of
    ``item_table`` (rows at or past ``n_items`` masked; its CE by
    ``vocab_parallel_logsumexp``/``_pick``, ``bert4rec_score`` gathering
    the logits);
  - the two-tower's tower matrices by columns, the activation gathered
    over ``model`` after each layer; BST's first MLP pair and the
    BERT4Rec and BST blocks (``wq``/``wk``/``wv``, ``w1`` by columns,
    ``wo``, ``w2`` by rows) as Megatron pairs, row-parallel partials
    summed over ``model`` in f32 in rank order and rounded once;
    attention splits whole heads only: where ``model`` does not divide them
    they are zero-padded to a count it does (``sharding.HeadLayout``; a
    rank's block keeps the head width, and a zero head's ``q``, ``k`` and
    ``v`` are zero, so it adds exactly nothing and takes no gradient;
    :func:`layout_replications` lists the padded blocks);
  - under ``distributed.sharding.use_mesh`` with data axes the batch is
    the rank's rows: the two-tower's in-batch negatives and ``logq`` are
    gathered over the data axes (``gather_for_use``: the item gradients
    come back reduce-scattered) and BERT4Rec divides by the global mask
    count, so the trainer's mean over the data axes is the reference's
    global-batch loss.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.nn import functional as F

from repro_torch.core.apss import similarity_topk
from repro_torch.core.matches import Matches
from repro_torch.core.precision import exact_f32
from repro_torch.distributed.sharding import (
    HeadLayout,
    active_mesh,
    axis_sizes,
    data_axes,
    local_shape,
)
from repro_torch.interop import device_of
from repro_torch.models.layers import (
    ParamTree,
    as_input,
    chunked_attention,
    column_parallel,
    cut_param_tree,
    dense_init,
    embed_init,
    flat_specs,
    layout_of,
    lookup,
    mlp,
    model_split,
    rms_norm,
    row_parallel,
    segment_sum,
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
    emb = lookup(table, torch.clamp(ids, min=0))               # (B, L, E)
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
    emb = lookup(table, flat_ids)
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


def _finish(tree: ParamTree, cfg, init, mesh) -> ParamTree:
    """``tree`` with its config and its family's ``init`` attached (for
    ``ParamTree.rebuild``), cut to this rank's blocks of
    :func:`layout_specs` on ``mesh`` (every rank calls this with the same
    draw; the whole tree is freed once the blocks are copied)."""
    tree.cfg, tree.build = cfg, functools.partial(init, cfg)
    if mesh is None:
        return tree
    return cut_param_tree(tree, layout_specs(cfg, mesh), mesh)


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
                   device: str | torch.device = "cuda", mesh=None) -> ParamTree:
    """The reference's init laws on ``device`` (seed 0 when ``generator`` is
    omitted): tables 0.02 × normal, tower matrices normal × √(2/(d_in+d_out)),
    biases zero. With a ``mesh``, the rank's blocks of that draw."""
    dev, gen = _generator(device, generator)
    d_user_in = cfg.embed_dim * (cfg.n_user_fields + 1)  # fields + history bag
    return _finish(ParamTree({
        "item_table": embed_init(gen, cfg.n_items, cfg.embed_dim, cfg.dtype, dev),
        "user_table": embed_init(gen, cfg.user_vocab, cfg.embed_dim, cfg.dtype, dev),
        "user_tower": _stack(gen, cfg.tower_dims, d_user_in, cfg.dtype, dev),
        "item_tower": _stack(gen, cfg.tower_dims, cfg.embed_dim, cfg.dtype, dev),
    }), cfg, init_two_tower, mesh)


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
    fields = lookup(params["user_table"], as_input(params, batch["user_fields"]))  # (B, F, E)
    hist = embedding_bag(params["item_table"], as_input(params, batch["history"]),
                         mode="mean")                                       # (B, E)
    x = torch.cat([fields.reshape(fields.shape[0], -1), hist], dim=-1)
    t = params["user_tower"]
    return _l2norm(mlp(x, t["w"], t["b"]))


def item_embedding(params: ParamTree, cfg: TwoTowerConfig, item_ids) -> torch.Tensor:
    exact_f32()
    x = lookup(params["item_table"], as_input(params, item_ids))
    t = params["item_tower"]
    return _l2norm(mlp(x, t["w"], t["b"]))


def two_tower_loss(params: ParamTree, cfg: TwoTowerConfig, batch):
    """In-batch sampled softmax with the logQ correction. Under a mesh with
    data axes the batch is the rank's rows and the negatives (and
    ``logq``) are the global batch's, gathered over the data axes: the
    loss is the mean over the rank's rows, whose mean over the data
    ranks is the global one."""
    u = user_embedding(params, cfg, batch)              # (B, E)
    i = item_embedding(params, cfg, batch["item_ids"])  # (B, E)
    logq = batch.get("sampling_logq")
    if logq is not None:
        logq = as_input(params, logq, torch.float32)
    labels = torch.arange(u.shape[0], device=u.device)
    mesh, daxes = active_mesh(), data_axes()
    if daxes:
        from repro_torch.core.distributed import _all_gather, _axis_index, gather_for_use

        labels = labels + _axis_index(mesh, daxes) * u.shape[0]
        i = gather_for_use(i, mesh, daxes, 0)
        if logq is not None:
            logq = _all_gather(logq, mesh, daxes)
    logits = torch.matmul(u, i.T).float() / cfg.temperature
    if logq is not None:
        logits = logits - logq[None, :]
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), 1, labels[:, None])[:, 0]
    loss = torch.mean(nll)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return loss, {"loss": loss, "in_batch_acc": acc}


def two_tower_score(params: ParamTree, cfg: TwoTowerConfig, batch) -> torch.Tensor:
    """Pointwise (user, item) scores."""
    u = user_embedding(params, cfg, batch)
    i = item_embedding(params, cfg, batch["item_ids"])
    return torch.sum(u * i, dim=-1) / cfg.temperature


RETRIEVAL_CHUNK = 131072  # candidates a rank's blocks embed at a time


@torch.no_grad()
def retrieval_scores(
    params: ParamTree, cfg: TwoTowerConfig, batch, candidate_ids, *, k: int = 256,
    threshold: float = 0.0, block_rows: int = 4096,
) -> Matches:
    """Score one (or a few) queries against a large candidate corpus: the
    item tower embeds the candidates, then ``similarity_topk`` (plain path)
    keeps each query's top ``k`` at ``threshold`` on the params' device.
    A rank's blocks (``params.mesh``) embed the candidates ``RETRIEVAL_CHUNK``
    at a time: each chunk's lookups and tower activations are gathered over
    ``model``, and a whole corpus of them would not fit beside the tables."""
    u = user_embedding(params, cfg, batch)              # (Q, E)
    ids = as_input(params, candidate_ids)
    if params.mesh is None:
        c = item_embedding(params, cfg, ids)            # (N, E)
    else:
        c = torch.cat([item_embedding(params, cfg, ids[lo:lo + RETRIEVAL_CHUNK])
                       for lo in range(0, ids.shape[0], RETRIEVAL_CHUNK)])
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
                  device: str | torch.device = "cuda", mesh=None) -> ParamTree:
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
    return _finish(ParamTree({
        "item_table": embed_init(gen, cfg.padded_items, d, dt, dev),
        "pos_table": embed_init(gen, cfg.seq_len, d, dt, dev),
        "blocks": blocks,
        "final_norm": ones(d),
    }), cfg, init_bert4rec, mesh)


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
    x = lookup(params["item_table"], item_ids)
    x = x + params["pos_table"][None, :s]
    hd = cfg.embed_dim // cfg.n_heads
    for p in params["blocks"]:
        xn = rms_norm(x, p["attn_norm"])
        q, k, v = (column_parallel(xn, p[w]).reshape(b, s, -1, hd).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        o = chunked_attention(q, k, v, causal=False, q_chunk=min(128, s),
                              kv_chunk=min(128, s))
        o = o.transpose(1, 2).reshape(b, s, -1)
        x = x + row_parallel(o, p["wo"])
        xn = rms_norm(x, p["ffn_norm"])
        hh = F.gelu(column_parallel(xn, p["w1"]) + p["b1"], approximate="tanh")
        x = x + row_parallel(hh, p["w2"]) + p["b2"]
    return rms_norm(x, params["final_norm"])


def _item_logits(params: ParamTree, cfg: Bert4RecConfig, h: torch.Tensor, *,
                 grad: bool) -> tuple[torch.Tensor, int]:
    """``(h · item_tableᵀ, first id)`` in f32 (products of the model's dtype
    summed in f32): every item's logit, or on a rank whose rows of the
    table ``model`` splits, the logits of its rows (``h`` entering the
    split with its gradient summed over ``model`` when ``grad``), the rows
    at or past ``n_items`` masked to ``-inf``."""
    table = params["item_table"]
    if not model_split(table, 0):
        return torch.matmul(h.float(), table[:cfg.n_items].float().T), 0
    lo = table.mesh.get_local_rank("model") * table.shape[0]
    if grad:
        from repro_torch.core.distributed import enter_replicated

        h = enter_replicated(h, table.mesh, ("model",))
    logits = torch.matmul(h.float(), table.float().T)
    pad = torch.arange(lo, lo + table.shape[0], device=logits.device) >= cfg.n_items
    return logits.masked_fill(pad, float("-inf")), lo


def bert4rec_loss(params: ParamTree, cfg: Bert4RecConfig, batch):
    """Masked-item prediction (cloze) CE over the masked positions. On a
    rank whose ``item_table`` rows ``model`` splits, the log-sum-exp and
    the label's logit cross the ranks (``vocab_parallel_*``). Under a mesh
    with data axes the batch is the rank's rows and the loss is the rank's
    NLL sum over the global mask count, times the data ranks: their mean
    is the global masked mean."""
    h = bert4rec_encode(params, cfg, batch["item_ids"])     # (B, S, d)
    logits, lo = _item_logits(params, cfg, h, grad=True)
    labels = as_input(params, batch["labels"]).long()
    mask = as_input(params, batch["mask"], torch.float32)
    table = params["item_table"]
    if model_split(table, 0):
        from repro_torch.core.distributed import vocab_parallel_logsumexp, vocab_parallel_pick

        lse = vocab_parallel_logsumexp(logits, table.mesh, "model")
        gold = vocab_parallel_pick(logits, labels, table.mesh, "model", lo)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    cnt = torch.sum(mask)
    mesh, daxes = active_mesh(), data_axes()
    if daxes:
        from repro_torch.core.distributed import _axis_size, psum_in_order

        cnt = psum_in_order(cnt.detach(), mesh, daxes)
        loss = torch.sum(nll) / torch.clamp(cnt, min=1.0) * _axis_size(mesh, daxes)
    else:
        loss = torch.sum(nll) / torch.clamp(cnt, min=1.0)
    return loss, {"loss": loss}


def bert4rec_score(params: ParamTree, cfg: Bert4RecConfig, batch) -> torch.Tensor:
    """Next-item scores from the final position (serving); on a rank of a
    vocab split, every rank's logits gathered over ``model``."""
    h = bert4rec_encode(params, cfg, batch["item_ids"])
    logits, _ = _item_logits(params, cfg, h[:, -1], grad=False)
    table = params["item_table"]
    if not model_split(table, 0):
        return logits
    from repro_torch.core.distributed import gather_replicated

    return gather_replicated(logits, table.mesh, ("model",), 1)[:, :cfg.n_items]


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
             device: str | torch.device = "cuda", mesh=None) -> ParamTree:
    dev, gen = _generator(device, generator)
    e = cfg.embed_dim
    return _finish(ParamTree({
        "item_table": embed_init(gen, cfg.n_items, e, cfg.dtype, dev),
        "attn": _stack(gen, (*cfg.attn_dims, 1), 4 * e, cfg.dtype, dev),
        "mlp": _stack(gen, (*cfg.mlp_dims, 1), 2 * e, cfg.dtype, dev),
    }), cfg, init_din, mesh)


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
    hist = lookup(params["item_table"], torch.clamp(history, min=0))      # (B, S, E)
    valid = (history >= 0).float()
    target = lookup(params["item_table"], as_input(params, batch["item_ids"]))  # (B, E)
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
             device: str | torch.device = "cuda", mesh=None) -> ParamTree:
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
    return _finish(ParamTree({
        "item_table": embed_init(gen, cfg.n_items, e, dt, dev),
        "pos_table": embed_init(gen, cfg.seq_len, e, dt, dev),
        "blocks": blocks,
        "mlp": _stack(gen, (*cfg.mlp_dims, 1), cfg.seq_len * e, dt, dev),
    }), cfg, init_bst, mesh)


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
    e = cfg.embed_dim
    hd = e // cfg.n_heads
    x = lookup(params["item_table"], torch.clamp(seq, min=0))
    x = x + params["pos_table"][None, :s]
    for p in params["blocks"]:
        q, k, v = (column_parallel(x, p[w]).reshape(b, s, -1, hd) for w in ("wq", "wk", "wv"))
        logits = torch.einsum("bqhe,bkhe->bhqk", q, k) / (hd ** 0.5)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhe->bqhe", w, v).reshape(b, s, -1)
        x = rms_norm(x + row_parallel(o, p["wo"]), p["norm1"])
        ff = row_parallel(torch.relu(column_parallel(x, p["w1"]) + p["b1"]), p["w2"]) + p["b2"]
        x = rms_norm(x + ff, p["norm2"])
    flat = x.reshape(b, s * e)
    return mlp(flat, params["mlp"]["w"], params["mlp"]["b"], act=F.leaky_relu)[..., 0]


def bst_loss(params: ParamTree, cfg: BSTConfig, batch):
    logits = bst_logits(params, cfg, batch)
    loss = _bce_with_logits(logits, as_input(params, batch["click"], torch.float32))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# layouts on a mesh
# ---------------------------------------------------------------------------

_FAMILY = {
    TwoTowerConfig: (init_two_tower, two_tower_param_specs),
    Bert4RecConfig: (init_bert4rec, bert4rec_param_specs),
    DINConfig: (init_din, din_param_specs),
    BSTConfig: (init_bst, bst_param_specs),
}
_ATTENTION = ("wq", "wk", "wv", "wo")


def param_specs(cfg) -> dict:
    """The reference's ``*_param_specs`` of ``cfg``'s family, by name."""
    return _FAMILY[type(cfg)][1](cfg)


def _head_layout(cfg, mesh) -> HeadLayout | None:
    """The attention heads over ``model`` where it does not split them
    evenly (``None`` where it does, or the family has no attention)."""
    m = axis_sizes(mesh).get("model", 1)
    if not hasattr(cfg, "n_heads") or m == 1:
        return None
    lay = HeadLayout.of(cfg.n_heads, cfg.n_heads, m)
    return None if lay.even_q else lay


def layout_specs(cfg, mesh) -> dict:
    """:func:`param_specs` as a rank of ``mesh`` holds the parameters: axes
    the mesh lacks and dimensions their axes do not divide replicate
    (``elastic``'s rule), and the blocks' attention matrices split whole
    heads only: where ``model`` does not divide the heads, the ``model``
    entry of ``wq``/``wk``/``wv`` (columns) and ``wo`` (rows) is a
    ``HeadBlocks`` of the rank's heads, zero-padded to a count ``model``
    divides."""
    specs = dict(param_specs(cfg))
    lay = _head_layout(cfg, mesh)
    if lay is not None:
        blocks = lay.q_blocks(cfg.embed_dim // cfg.n_heads)
        for name in specs:
            if name.startswith("blocks.") and name.rsplit(".", 1)[-1] in _ATTENTION:
                specs[name] = tuple(blocks if part == "model" else part for part in specs[name])
    return layout_of(specs, _FAMILY[type(cfg)][0](cfg, device="meta"), mesh)


def layout_replications(cfg, mesh) -> dict:
    """``{name: reason}`` of the parameters whose layout spec holds more
    than ``local_shape`` of :func:`param_specs` would place on a rank: the
    attention matrices whose heads are zero-padded."""
    layout, base = layout_specs(cfg, mesh), param_specs(cfg)
    lay = _head_layout(cfg, mesh)
    out = {}
    for name, p in _FAMILY[type(cfg)][0](cfg, device="meta").named_parameters():
        shape = tuple(p.shape)
        held, even = (torch.Size(local_shape(shape, spec[name], mesh)).numel()
                      for spec in (layout, base))
        if held > even:
            out[name] = (f"{cfg.n_heads} heads zero-padded to {lay.hkv_pad} over "
                         f"model={lay.m}: {lay.q_per_rank} a rank")
    return out
