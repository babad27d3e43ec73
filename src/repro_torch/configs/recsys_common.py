"""Shared cell builders for the recsys architectures (the reference's
``configs/recsys_common.py``).

Shapes: ``train_batch`` (batch=65536 training), ``serve_p99`` (batch=512
online), ``serve_bulk`` (batch=262144 offline scoring), ``retrieval_cand``
(batch=1 query × 1,000,000 candidates).

``retrieval_cand`` routes through the APSS core (``similarity_topk``: the
paper's algorithm is retrieval scoring). Its candidates are row-sharded
over the data axes as the horizontal distribution's corpus rows are: each
rank scores its block, and the ranks' top-k lists are gathered and merged
(:func:`sharded_retrieval`), as ``core.distributed.gather_matches``
assembles the horizontal distribution's rows.

Every cell's ``layout`` gives the weights (and in ``train_batch`` the AdamW
moments) the reference's specs as a rank holds them
(``recsys.layout_specs``: tables' rows and tower columns over ``model``,
whole heads only) and the batch its rows over the data axes; a rank's model
is ``ParamTree.rebuild(device, mesh)`` of the family's init.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import CellBuild, ShapeCell, data_axes_of, meta, shardings_for
from repro_torch.core.matches import Matches, merge_matches, stable_topk
from repro_torch.distributed.sharding import active_mesh, data_axes
from repro_torch.launch.train import make_recsys_train_step, params_of
from repro_torch.models import recsys
from repro_torch.optim import adamw_init
from repro_torch.optim.optimizer import AdamWState

N_CANDIDATES = 1_000_000


def _params_and_opt(init_fn, cfg, mesh, spec_fn):
    params = init_fn(cfg, device="meta")
    opt = adamw_init(params_of(params))
    specs = spec_fn(cfg)
    return (params, opt, shardings_for(mesh, specs),
            shardings_for(mesh, AdamWState(step=(), m=specs, v=specs)))


def _opt_layout(layout: dict) -> AdamWState:
    return AdamWState(step=(), m=layout, v=layout)


def _batch(cfg, batch: int, kind: str) -> dict:
    i32 = torch.int32
    if isinstance(cfg, recsys.TwoTowerConfig):
        b = {"user_fields": meta((batch, cfg.n_user_fields), i32),
             "history": meta((batch, cfg.history_len), i32),
             "item_ids": meta((batch,), i32)}
    elif isinstance(cfg, recsys.Bert4RecConfig):
        b = {"item_ids": meta((batch, cfg.seq_len), i32)}
        if kind == "train":
            b["labels"] = meta((batch, cfg.seq_len), i32)
            b["mask"] = meta((batch, cfg.seq_len), torch.bool)
    elif isinstance(cfg, recsys.DINConfig):
        b = {"history": meta((batch, cfg.seq_len), i32), "item_ids": meta((batch,), i32)}
        if kind == "train":
            b["click"] = meta((batch,), i32)
    else:  # BST
        b = {"history": meta((batch, cfg.seq_len - 1), i32), "item_ids": meta((batch,), i32)}
        if kind == "train":
            b["click"] = meta((batch,), i32)
    return b


def _batch_specs(mesh, batch: dict) -> dict:
    daxes = data_axes_of(mesh)
    return {k: (daxes, *([None] * (v.dim() - 1))) for k, v in batch.items()}


def _flops_per_example(cfg) -> int:
    """Dense-layer MAC count × 2 (embedding lookups are bandwidth, not FLOPs)."""
    if isinstance(cfg, recsys.TwoTowerConfig):
        dims_u = (cfg.embed_dim * (cfg.n_user_fields + 1), *cfg.tower_dims)
        dims_i = (cfg.embed_dim, *cfg.tower_dims)
        f = sum(a * b for a, b in zip(dims_u[:-1], dims_u[1:]))
        f += sum(a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
        return 2 * f
    if isinstance(cfg, recsys.Bert4RecConfig):
        d = cfg.embed_dim
        per_tok = 4 * d * d + 2 * d * cfg.d_ff
        attn = 2 * cfg.seq_len * d
        return 2 * cfg.n_blocks * cfg.seq_len * (per_tok + attn)
    if isinstance(cfg, recsys.DINConfig):
        e = cfg.embed_dim
        attn = cfg.seq_len * (4 * e * 80 + 80 * 40 + 40)
        head = 2 * e * 200 + 200 * 80 + 80
        return 2 * (attn + head)
    e, s = cfg.embed_dim, cfg.seq_len
    blk = s * (4 * e * e + 2 * e * cfg.d_ff) + s * s * e * 2
    m_dims = (s * e, *cfg.mlp_dims, 1)
    head = sum(a * b for a, b in zip(m_dims[:-1], m_dims[1:]))
    return 2 * (cfg.n_blocks * blk + head)


def _build_train(cfg, mesh, init_fn, spec_fn, batch: int) -> CellBuild:
    params, opt, p_sh, o_sh = _params_and_opt(init_fn, cfg, mesh, spec_fn)
    b = _batch(cfg, batch, "train")
    b_spec = _batch_specs(mesh, b)
    return CellBuild(
        fn=make_recsys_train_step(cfg),
        args=(params, opt, b),
        in_shardings=(p_sh, o_sh, b_spec),
        out_shardings=(p_sh, o_sh, None),
        static_info={"kind": "train", "model_flops": 3 * batch * _flops_per_example(cfg),
                     "batch": batch},
        layout=(recsys.layout_specs(cfg, mesh), _opt_layout(recsys.layout_specs(cfg, mesh)),
                b_spec),
    )


def _build_serve(cfg, mesh, init_fn, spec_fn, score_fn, batch: int) -> CellBuild:
    params, _, p_sh, _ = _params_and_opt(init_fn, cfg, mesh, spec_fn)
    b = _batch(cfg, batch, "serve")
    b_spec = _batch_specs(mesh, b)
    return CellBuild(
        fn=functools.partial(torch.no_grad()(score_fn), cfg),
        args=(params, b),
        in_shardings=(p_sh, b_spec),
        out_shardings=None,
        static_info={"kind": "serve", "model_flops": batch * _flops_per_example(cfg),
                     "batch": batch},
        layout=(recsys.layout_specs(cfg, mesh), b_spec),
    )


def sharded_retrieval(retrieval_fn, cfg, params, batch, candidate_ids):
    """``retrieval_fn`` over this rank's block of the candidates (the active
    mesh's data axes; the tables' rows over ``model`` when ``params`` are a
    rank's blocks), its candidate positions made global (``+ r ·
    n_loc``), the ranks' top-k lists all-gathered in rank order and merged
    (ties to the lower rank, so to the lower position): ``Matches`` by
    ``merge_matches`` (counts add), a ``(values, ids)`` top-k by a stable
    top-k of the union. Without data axes it is ``retrieval_fn`` itself."""
    from repro_torch.core.distributed import _all_gather, _axis_index, _axis_size

    out = retrieval_fn(cfg, params, batch, candidate_ids)
    mesh, daxes = active_mesh(), data_axes()
    if not daxes:
        return out
    offset = _axis_index(mesh, daxes) * candidate_ids.shape[0]
    if isinstance(out, Matches):
        ids = torch.where(out.indices >= 0, out.indices + offset, out.indices)
        parts = [_all_gather(x[None], mesh, daxes) for x in (out.values, ids, out.counts)]
        merged = Matches(parts[0][0], parts[1][0], parts[2][0])
        for i in range(1, _axis_size(mesh, daxes)):
            merged = merge_matches(merged, Matches(parts[0][i], parts[1][i], parts[2][i]))
        return merged
    values, ids = out
    values, ids = (_all_gather(x[None], mesh, daxes).reshape(-1) for x in (values, ids + offset))
    top, sel = stable_topk(values, out[0].shape[-1])
    return top, ids[sel]


def _build_retrieval(cfg, mesh, init_fn, spec_fn, retrieval_fn) -> CellBuild:
    params, _, p_sh, _ = _params_and_opt(init_fn, cfg, mesh, spec_fn)
    b = _batch(cfg, 1, "serve")
    cand_spec = (data_axes_of(mesh),)
    # The one query replicates; only the 1M-candidate corpus shards (the
    # paper's horizontal distribution of the similarity join's corpus).
    q_spec = {k: () for k in b}
    return CellBuild(
        fn=functools.partial(sharded_retrieval, retrieval_fn, cfg),
        args=(params, b, meta((N_CANDIDATES,), torch.int32)),
        in_shardings=(p_sh, q_spec, shardings_for(mesh, cand_spec)),
        out_shardings=None,
        static_info={"kind": "retrieval",
                     "model_flops": _flops_per_example(cfg)
                     + 2 * N_CANDIDATES * getattr(cfg, "embed_dim", 64),
                     "batch": N_CANDIDATES},
        layout=(recsys.layout_specs(cfg, mesh), q_spec, cand_spec),
    )


def recsys_shapes(arch, init_fn, spec_fn, score_fn, retrieval_fn) -> dict:
    return {
        "train_batch": ShapeCell(
            kind="train", desc="batch=65536 (training)",
            build=lambda cfg, mesh: _build_train(cfg, mesh, init_fn, spec_fn, 65536),
        ),
        "serve_p99": ShapeCell(
            kind="serve", desc="batch=512 (online-inference)",
            build=lambda cfg, mesh: _build_serve(cfg, mesh, init_fn, spec_fn, score_fn, 512),
        ),
        "serve_bulk": ShapeCell(
            kind="serve", desc="batch=262144 (offline-scoring)",
            build=lambda cfg, mesh: _build_serve(
                cfg, mesh, init_fn, spec_fn, score_fn, 262144),
        ),
        "retrieval_cand": ShapeCell(
            kind="retrieval",
            desc="batch=1 n_candidates=1,000,000 (APSS-backed retrieval)",
            build=lambda cfg, mesh: _build_retrieval(
                cfg, mesh, init_fn, spec_fn, retrieval_fn),
        ),
    }
