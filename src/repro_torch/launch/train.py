"""Training step factories + the end-to-end training driver.

``make_*_train_step`` return ``(model, opt_state, batch) → (model,
opt_state, metrics)`` functions, as the reference's
(``repro.launch.train``), with one difference: a step writes the model's
parameters and the AdamW moments in place (the returned model is the one
passed in, the returned state holds the same moment tensors and a new step
count). The parameter tree is ``dict(model.named_parameters())``. The
driver composes a step with the data pipeline, the checkpoint manager
(async, keep-k, auto-resume) and the straggler timer.

On a mesh (``train_loop(mesh=)``, or a step called under
``distributed.sharding.use_mesh``) every rank takes its rows of the global
batch over the data axes (``("pod", "data")``), computes its gradients
(an LM's CE over the global token count) and the ranks average them over
the data axes in rank order, so a step equals the single-process step on
the same global batch up to the order of one sum. An LM built on the mesh
(``train_loop(mesh=)``: ``Transformer(cfg, device, mesh)``) holds its
blocks of the reference's ``param_specs``: tensor parallel over ``model``
(heads, FFN columns and rows, embedding width, vocab, experts) and, with
``cfg.fsdp``, FSDP over the data axes, whose leaves' gradients arrive
reduce-scattered in rank order (``core.distributed.gather_for_use``) and
whose AdamW moments are the rank's blocks too. A recsys model built on the
mesh holds its blocks of the reference's ``*_param_specs`` (tables' rows
and tower columns over ``model``, ``recsys.layout_specs``) and computes
the reference's global-batch loss (the two-tower's negatives gathered over
the data axes, BERT4Rec's global mask count). A GAT's weights replicate and
its graph is cut by nodes and edges over the data axes
(``gnn.graph_axes``; the step takes ``graph_axes``). A model without
blocks (an LM built whole) is replicated, and MoE layers with
``moe_impl="ep"`` split their experts (``models.moe.moe_ffn_ep``).

CLI (reduced configs; on the card unless ``--device cpu``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora \\
        --steps 6 --ckpt-dir /tmp/ck --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import StepTimer
from repro_torch.distributed.sharding import active_mesh, axis_sizes, data_axes, use_mesh
from repro_torch.interop import device_of
from repro_torch.models import gnn, recsys
from repro_torch.models.transformer import (
    TransformerConfig,
    init_transformer,
    transformer_loss,
)
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainHyperparams:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95


def params_of(model: torch.nn.Module) -> dict:
    """The trainer's parameter tree: ``{name: parameter}``, every parameter
    set to require a gradient (the models build theirs without)."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def grads_of(loss_fn: Callable, model: torch.nn.Module, batch) -> tuple:
    """``(loss, aux, grads)`` of ``loss_fn(model, batch) -> (loss, aux)``:
    ``grads`` a tree like :func:`params_of`, a parameter the loss does not
    reach getting zeros (as ``jax.grad`` gives); the loss and ``aux`` are
    detached."""
    params = params_of(model)
    loss, aux = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            dict(zip(params, grads)))


def _micro(batch: dict, i: int, n: int) -> dict:
    """Microbatch ``i`` of ``n``: contiguous rows of every entry's batch dim."""
    def part(x):
        size = x.shape[0] // n
        return x[i * size:(i + 1) * size]
    return {key: part(x) for key, x in batch.items()}


def _fsdp_leaf(param) -> bool:
    """Whether ``param`` is a block FSDP splits over a data axis."""
    from repro_torch.distributed.sharding import split_axes

    spec = getattr(param, "spec", None)
    return spec is not None and any(a in ("pod", "data") for a in split_axes(spec))


def _mean_over_data(grads: dict, loss, aux: dict, params: dict | None = None):
    """Average the gradients, the loss and the aux scalars over the active
    mesh's data axes, summed in rank order in f32 (``psum_in_order``): the
    leaves, in order, are packed into buckets of at most ``CHUNK`` elements
    (a large leaf spans several), one all-reduce a bucket. An FSDP leaf of
    ``params`` has its gradient reduce-scattered over the data axes
    already (the backward of its gather): it is only divided by their
    size. Unchanged without a mesh or data axes."""
    mesh, daxes = active_mesh(), data_axes()
    if not daxes:
        return grads, loss, aux
    from repro_torch.core.distributed import _axis_size, psum_in_order
    from repro_torch.optim.optimizer import CHUNK

    p = _axis_size(mesh, daxes)
    keys = list(grads)
    scaled = {k: (g.float() / p).to(g.dtype) for k, g in grads.items()
              if params is not None and _fsdp_leaf(params[k])}
    grads = {k: g for k, g in grads.items() if k not in scaled}
    leaves = [*grads.values(), loss, *aux.values()]
    flats = [x.reshape(-1) for x in leaves]
    parts: list[list] = [[] for _ in flats]
    bucket, room = [], CHUNK

    def flush():
        summed = psum_in_order(torch.cat([flats[i][lo:hi].float() for i, lo, hi in bucket]),
                               mesh, daxes) / p
        at = 0
        for i, lo, hi in bucket:
            parts[i].append(summed[at:at + hi - lo])
            at += hi - lo

    for i, flat in enumerate(flats):
        lo = 0
        while lo < flat.numel():
            hi = min(flat.numel(), lo + room)
            bucket.append((i, lo, hi))
            room -= hi - lo
            lo = hi
            if room == 0:
                flush()
                bucket, room = [], CHUNK
    if bucket:
        flush()
    out = [torch.cat(ps).reshape(x.shape).to(x.dtype) for ps, x in zip(parts, leaves)]
    n = len(grads)
    mean = dict(zip(grads, out[:n]))
    return ({k: scaled[k] if k in scaled else mean[k] for k in keys}, out[n],
            dict(zip(aux, out[n + 1:])))


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple],
    hp: TrainHyperparams = TrainHyperparams(),
    *,
    accum_steps: int = 1,
) -> Callable:
    """Generic train step from a ``loss_fn(model, batch) -> (loss, aux)``.

    With ``accum_steps > 1`` the batch is split into contiguous microbatches
    along its first dim, run one after another, and their gradients summed
    in f32 and averaged: live activation memory divides by N at the cost
    of reading the weights N times. The loss is the microbatches' mean, the
    aux entries the last microbatch's, as in the reference. Under a mesh
    with data axes the batch is the rank's rows, and the gradients, loss
    and aux entries are averaged over the data axes before the update.
    """

    def train_step(model, opt_state, batch):
        params = params_of(model)
        if accum_steps == 1:
            loss, aux, grads = grads_of(loss_fn, model, batch)
        else:
            g_sum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=opt_state.step.device)
            for i in range(accum_steps):
                loss, aux, g = grads_of(loss_fn, model, _micro(batch, i, accum_steps))
                for k in g_sum:
                    g_sum[k] = g_sum[k] + g[k].float()
                loss_sum = loss_sum + loss
            grads = {k: g / accum_steps for k, g in g_sum.items()}
            loss = loss_sum / accum_steps
        grads, loss, aux = _mean_over_data(grads, loss, aux, params)
        lr = cosine_schedule(opt_state.step, hp.lr, hp.warmup_steps, hp.total_steps)
        split, mesh, repeats = _split_of(params)
        _, new_opt, opt_metrics = adamw_update(
            grads, opt_state, params,
            lr=lr, b1=hp.b1, b2=hp.b2,
            weight_decay=hp.weight_decay, clip_norm=hp.clip_norm, split=split, mesh=mesh,
            repeats=repeats,
        )
        metrics = {"loss": loss, **aux, **opt_metrics}
        return model, new_opt, metrics

    return train_step


def _split_of(params: dict) -> tuple:
    """``(split, mesh, repeats)`` for the optimizer's clip: the axes that
    split each leaf in ``tree_leaves`` order, the mesh of the tagged blocks
    and whether each leaf's block repeats a lower rank's (a shared kv head;
    ``sharding.repeats_block``); ``(None, None, None)`` when no leaf is a
    block."""
    from repro_torch.distributed.sharding import repeats_block, split_axes
    from repro_torch.optim.optimizer import tree_leaves

    leaves = tree_leaves(params)
    tagged = [p for p in leaves if getattr(p, "spec", None) is not None]
    if not tagged:
        return None, None, None
    return ([split_axes(p.spec) if getattr(p, "spec", None) is not None else ()
             for p in leaves], tagged[0].mesh, [repeats_block(p) for p in leaves])


def make_lm_train_step(cfg: TransformerConfig, hp: TrainHyperparams = TrainHyperparams()):
    return make_train_step(lambda p, b: transformer_loss(p, cfg, b), hp,
                           accum_steps=getattr(cfg, "grad_accum", 1))


def make_gat_train_step(cfg: gnn.GATConfig, hp: TrainHyperparams = TrainHyperparams(), *,
                        graph_axes: tuple | None = None):
    """GAT's step; with ``graph_axes`` (``gnn.graph_axes``) the batch is the
    rank's blocks of the graph on the active mesh."""
    return make_train_step(lambda p, b: gnn.gat_loss(p, cfg, b, graph_axes=graph_axes), hp)


RECSYS_LOSSES = (
    (recsys.TwoTowerConfig, recsys.two_tower_loss),
    (recsys.Bert4RecConfig, recsys.bert4rec_loss),
    (recsys.DINConfig, recsys.din_loss),
    (recsys.BSTConfig, recsys.bst_loss),
)


def recsys_loss_fn(cfg) -> Callable:
    """``loss_fn(model, batch)`` of a recsys config."""
    for kind, fn in RECSYS_LOSSES:
        if isinstance(cfg, kind):
            return lambda p, b: fn(p, cfg, b)
    raise TypeError(type(cfg))


def make_recsys_train_step(cfg, hp: TrainHyperparams = TrainHyperparams()):
    return make_train_step(recsys_loss_fn(cfg), hp)


# ---------------------------------------------------------------------------
# end-to-end driver
# ---------------------------------------------------------------------------


class TrainSetup(NamedTuple):
    """What :func:`train_loop` runs for one architecture."""

    model: torch.nn.Module
    loss_fn: Callable           # (model, batch) -> (loss, aux)
    step_fn: Callable           # make_*_train_step's step
    get_batch: Callable         # step -> batch (numpy, or tensors on the device)


def setup(family: str, cfg, hp: TrainHyperparams, device, mesh=None) -> TrainSetup:
    """The reduced model (seed 0), loss, step and data pipeline of
    ``train_loop`` for a config of ``family``, on ``device``: the reference's
    pipelines and batch sizes (LM 4 × min(128, 4·loss_chunk) tokens, a
    512-node 4,096-edge graph, 32 recsys examples). With a ``mesh`` the
    model is this rank's blocks (``init_*(mesh=)``), ``get_batch`` gives the
    rank's rows over the data axes, and a graph is cut by nodes and edges
    (``gnn.cut_graph``)."""
    from repro_torch.data import GraphPipeline, LMDataPipeline, RecsysPipeline

    dev = device_of(device)
    if family == "lm":
        model = init_transformer(cfg, device=dev, mesh=mesh)
        pipe = LMDataPipeline(vocab_size=cfg.vocab_size, batch_size=4,
                              seq_len=min(128, 4 * cfg.loss_chunk), seed=0)
        return TrainSetup(model, lambda p, b: transformer_loss(p, cfg, b),
                          make_lm_train_step(cfg, hp), _rank_rows(pipe.get_batch, mesh))
    if family == "gnn":
        model = gnn.init_gat(cfg, device=dev, mesh=mesh)
        pipe = GraphPipeline(n_nodes=512, n_edges=4096, d_feat=cfg.d_feat,
                             n_classes=cfg.n_classes)
        whole = pipe.full_graph()
        axes = None
        if mesh is not None:
            axes = gnn.graph_axes(mesh, len(whole["labels"]), len(whole["edge_src"]))
            whole = gnn.cut_graph(whole, axes, mesh)
        g = {k: torch.as_tensor(v, device=dev) for k, v in whole.items()}
        return TrainSetup(model, lambda p, b: gnn.gat_loss(p, cfg, b, graph_axes=axes),
                          make_gat_train_step(cfg, hp, graph_axes=axes), lambda s: g)
    if isinstance(cfg, recsys.TwoTowerConfig):
        model = recsys.init_two_tower(cfg, device=dev, mesh=mesh)
        pipe = RecsysPipeline(n_items=cfg.n_items, batch_size=32,
                              history_len=cfg.history_len,
                              n_user_fields=cfg.n_user_fields,
                              user_vocab=cfg.user_vocab, kind="two-tower")
    elif isinstance(cfg, recsys.Bert4RecConfig):
        model = recsys.init_bert4rec(cfg, device=dev, mesh=mesh)
        pipe = RecsysPipeline(n_items=cfg.n_items, batch_size=32,
                              history_len=cfg.seq_len, kind="seq")
    elif isinstance(cfg, recsys.DINConfig):
        model = recsys.init_din(cfg, device=dev, mesh=mesh)
        pipe = RecsysPipeline(n_items=cfg.n_items, batch_size=32,
                              history_len=cfg.seq_len, kind="ctr")
    else:
        model = recsys.init_bst(cfg, device=dev, mesh=mesh)
        pipe = RecsysPipeline(n_items=cfg.n_items, batch_size=32,
                              history_len=cfg.seq_len - 1, kind="ctr")
    return TrainSetup(model, recsys_loss_fn(cfg), make_recsys_train_step(cfg, hp),
                      _rank_rows(pipe.get_batch, mesh))


def _restore_into(live, restored) -> None:
    """Copy a restored tree (numpy arrays; bf16 leaves as tensors) into the
    live tensors of the same structure, in place."""
    if isinstance(live, torch.Tensor):
        with torch.no_grad():
            live.copy_(torch.as_tensor(restored))
        return
    if isinstance(live, dict):
        for key in live:
            _restore_into(live[key], restored[key])
        return
    for a, b in zip(live, restored, strict=True):
        _restore_into(a, b)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(
    *,
    arch: str,
    steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    mesh=None,
    smoke_overrides: dict | None = None,
    log_every: int = 10,
    device: str | torch.device = "cuda",
    total_steps: int | None = None,
) -> dict:
    """Run a real training loop on ``device`` (reduced configs).

    Returns the final step's scalar metrics as floats. With ``ckpt_dir`` it
    resumes from the newest checkpoint there, saves one asynchronously every
    ``ckpt_every`` steps and a last one at ``steps``, keeping 3.
    ``total_steps`` is the learning-rate schedule's horizon (``steps`` when
    omitted, as in the reference): a run stopped at step 4 of 6 and resumed
    takes the uninterrupted run's steps only if both name the same horizon.

    With a ``mesh`` (a ``DeviceMesh``; every rank of it calls this, on its
    own ``device``) each step runs under ``use_mesh(mesh)`` on the rank's
    rows of the pipeline's batch over the data axes (a graph's blocks of
    nodes and edges), and the gradients are averaged over them
    (:func:`make_train_step`). A rank holds its blocks of the model and of
    the moments (see the module doc; ``smoke_overrides={"fsdp": True}``
    adds FSDP to an LM; a GAT's weights are whole). A checkpoint holds
    whole tensors, gathered in rank order, as one process's does; the
    mesh's first rank writes it, every rank resumes from it (cutting its
    blocks), and the ranks meet at a barrier after the last save.
    """
    from repro_torch.configs.base import get_arch

    if mesh is not None and not hasattr(mesh, "get_coordinate"):
        raise TypeError("train_loop runs on the ranks of a DeviceMesh "
                        "(launch.mesh.make_mesh); a {axis: size} mapping describes cells only")
    arch_def = get_arch(arch)
    cfg = arch_def.make_smoke_config()
    if smoke_overrides:
        cfg = dataclasses.replace(cfg, **smoke_overrides)
    horizon = steps if total_steps is None else total_steps
    hp = TrainHyperparams(warmup_steps=max(2, horizon // 10), total_steps=horizon)
    dev = device_of(device)
    run = setup(arch_def.family, cfg, hp, dev, mesh=mesh)
    params = params_of(run.model)
    opt_state = adamw_init(params)
    blocks = getattr(run.model, "mesh", None) is not None
    specs = None
    if blocks:
        pspecs = {name: p.spec for name, p in params.items()}
        specs = {"params": pspecs, "opt": opt_state._replace(step=(), m=pspecs, v=pspecs)}

    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        restored, at = mgr.restore(like={"params": params, "opt": opt_state},
                                   specs=specs, mesh=mesh if blocks else None)
        if restored is not None:
            _restore_into(params, restored["params"])
            _restore_into([opt_state.m, opt_state.v], [restored["opt"].m, restored["opt"].v])
            opt_state = opt_state._replace(step=torch.as_tensor(
                np.asarray(restored["opt"].step), dtype=torch.int32, device=dev))
            start_step = at
            print(f"[train] resumed from step {at}")

    writer = mesh is None or all(c == 0 for c in mesh.get_coordinate())
    get_batch = run.get_batch
    timer = StepTimer()
    metrics = {}
    for s in range(start_step, steps):
        batch = get_batch(s)
        timer.start()
        with use_mesh(mesh):
            _, opt_state, metrics = run.step_fn(run.model, opt_state, batch)
        _sync(dev)
        timer.stop(0)
        if s % log_every == 0 or s == steps - 1:
            print(
                f"[train] step {s} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics.get('grad_norm', 0)):.2f} "
                f"({timer.rank_ema.get(0, 0)*1e3:.0f} ms/step)"
            )
        if mgr and (writer or blocks) and (s + 1) % ckpt_every == 0:
            mgr.save({"params": params, "opt": opt_state}, s + 1, blocking=False,
                     specs=specs, mesh=mesh if blocks else None)
    if mgr and (writer or blocks):
        mgr.save({"params": params, "opt": opt_state}, steps, blocking=True,
                 specs=specs, mesh=mesh if blocks else None)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    return {k: float(v) for k, v in metrics.items() if v.dim() == 0}


def _rank_rows(get_batch: Callable, mesh) -> Callable:
    """``get_batch`` restricted to this rank's rows over the data axes: the
    block ``r`` of ``q`` equal blocks of every entry's first dim, ``r`` the
    rank's row-major place over ``("pod", "data")`` and ``q`` their size."""
    from repro_torch.core.distributed import _axis_index, _axis_size

    if mesh is None:
        return get_batch
    sizes = axis_sizes(mesh)
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    if not daxes:
        return get_batch
    q, r = _axis_size(mesh, daxes), _axis_index(mesh, daxes)

    def rows(s):
        out = {}
        for key, x in get_batch(s).items():
            if x.shape[0] % q:
                raise ValueError(f"batch entry {key!r} of {x.shape[0]} rows does not "
                                 f"split over {q} data ranks")
            n = x.shape[0] // q
            out[key] = x[r * n:(r + 1) * n]
        return out

    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = train_loop(arch=args.arch, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     device=args.device)
    print("[train] final:", out)


if __name__ == "__main__":
    main()
