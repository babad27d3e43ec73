"""Shared setup of the port's distributed parity tests.

The port runs a list of variants in gloo ranks spawned on the CPU
(``repro_torch.launch.apss_mesh.run_variants``); the reference runs the same
``apss`` call (same distribution, mesh and keyword arguments) on a JAX mesh
over the first ``p`` of the test session's virtual CPU devices.
"""

from __future__ import annotations

import numpy as np

T, K = 0.35, 16
PG_TIMEOUT_S = 60.0     # a collective that waits longer raises
JOIN_TIMEOUT_S = 240.0  # one set of ranks, every variant


def variant(name, distribution, shape, names, corpus="dense", *, gather=None,
            scatter=False, threshold=T, ticks=False, **kwargs) -> dict:
    return dict(name=name, distribution=distribution, mesh=(shape, names), corpus=corpus,
                gather=gather, scatter=scatter, threshold=threshold, ticks=ticks,
                kwargs=kwargs)


def run_ranks(run_dir, p: int, corpora: dict, variants: list) -> dict:
    """Rank 0's records of ``variants``, run in ``p`` spawned gloo ranks."""
    from repro_torch.launch.mesh import spawn

    return spawn(
        "repro_torch.launch.apss_mesh:run_variants", p, corpora, variants, T, K,
        device="cpu", threads=1, run_dir=run_dir, pg_timeout=PG_TIMEOUT_S,
        join_timeout=JOIN_TIMEOUT_S,
    )[0]


def jax_mesh(shape, names):
    import jax

    from repro.compat import make_mesh

    return make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])


_RUNS: dict = {}


def _digest(corpus) -> str:
    import hashlib

    h = hashlib.sha1()
    for x in (corpus.indices, corpus.values, corpus.nnz) if hasattr(corpus, "nnz") else (corpus,):
        h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    return h.hexdigest()


def jax_run(corpus, v: dict, *, records: bool = False):
    """The reference's ``apss`` on the same variant: ``(Matches, stats)``,
    and with ``records`` its telemetry records too. Each (variant, corpus)
    runs once per test process: the call runs under a telemetry log and its
    result and records are kept for the next asker."""
    from repro.core.distributed import apss
    from repro.planner import CommLog

    key = (v["name"], _digest(corpus))
    if key not in _RUNS:
        with CommLog() as log:
            out = apss(corpus, v["threshold"], K, jax_mesh(*v["mesh"]),
                       distribution=v["distribution"], **v["kwargs"])
        _RUNS[key] = (out if isinstance(out, tuple) and len(out) == 2 else (out, None),
                      log.records)
    out, recs = _RUNS[key]
    return (*out, recs) if records else out


def record_fields(r) -> dict:
    """A record of either package (a port record as ``run_variants``
    returns it, or a JAX ``ApssStats``) as comparable values."""
    import dataclasses

    if not isinstance(r, dict):
        r = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        r["hops"] = [dataclasses.asdict(h) for h in r["hops"]]
    keep = ("variant", "n", "m", "devices", "block_rows", "sparse", "hops", "flops",
            "live_tiles", "total_tiles", "tile_counts", "extra")
    return {key: r[key] for key in keep}


def assert_same_records(got: list, ref: list) -> None:
    import pytest

    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = record_fields(g), record_fields(r)
        assert g.pop("flops") == pytest.approx(r.pop("flops"), rel=1e-12, abs=0)
        assert g == r


def elastic_ranks(rank, world, dev) -> dict:
    """Rank function (``launch.mesh.spawn``) of ``tests/test_torch_elastic.py``:
    the reference's elastic cases (``tests/test_substrates.py``) on this
    rank, and ``mesh_after_eviction``'s edges. Every rank takes part in
    creating every mesh, those outside it too."""
    from types import SimpleNamespace

    from repro_torch.distributed.elastic import (
        ElasticPlan,
        make_elastic_mesh,
        reshard_tree,
        rescale,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.robust import mesh_after_eviction

    state = {"w": np.arange(32, dtype=np.float32).reshape(8, 4),
             "b": (np.arange(3, dtype=np.int32), np.ones((5, 2), np.float32))}
    specs = {"w": ("data", "model"), "b": (("data",), ("expert", None))}
    big = make_elastic_mesh(4, model_parallel=2)
    small = make_elastic_mesh(2, model_parallel=2)
    odd = make_elastic_mesh(3, model_parallel=2)
    out = {"big": tuple(big.mesh.shape), "small": tuple(small.mesh.shape),
           "odd": tuple(odd.mesh.shape), "describe": ElasticPlan(small, "lost 2").describe()}
    try:
        make_elastic_mesh(1, model_parallel=2)
    except ValueError as e:
        out["too_few"] = str(e)
    on_big = reshard_tree(state, specs, big)
    out["big_full"] = on_big["w"].full_tensor().numpy()
    out["big_local"] = on_big["w"].to_local().numpy()
    out["big_placements"] = [str(p) for p in on_big["w"].placements]
    out["b_placements"] = [[str(p) for p in x.placements] for x in on_big["b"]]
    out["b_full"] = [x.full_tensor().numpy() for x in on_big["b"]]
    if small.get_coordinate() is not None:
        on_small = rescale(lambda: state, specs, ElasticPlan(small))
        out["small_full"] = on_small["w"].full_tensor().numpy()
        out["small_local"] = on_small["w"].to_local().numpy()
        out["small_devices"] = on_small["w"].device_mesh.mesh.numel()
    flat = make_mesh((world,), ("data",))
    out["noop"] = mesh_after_eviction(flat, SimpleNamespace(evict=[])) is flat
    try:
        mesh_after_eviction(flat, SimpleNamespace(evict=list(range(world))))
    except ValueError as e:
        out["all_evicted"] = str(e)
    return out


_OBS: dict = {}


def obs_runs(run_dir) -> list:
    """Every rank's :func:`obs_ranks` result, run once per test process (in 4
    gloo ranks) for ``tests/test_torch_op_analysis.py`` and
    ``tests/test_torch_audit.py``."""
    from repro_torch.launch.mesh import spawn

    if "ranks" not in _OBS:
        _OBS["ranks"] = spawn("_torch_dist:obs_ranks", 4, device="cpu", threads=1,
                              run_dir=str(run_dir), pg_timeout=PG_TIMEOUT_S,
                              join_timeout=JOIN_TIMEOUT_S)
    return _OBS["ranks"]


def obs_ranks(rank, world, dev) -> dict:
    """Rank function (``launch.mesh.spawn``): :func:`census_ranks`, then the
    port's audit at the reference's defaults (``obs.audit.audit_ranks``:
    n = m = 64, t = 0.3, k = 8, meshes ``(4,)`` and ``(2, 2)``; rank 0's
    report, with serving and the live index)."""
    from repro_torch.obs.audit import audit_ranks

    return {"census": census_ranks(rank, world, dev),
            "audit": audit_ranks(rank, world, dev, {})}


def census_ranks(rank, world, dev) -> dict:
    """Each of the collective helpers of ``core.distributed`` alone under an
    op census, over the ``(world,)`` mesh and over the size-2 ``model`` axis
    of a ``(world / 2, 2)`` mesh, on a (16, 8) float32 tensor. Returns the
    census of each as ``{(helper, p): counts}``."""
    import torch

    from repro_torch.core import distributed as dd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_analysis import analyze

    flat = make_mesh((world,), ("data",))
    grid = make_mesh((world // 2, 2), ("data", "model"))
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8) + rank
    out = {}
    for mesh, axis in ((flat, "data"), (grid, "model")):
        p = dd._axis_size(mesh, axis)
        calls = {
            "ppermute": lambda: dd._ppermute((x,), mesh, axis, dd._ring_perm(p)),
            "psum": lambda: dd._psum(x, mesh, axis),
            "pmax": lambda: dd._pmax(x, mesh, axis),
            "psum_scatter": lambda: dd._psum_scatter(x, mesh, axis),
            "all_gather": lambda: dd._all_gather(x, mesh, axis),
        }
        for name, call in calls.items():
            out[(name, p)] = analyze(call)[1]
    return out


APSS_CELLS = dict(n=512, m=192, t=0.35)  # v_compressed's block_rows=512 needs n ≥ 512
_CELLS: dict = {}


def apss_cell_config(config: dict) -> dict:
    """``config`` (the ``apss`` arch's full config, either package) with both
    datasets cut to :data:`APSS_CELLS`."""
    cfg = dict(config)
    cfg["wikipedia"] = dict(APSS_CELLS)
    cfg["20news"] = dict(APSS_CELLS)
    return cfg


def apss_cell_runs(run_dir, corpus_path: str) -> dict:
    """Rank 0's ``launch.apss_mesh.run_cells`` result for every cell of the
    port's ``apss`` arch at :data:`APSS_CELLS` on a (2, 2) ``("data",
    "model")`` mesh, run once per test process in 4 gloo ranks
    (``tests/test_torch_configs.py``), and every rank's matches."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import spawn

    if "ranks" not in _CELLS:
        arch = get_arch("apss")
        cells = [(name, corpus_path) for name in arch.shapes]
        _CELLS["ranks"] = spawn(
            "repro_torch.launch.apss_mesh:run_cells", 4, cells,
            apss_cell_config(arch.make_config()), device="cpu", threads=1,
            run_dir=str(run_dir), pg_timeout=PG_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S)
    return _CELLS["ranks"]


def compression_ranks(rank, world, dev, grads: list, errors: dict, ratio: float,
                      min_size: int) -> list:
    """Rank function (``launch.mesh.spawn``) of ``tests/test_torch_optim.py``:
    ``compress_tree`` over the ``(world,)`` mesh's ``data`` axis, one call per
    entry of ``grads`` (each a ``{name: (world, ...)}`` dict, this rank's
    row its leaf), carrying the error state from one call to the next from
    ``errors``. Returns ``[(synced, errors)]`` as numpy, one per call."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import CompressionState, compress_tree

    mesh = make_mesh((world,), ("data",))

    def mine(tree):
        return {k: torch.from_numpy(np.ascontiguousarray(v[rank:rank + 1])) for k, v in
                tree.items()}

    state = CompressionState(error=mine(errors))
    out = []
    for g in grads:
        synced, state = compress_tree(mine(g), state, mesh, "data", ratio=ratio,
                                      min_size=min_size)
        out.append(({k: v.numpy() for k, v in synced.items()},
                    {k: v.numpy() for k, v in state.error.items()}))
    return out


def mesh_ranks(rank, world, dev, spec: dict) -> dict:
    """Rank function (``launch.mesh.spawn``) of ``tests/test_torch_mesh.py``
    on a ``(2, 2)`` ``("data", "model")`` mesh: the sequence-sharded decodes
    of ``spec["decode"]``, ``moe_ffn_ep`` on ``spec["ep"]``, mesh train
    steps on ``spec["train"]``, ``train_loop(mesh=)`` stopped and resumed
    under ``spec["run_dir"]``, and the op census of :data:`CUT_TRAIN`'s
    cell. Returns numpy results; rank-specific entries carry the rank."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.manual_seed(0)
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"coord": tuple(mesh.get_coordinate())}
    out["decode"] = {name: _mesh_decode(mesh, **case) for name, case in spec["decode"].items()}
    out["ep"] = _mesh_ep(mesh, **spec["ep"])
    out["train"] = {name: _mesh_train(mesh, **case) for name, case in spec["train"].items()}
    out["loop"] = _mesh_loop(mesh, spec["run_dir"], rank)
    out["census"] = _mesh_census(mesh)
    return out


def _rows(x, mesh, axes):
    """This rank's block of ``x``'s first dim over the mesh axes ``axes``."""
    from repro_torch.core.distributed import _axis_index, _axis_size

    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not axes:
        return x
    q, r = _axis_size(mesh, axes), _axis_index(mesh, axes)
    n = x.shape[0] // q
    return x[r * n:(r + 1) * n]


def _mesh_decode(mesh, cfg, tree, tokens, max_len, seq_axes, batch_axes) -> dict:
    """Decode ``tokens (B, S)`` one step at a time into a cache of ``max_len``
    sharded by ``seq_axes``/``batch_axes``: each step's logits of the rank's
    rows, and each step's largest ``l`` of the rank's last attention layer
    (its largest ``m`` where every ``l`` is 0: ``NEG_LARGE`` for a block
    with no position)."""
    import torch

    from repro_torch import interop
    from repro_torch.models import transformer as tt

    model = interop.transformer_params_from_numpy(tree, cfg, "cpu")
    cache = tt.make_cache(cfg, tokens.shape[0], max_len, device="cpu", mesh=mesh,
                          seq_axes=seq_axes, batch_axes=batch_axes)
    mine = torch.as_tensor(_rows(tokens, mesh, batch_axes))
    logits, l_max = [], []
    for i in range(mine.shape[1]):
        step, cache = tt.decode_step(model, cfg, cache, mine[:, i])
        logits.append(step.numpy())
        m, l = cache["layout"].last_partials
        l_max.append(float(l.max()) if float(l.max()) > 0 else float(m.max()))
    return {"logits": np.stack(logits), "l_max": l_max,
            "offset": cache["layout"].offset, "local_len": cache["layout"].local_len}


def _moe_from_numpy(tree, requires_grad=False):
    import torch

    from repro_torch.models.moe import MoEParams

    d, E = tree["router"].shape
    p = MoEParams(d, tree["w_gate"].shape[2], E, torch.float32, "cpu")
    with torch.no_grad():
        for name, value in tree.items():
            getattr(p, name).copy_(torch.as_tensor(value))
    return p.requires_grad_(requires_grad)


def _mesh_ep(mesh, tree, x, top_k, factors) -> dict:
    """``moe_ffn_ep`` on the rank's rows of ``x`` at each capacity factor
    (``y`` rows, aux, drops), and at the first factor the gradients of
    ``p_data · Σ y² + aux`` averaged over ``data``: the share of the global
    ``Σ y² + aux`` each data rank's mean takes (``launch.train``)."""
    import torch

    from repro_torch.core.distributed import psum_in_order
    from repro_torch.models.moe import local_experts, moe_ffn_ep

    mine = torch.as_tensor(_rows(x, mesh, ("data",)))
    out = {}
    for cf in factors:
        with torch.no_grad():
            r = moe_ffn_ep(_moe_from_numpy(tree), mine, top_k=top_k, capacity_factor=cf,
                           mesh=mesh, data_axes=("data",))
        out[cf] = {"y": r.y.numpy(), "aux": float(r.aux_loss), "dropped": float(r.dropped_frac)}
    local = local_experts(_moe_from_numpy(tree), mesh)
    with torch.no_grad():
        r = moe_ffn_ep(local, mine, top_k=top_k, capacity_factor=factors[0], mesh=mesh,
                       data_axes=("data",))
    out["local_y"] = r.y.numpy()
    params = _moe_from_numpy(tree, requires_grad=True)
    r = moe_ffn_ep(params, mine, top_k=top_k, capacity_factor=factors[0], mesh=mesh,
                   data_axes=("data",))
    (2 * torch.sum(r.y ** 2) + r.aux_loss).backward()
    out["grads"] = {name: (psum_in_order(p.grad, mesh, ("data",)) / 2).numpy()
                    for name, p in params.named_parameters()}
    return out


def _mesh_train(mesh, cfg, tree, batch, hp) -> dict:
    """One ``make_lm_train_step`` on the rank's rows of ``batch`` under
    ``use_mesh(mesh)``: metrics and the parameters after, as the leaves of
    the reference's tree in its flattening order."""
    from repro_torch import interop, optim
    from repro_torch.distributed import use_mesh
    from repro_torch.launch import train
    from repro_torch.optim.optimizer import tree_leaves

    model = interop.transformer_params_from_numpy(tree, cfg, "cpu")
    opt = optim.adamw_init(train.params_of(model))
    mine = {k: _rows(v, mesh, ("data",)) for k, v in batch.items()}
    with use_mesh(mesh):
        _, _, metrics = train.make_lm_train_step(cfg, hp)(model, opt, mine)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": tree_leaves(interop.transformer_params_to_numpy(model))}


def _mesh_loop(mesh, run_dir, rank) -> dict:
    """``train_loop(mesh=)`` on deepseek-moe-16b's smoke config with
    ``moe_impl="ep"`` at capacity factor 16 and aux loss weight 0: 4 steps straight, and 2 steps
    then a resume to 4; both final checkpoints' leaves (read by every
    rank), and the straight run's metrics."""
    import os

    from repro_torch import checkpoint as ck
    from repro_torch.launch import train

    kw = dict(arch="deepseek-moe-16b", mesh=mesh, device="cpu", ckpt_every=2, log_every=100,
              smoke_overrides={"moe_impl": "ep", "capacity_factor": 16.0,
                               "aux_loss_weight": 0.0})
    straight, resumed = (os.path.join(run_dir, name) for name in ("straight", "resumed"))
    first = train.train_loop(steps=4, ckpt_dir=straight, **kw)
    train.train_loop(steps=2, ckpt_dir=resumed, total_steps=4, **kw)
    again = train.train_loop(steps=4, ckpt_dir=resumed, **kw)

    def leaves(d):
        return {k: np.asarray(v.float() if hasattr(v, "float") else v)
                for k, v in ck.load_checkpoint(d, 4).items()}
    return {"straight": first, "resumed": again, "straight_ck": leaves(straight),
            "resumed_ck": leaves(resumed), "steps": ck.CheckpointManager(resumed).all_steps()}


CUT_TRAIN = dict(arch="qwen3-1.7b", shape="train_4k_cut", global_batch=4, seq_len=64)


def register_cut_train_cell() -> None:
    """Register ``train_4k``'s builder at 4 × 64 tokens as qwen3-1.7b's
    ``train_4k_cut`` cell (a smoke-size census on CPU ranks)."""
    from repro_torch.configs import ShapeCell, get_arch
    from repro_torch.configs.lm_common import build_train_cell

    get_arch(CUT_TRAIN["arch"]).shapes[CUT_TRAIN["shape"]] = ShapeCell(
        "train", "train_4k's builder at 4 × 64 tokens",
        lambda cfg, mesh: build_train_cell(cfg, mesh, global_batch=CUT_TRAIN["global_batch"],
                                           seq_len=CUT_TRAIN["seq_len"]))


def _mesh_census(mesh) -> dict:
    """The op census of :data:`CUT_TRAIN`'s cell at the smoke config on
    this rank, run on real local arguments (zeros; token ids 0)."""
    from repro_torch.launch import dryrun

    register_cut_train_cell()
    return dryrun.census_on_ranks(CUT_TRAIN["arch"], CUT_TRAIN["shape"], mesh)


TP_MESHES = {"data2_model2": ((2, 2), ("data", "model")), "model4": ((4,), ("model",))}
# Heads that model does not divide: model=4 in all 4 ranks, and model=3 on
# ranks 0-2 (the card's geometry), a mesh smaller than the group.
PADDED_MESHES = {"model4": ((4,), ("model",), None), "model3": ((3,), ("model",), (0, 1, 2))}


def tp_ranks(rank, world, dev, spec: dict) -> dict:
    """Rank function of ``tests/test_torch_tensor_parallel.py``: on each mesh
    of :data:`TP_MESHES` (both in the same 4 ranks), every LM family of
    ``spec["models"]`` as the rank's blocks of one numpy tree (``interop``
    with ``mesh=``): parameter shapes, prefill logits and ``transformer_loss``
    on the rank's rows, and decode steps into a cache with the sequence over
    ``model`` (the batch over ``data``); on the first mesh, FSDP train steps
    (``spec["train"]``), 2 FSDP steps of a padded GQA config
    (``spec["padded_train"]``) and ``train_loop(mesh=)`` straight and
    resumed (``spec["loop"]``). Then on each mesh of :data:`PADDED_MESHES`
    the configs of ``spec["padded"][mesh]``, whose heads it pads, as the
    families above, and on ``model4`` their interop and checkpoint round
    trips."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.manual_seed(0)
    out = {}
    for name, (shape, names) in TP_MESHES.items():
        mesh = make_mesh(shape, names)
        res = {"coord": tuple(mesh.get_coordinate()),
               "models": {arch: _tp_model(mesh, **case) for arch, case in spec["models"].items()}}
        if name == "data2_model2":
            res["train"] = {arch: _tp_train(mesh, **case) for arch, case in spec["train"].items()}
            res["padded_train"] = _tp_padded_train(mesh, **spec["padded_train"])
            res["loop"] = _tp_loop(mesh, **spec["loop"])
        else:
            res["server"] = _tp_server(mesh, **spec["server"])
        out[name] = res
    for name, (shape, names, members) in PADDED_MESHES.items():
        mesh = make_mesh(shape, names, ranks=members)
        if mesh.get_coordinate() is None:       # outside the sub-mesh: sit the phase out
            continue
        cases = spec["padded"][name]
        res = out.setdefault(name, {})
        res["padded"] = {key: _tp_model(mesh, **case) for key, case in cases.items()}
        if name == "model4":
            res["round_trip"] = {key: _tp_round_trip(mesh, case["cfg"], case["tree"],
                                                     f"{spec['run_dir']}/{key}")
                                 for key, case in cases.items()}
    return out


def _padded_entries(model, opt=None) -> dict:
    """``{name: (entries, max |weight|, max |m|, max |v|)}`` over the zero
    heads of each block that holds some (a ``HeadBlocks`` entry in its
    spec): how many entries are padding and their largest magnitudes."""
    import torch

    from repro_torch.core.distributed import _axis_index
    from repro_torch.distributed.elastic import HeadBlocks

    out = {}
    for name, p in model.named_parameters():
        for dim, part in enumerate(getattr(p, "spec", None) or ()):
            if not isinstance(part, HeadBlocks):
                continue
            zero = part.heads * part.width
            idx = [i for i, r in enumerate(part.rows(_axis_index(p.mesh, part.axis)))
                   if r == zero]
            if not idx:
                continue
            at = torch.tensor(idx)
            held = [p] + ([] if opt is None else [opt.m[name], opt.v[name]])
            out[name] = (len(idx) * p.numel() // p.shape[dim],
                         *(float(t.detach().index_select(dim, at).abs().max()) for t in held))
    return out


def _tp_model(mesh, cfg, tree, tokens, steps, max_len) -> dict:
    import torch

    from repro_torch import interop
    from repro_torch.distributed import use_mesh
    from repro_torch.models import transformer as tt

    model = interop.transformer_params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    rows = torch.as_tensor(_rows(tokens, mesh, ("data",)))
    with torch.no_grad(), use_mesh(mesh):
        total, aux = tt.transformer_loss(model, cfg, {"tokens": rows})
    cache = tt.make_cache(cfg, tokens.shape[0], max_len, device="cpu", mesh=mesh,
                          seq_axes=("model",), batch_axes=("data",))
    logits = []
    for i in range(steps):
        step, cache = tt.decode_step(model, cfg, cache, rows[:, i])
        logits.append(step.numpy())
    return {"shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "prefill": tt.prefill(model, cfg, rows).numpy(),
            "loss": {k: float(v) for k, v in {"total": total, **aux}.items()},
            "decode": np.stack(logits), "heads": model.blocks()[0].attn.cut.heads,
            "padded": _padded_entries(model)}


def _tp_round_trip(mesh, cfg, tree, run_dir) -> dict:
    """The rank's blocks of ``tree`` carried back through ``interop`` (the
    reference's tree, gathered), and through a checkpoint of the blocks
    (gathered whole, written by the first rank) restored onto the mesh: the
    tree's leaves, the checkpoint's shapes, and whether every restored
    block equals the rank's bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch import checkpoint as ck
    from repro_torch import interop
    from repro_torch.optim.optimizer import tree_leaves

    model = interop.transformer_params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    params = dict(model.named_parameters())
    specs = {"params": {n: p.spec for n, p in params.items()}}
    mgr = ck.CheckpointManager(run_dir)
    mgr.save({"params": params}, 1, specs=specs, mesh=mesh)
    dist.barrier()
    restored, _ = mgr.restore(like={"params": params}, specs=specs, mesh=mesh)
    same = all(torch.equal(torch.as_tensor(np.asarray(restored["params"][n])), p.detach())
               for n, p in params.items())
    return {"tree": tree_leaves(interop.transformer_params_to_numpy(model)),
            "ckpt_shapes": {k: tuple(np.shape(v)) for k, v in ck.load_checkpoint(run_dir,
                                                                                  1).items()},
            "restored_equal": same}


def _tp_padded_train(mesh, cfg, tree, batch, hp, steps) -> dict:
    """``steps`` FSDP ``make_lm_train_step`` steps of a config whose heads
    ``model`` pads, on the rank's rows: each step's metrics, the parameters
    and AdamW moments after the first (gathered whole), and the padded
    entries of the rank's blocks and moments after the last."""
    from repro_torch import interop, optim
    from repro_torch.distributed import use_mesh
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train
    from repro_torch.optim.optimizer import tree_leaves

    model = interop.transformer_params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    opt = optim.adamw_init(train.params_of(model))
    mine = {k: _rows(v, mesh, ("data",)) for k, v in batch.items()}
    step = train.make_lm_train_step(cfg, hp)
    specs = {n: p.spec for n, p in model.named_parameters()}
    metrics, first = [], None
    for i in range(steps):
        with use_mesh(mesh):
            _, opt, met = step(model, opt, mine)
        metrics.append({k: float(v) for k, v in met.items()})
        if i == 0:
            # copies: a whole leaf's gathered moment is the live one, which step 2 updates
            first = {"params": tree_leaves(interop.transformer_params_to_numpy(model)),
                     "moments": {k: {n: t.numpy().copy() for n, t in
                                     gather_tree(getattr(opt, k), specs, mesh).items()}
                                 for k in ("m", "v")}}
    return {"metrics": metrics, "first": first, "padded": _padded_entries(model, opt),
            "heads": model.blocks()[0].attn.cut.heads}


def _tp_server(mesh, cfg, tree, prompts, gen) -> list:
    """``LMServer`` inside the ranks (the rank's blocks, the cache's
    sequence over ``model``): each request's greedy tokens."""
    from repro_torch import interop
    from repro_torch.launch.serve import LMServer

    srv = LMServer(cfg, max_batch=len(prompts), max_len=32, device="cpu", mesh=mesh,
                   params=interop.transformer_params_from_numpy(tree, cfg, "cpu", mesh=mesh))
    return [srv.generate(srv.add_request(p), gen) for p in prompts]


def _tp_train(mesh, cfg, tree, batch, hp) -> dict:
    """One FSDP ``make_lm_train_step`` on the rank's rows: metrics, and the
    parameters and AdamW moments after it, gathered whole (numpy, by
    parameter name)."""
    from repro_torch import interop, optim
    from repro_torch.distributed import use_mesh
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train
    from repro_torch.optim.optimizer import tree_leaves

    model = interop.transformer_params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    opt = optim.adamw_init(train.params_of(model))
    mine = {k: _rows(v, mesh, ("data",)) for k, v in batch.items()}
    with use_mesh(mesh):
        _, opt, metrics = train.make_lm_train_step(cfg, hp)(model, opt, mine)
    specs = {n: p.spec for n, p in model.named_parameters()}
    moments = {k: {n: t.numpy() for n, t in gather_tree(getattr(opt, k), specs, mesh).items()}
               for k in ("m", "v")}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": tree_leaves(interop.transformer_params_to_numpy(model)), "moments": moments,
            "moment_shapes": {n: tuple(t.shape) for n, t in opt.m.items()}}


def _tp_loop(mesh, run_dir, arch, overrides) -> dict:
    """``train_loop(mesh=)`` with FSDP: 4 steps straight, and 2 steps then a
    resume to 4; both final checkpoints' leaves, and the straight one
    restored onto the mesh (each rank cutting its blocks) and gathered
    back whole."""
    import dataclasses
    import os

    from repro_torch import checkpoint as ck
    from repro_torch import interop, optim
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.optim.optimizer import tree_leaves

    kw = dict(arch=arch, mesh=mesh, device="cpu", ckpt_every=2, log_every=100,
              smoke_overrides=overrides)
    straight, resumed = (os.path.join(run_dir, name) for name in ("straight", "resumed"))
    first = train.train_loop(steps=4, ckpt_dir=straight, **kw)
    train.train_loop(steps=2, ckpt_dir=resumed, total_steps=4, **kw)
    again = train.train_loop(steps=4, ckpt_dir=resumed, **kw)

    cfg = dataclasses.replace(get_arch(arch).make_smoke_config(), **overrides)
    run = train.setup("lm", cfg, train.TrainHyperparams(), "cpu", mesh=mesh)
    params = train.params_of(run.model)
    state = optim.adamw_init(params)
    specs = {n: p.spec for n, p in params.items()}
    restored, _ = ck.CheckpointManager(straight).restore(
        like={"params": params, "opt": state}, specs={"params": specs, "opt": state._replace(
            step=(), m=specs, v=specs)}, mesh=mesh)
    train._restore_into(params, restored["params"])

    def leaves(d):
        return {k: np.asarray(v.float() if hasattr(v, "float") else v)
                for k, v in ck.load_checkpoint(d, 4).items()}
    return {"straight": first, "resumed": again, "straight_ck": leaves(straight),
            "resumed_ck": leaves(resumed), "steps": ck.CheckpointManager(resumed).all_steps(),
            "restored": tree_leaves(interop.transformer_params_to_numpy(run.model)),
            "straight_dir": straight}


RG_MESHES = {"data2_model2": ((2, 2), ("data", "model")), "model4": ((4,), ("model",)),
             "data4": ((4,), ("data",))}


def recsys_gnn_ranks(rank, world, dev, spec: dict) -> dict:
    """Rank function of ``tests/test_torch_recsys_gnn_parallel.py``: on each
    mesh of :data:`RG_MESHES` (all in the same 4 ranks), every recsys case
    of ``spec["recsys"]`` (not on ``data4``) and the GAT case
    ``spec["gat"]`` as the rank's blocks of one numpy tree (``interop``
    with ``mesh=``); on the first mesh also the vocab-parallel lookup, the
    ``sharded_retrieval`` cell and ``train_loop(mesh=)`` straight and
    resumed (``spec["loops"]``)."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.manual_seed(0)
    out = {}
    for name, (shape, names) in RG_MESHES.items():
        mesh = make_mesh(shape, names)
        res = {"coord": tuple(mesh.get_coordinate()), "gat": _rg_gat(mesh, **spec["gat"])}
        if name != "data4":
            res["recsys"] = {arch: _rg_recsys(mesh, **case)
                             for arch, case in spec["recsys"].items()}
        if name == "data2_model2":
            res["lookup"] = _rg_lookup(mesh, **spec["lookup"])
            res["retrieval"] = _rg_retrieval(mesh, **spec["retrieval"])
            res["loops"] = {arch: _rg_loop(mesh, arch=arch, run_dir=d)
                            for arch, d in spec["loops"].items()}
        out[name] = res
    return out


def _rg_step(mesh, model, loss_fn, step_fn, batch, to_numpy) -> dict:
    """Loss, metrics and gradients (averaged over the data axes, gathered
    whole) of the rank's batch, then one step: its metrics, the parameters
    and AdamW moments after it (gathered whole), the moments' shapes and
    the padded heads' entries of the rank's blocks."""
    from repro_torch import interop, optim
    from repro_torch.distributed import use_mesh
    from repro_torch.launch import train

    with use_mesh(mesh):
        loss, aux, grads = train.grads_of(loss_fn, model, batch)
        grads, loss, aux = train._mean_over_data(grads, loss, aux, train.params_of(model))
        opt = optim.adamw_init(train.params_of(model))
        _, opt, metrics = step_fn(model, opt, batch)
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "grads": interop.named_to_numpy(model, grads, to_numpy),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": to_numpy(model),
            "m": interop.named_to_numpy(model, opt.m, to_numpy),
            "v": interop.named_to_numpy(model, opt.v, to_numpy),
            "moment_shapes": {n: tuple(t.shape) for n, t in opt.m.items()},
            "padded": _padded_entries(model, opt)}


def _rg_recsys(mesh, cfg, tree, batch, score_fn, loss_fn, hp) -> dict:
    import copy

    import torch

    from repro_torch import interop
    from repro_torch.distributed import use_mesh
    from repro_torch.distributed.sharding import cut_tree, gather_tree
    from repro_torch.launch import train
    from repro_torch.models import recsys

    model = interop.recsys_params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    rows = {k: _rows(v, mesh, ("data",)) for k, v in batch.items()}
    # copies: a whole leaf's array shares the live parameter's memory
    out = {"shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
           "round_trip": copy.deepcopy(interop.recsys_params_to_numpy(model))}
    whole = interop.recsys_params_from_numpy(tree, cfg, "cpu")
    cut = cut_tree(whole, recsys.layout_specs(cfg, mesh), mesh)
    back = gather_tree(cut, None, mesh)
    out["cut_tree"] = (cut.mesh is model.mesh
                       and all(torch.equal(a, b) and a.spec == b.spec for a, b in
                               zip(cut.parameters(), model.parameters()))
                       and all(torch.equal(a, b) for a, b in
                               zip(back.parameters(), whole.parameters())))
    with torch.no_grad(), use_mesh(mesh):
        out["score"] = score_fn(model, cfg, rows).numpy()
    out.update(_rg_step(mesh, model, lambda p, b: loss_fn(p, cfg, b),
                        train.make_recsys_train_step(cfg, hp), rows,
                        interop.recsys_params_to_numpy))
    return out


def _rg_gat(mesh, cfg, tree, graph, hp) -> dict:
    import copy

    import torch

    from repro_torch import interop
    from repro_torch.distributed import use_mesh
    from repro_torch.launch import train
    from repro_torch.models import gnn

    model = interop.gat_params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    axes = gnn.graph_axes(mesh, len(graph["labels"]), len(graph["edge_src"]))
    g = {k: torch.as_tensor(v) for k, v in gnn.cut_graph(graph, axes, mesh).items()}
    out = {"axes": axes, "block": {k: tuple(v.shape) for k, v in g.items()},
           "round_trip": copy.deepcopy(interop.gat_params_to_numpy(model))}
    with torch.no_grad(), use_mesh(mesh):
        out["logits"] = gnn.gat_forward(model, cfg, g, graph_axes=axes).numpy()
    out.update(_rg_step(mesh, model, lambda p, b: gnn.gat_loss(p, cfg, b, graph_axes=axes),
                        train.make_gat_train_step(cfg, hp, graph_axes=axes), g,
                        interop.gat_params_to_numpy))
    return out


def _rg_lookup(mesh, table, ids) -> dict:
    """``layers.lookup`` on the rank's rows of ``table`` (split over
    ``model``) and ``take`` on the whole table, with the gradient of a sum
    of the lookups into the rank's rows."""
    import torch

    from repro_torch.distributed.sharding import block_of
    from repro_torch.models.layers import lookup, take

    block = torch.nn.Parameter(torch.from_numpy(np.array(block_of(table, ("model", None),
                                                                   mesh))))
    block.spec, block.mesh = ("model", None), mesh
    got = lookup(block, torch.from_numpy(ids))
    (g,) = torch.autograd.grad(got.sum(), block)
    return {"got": got.detach().numpy(), "want": take(torch.from_numpy(table),
                                                      torch.from_numpy(ids)).numpy(),
            "grad": g.numpy()}


def _rg_retrieval(mesh, cfg, tree, query, candidates) -> dict:
    """The two-tower's ``retrieval_cand`` cell: tables over ``model``, this
    rank's block of the candidates over ``data`` (``sharded_retrieval``)."""
    import torch

    from repro_torch import interop
    from repro_torch.configs import two_tower_retrieval as tt_config
    from repro_torch.configs.recsys_common import sharded_retrieval
    from repro_torch.distributed import use_mesh

    model = interop.recsys_params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    with torch.no_grad(), use_mesh(mesh):
        m = sharded_retrieval(tt_config._retrieve, cfg, model, query,
                              torch.as_tensor(_rows(candidates, mesh, ("data",))))
    return {"values": m.values.numpy(), "indices": m.indices.numpy(),
            "counts": m.counts.numpy()}


def _rg_loop(mesh, arch, run_dir) -> dict:
    """``train_loop(mesh=)``: 4 steps straight, and 2 then a resume to 4;
    both final checkpoints' leaves."""
    import os

    from repro_torch import checkpoint as ck
    from repro_torch.launch import train

    kw = dict(arch=arch, mesh=mesh, device="cpu", ckpt_every=2, log_every=100)
    straight, resumed = (os.path.join(run_dir, name) for name in ("straight", "resumed"))
    first = train.train_loop(steps=4, ckpt_dir=straight, **kw)
    train.train_loop(steps=2, ckpt_dir=resumed, total_steps=4, **kw)
    again = train.train_loop(steps=4, ckpt_dir=resumed, **kw)

    def leaves(d):
        return {k: np.asarray(v) for k, v in ck.load_checkpoint(d, 4).items()}
    return {"straight": first, "resumed": again, "straight_ck": leaves(straight),
            "resumed_ck": leaves(resumed)}
