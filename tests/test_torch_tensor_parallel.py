"""The LM families laid out by the reference's ``param_specs`` on a mesh:
tensor parallel over ``model`` and FSDP over the data axes
(``models.transformer.Transformer(cfg, device, mesh)``), against the
reference on the CPU.

One spawn of 4 gloo ranks (``tests/_torch_dist.tp_ranks``) runs every port
case on a ``data=2 × model=2`` and a ``model=4`` mesh in the same ranks,
each rank holding its blocks of one numpy tree per family (``interop`` with
``mesh=``), at the smoke configs in f32 (the MoE ones at capacity factor 16,
so that routing each data shard's tokens drops nothing, as the reference's
whole batch does not):

- shapes: every parameter is ``local_shape`` of the reference's spec, but
  for the listed replications (``layout_replications``: at ``model=4``
  qwen3-1.7b's and arctic-480b's ``wk``/``wv``, of which each rank holds
  the one kv head its q heads read, shared with one other rank);
- prefill logits of the rank's rows and ``transformer_loss`` (its CE and
  aux loss, over the data ranks) against the reference's ``prefill`` and
  loss on the same weights, within 1e-5 relative;
- 4 decode steps into a cache with the sequence over ``model`` (and the
  batch over ``data``) against the reference's ``decode_step``: top-1
  equal, logits within 1e-5 of their largest;
- an ``fsdp=True`` train step of qwen3-1.7b and of deepseek-moe-16b (aux
  loss weight 0) against the reference's ``make_lm_train_step`` on the
  whole batch: loss and ``grad_norm`` within 1e-5 relative, the gathered
  AdamW moments within 1e-5 of each leaf's largest, and the parameters
  too, plus the first step's slope in the gradient times the gradients'
  1e-5 (a gradient near AdamW's ``eps`` moves its parameter by up to
  ``lr``: one element of deepseek's does so in the port's own single-process
  step); every moment is the rank's block;
- ``train_loop(mesh=)`` with FSDP resumes bit for bit, and its checkpoint
  (whole tensors) restores onto the mesh and into one process alike;
- ``LMServer(mesh=)`` inside the ranks streams one process's tokens;
- heads that ``model`` does not divide (:data:`PADDED`), on ``model=4``
  and on a ``model=3`` mesh of ranks 0-2 inside the same spawn (the
  card's geometry): each rank's heads and blocks by the padded layout
  (``sharding.HeadLayout``), its padding zero, and prefill, loss and
  decode against the reference as above; 2 FSDP train steps of a padded
  GQA config on ``data=2 × model=2`` against the reference's, after which
  every padded weight and AdamW moment entry is exactly 0; the interop
  tree and a checkpoint of the blocks carry the reference's unpadded
  shapes, and the checkpoint restores onto the mesh bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_dist import JOIN_TIMEOUT_S, PADDED_MESHES, PG_TIMEOUT_S, TP_MESHES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import checkpoint as ck  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import LMDataPipeline  # noqa: E402
from repro_torch.distributed.sharding import local_shape  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ("qwen3-1.7b", "minicpm3-4b", "deepseek-moe-16b", "arctic-480b")
REL = 1e-5
STEPS, MAX_LEN = 4, 8
HP = train.TrainHyperparams(warmup_steps=2, total_steps=10)
TRAINS = {"qwen3-1.7b": {}, "deepseek-moe-16b": {"aux_loss_weight": 0.0}}
LOOP = dict(arch="qwen3-1.7b", overrides={"fsdp": True})
SERVER = dict(arch="arctic-480b", prompts=[[5, 9, 2, 7], [11, 3, 3, 8]], gen=6)
# Heads that model does not divide, by mesh: key → (arch, overrides, padded
# q heads, padded kv heads (MLA: its q heads), ranks sharing a kv head).
PADDED = {
    "model4": {"qwen3-1.7b:6/2": ("qwen3-1.7b", {"n_heads": 6, "n_kv_heads": 2}, 8, 2, 2),
               "minicpm3-4b:6": ("minicpm3-4b", {"n_heads": 6, "n_kv_heads": 6}, 8, 8, 1)},
    "model3": {"qwen3-1.7b": ("qwen3-1.7b", {}, 6, 3, 1),
               "minicpm3-4b": ("minicpm3-4b", {}, 6, 6, 1),
               "qwen3-1.7b:6/2": ("qwen3-1.7b", {"n_heads": 6, "n_kv_heads": 2}, 9, 3, 1)},
}
PADDED_PAIRS = [(m, key) for m in PADDED for key in PADDED[m]]
PADDED_LEN = {"model4": 8, "model3": 9}  # the cache's length splits over the ranks
PADDED_TRAIN = dict(arch="qwen3-1.7b", overrides={"n_heads": 3, "n_kv_heads": 1}, steps=2)


def _configs(arch, **overrides):
    jcfg, cfg = jget_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()
    if cfg.moe:
        overrides = {"capacity_factor": 16.0, **overrides}
    return (dataclasses.replace(jcfg, dtype=jnp.float32, **overrides),
            dataclasses.replace(cfg, dtype=torch.float32, **overrides))


def _tree(jcfg, seed=0):
    """A reference parameter tree filled from numpy: matrices normal × 0.1,
    vectors 1 + 0.1 × normal."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jt.init_transformer(k, jcfg), jax.random.key(0))

    def fill(s):
        a = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return a + 1 if len(s.shape) == 1 else a

    return jax.tree.map(fill, shapes)


def _tokens(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)


def _batch(cfg):
    return LMDataPipeline(cfg.vocab_size, 4, 64, seed=1).get_batch(0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    models = {}
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        models[arch] = dict(cfg=cfg, tree=_tree(jcfg), tokens=_tokens(cfg), steps=STEPS,
                            max_len=MAX_LEN)
    trains = {}
    for arch, overrides in TRAINS.items():
        jcfg, cfg = _configs(arch, fsdp=True, **overrides)
        trains[arch] = dict(cfg=cfg, tree=_tree(jcfg), batch=_batch(cfg), hp=HP)
    jcfg, cfg = _configs(SERVER["arch"])
    padded = {}
    for mesh_name, cases in PADDED.items():
        padded[mesh_name] = {}
        for key, (arch, overrides, *_) in cases.items():
            jcfg_p, cfg_p = _configs(arch, **overrides)
            padded[mesh_name][key] = dict(cfg=cfg_p, tree=_tree(jcfg_p), tokens=_tokens(cfg_p),
                                          steps=STEPS, max_len=PADDED_LEN[mesh_name])
    t = PADDED_TRAIN
    jcfg_t, cfg_t = _configs(t["arch"], fsdp=True, **t["overrides"])
    spec = {"models": models, "train": trains,
            "loop": dict(LOOP, run_dir=str(tmp_path_factory.mktemp("loop"))),
            "server": dict(cfg=cfg, tree=_tree(jcfg), prompts=SERVER["prompts"],
                           gen=SERVER["gen"]),
            "padded": padded, "run_dir": str(tmp_path_factory.mktemp("round_trip")),
            "padded_train": dict(cfg=cfg_t, tree=_tree(jcfg_t), batch=_batch(cfg_t), hp=HP,
                                 steps=t["steps"])}
    return spawn("_torch_dist:tp_ranks", 4, spec, device="cpu", threads=1,
                 run_dir=str(tmp_path_factory.mktemp("ranks")), pg_timeout=PG_TIMEOUT_S,
                 join_timeout=JOIN_TIMEOUT_S)


_REF: dict = {}


def _reference(arch, **overrides) -> dict:
    """The reference's prefill, loss (the whole batch, and each half's aux
    loss) and decode on the family's tree, once per test process."""
    key = (arch, tuple(sorted(overrides.items())))
    if key in _REF:
        return _REF[key]
    jcfg, _ = _configs(arch, **overrides)
    params = jax.tree.map(jnp.asarray, _tree(jcfg))
    tokens = jnp.asarray(_tokens(jcfg))
    loss = jax.jit(lambda p, t: jt.transformer_loss(p, jcfg, {"tokens": t}))
    _, whole = loss(params, tokens)
    halves = [loss(params, tokens[i:i + 2])[1]["aux_loss"] for i in (0, 2)]
    dec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    cache = jt.make_cache(jcfg, tokens.shape[0], MAX_LEN)
    steps = []
    for i in range(STEPS):
        logits, cache = dec(params, cache, tokens[:, i])
        steps.append(np.asarray(logits))
    _REF[key] = {
        "prefill": np.asarray(jax.jit(lambda p, t: jt.prefill(p, jcfg, t))(params, tokens)),
        "ce": float(whole["ce_loss"]), "aux": float(whole["aux_loss"]),
        "aux_halves": float(np.mean([float(a) for a in halves])),
        "decode": np.stack(steps),
    }
    return _REF[key]


def _row_block(mesh_name, coord):
    """The rows of the 4-row batch a rank of ``mesh_name`` holds."""
    if mesh_name == "data2_model2":
        return slice(2 * coord[0], 2 * coord[0] + 2)
    return slice(0, 4)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def _sizes(mesh_name) -> dict:
    shape, names = TP_MESHES[mesh_name]
    return dict(zip(names, shape))


@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_holds_its_blocks(ranks, arch, mesh_name):
    _, cfg = _configs(arch)
    sizes = _sizes(mesh_name)
    specs, layout = tt.param_specs(cfg), tt.layout_specs(cfg, sizes)
    replicated = tt.layout_replications(cfg, sizes)
    want_rep = {"qwen3-1.7b", "arctic-480b"} if mesh_name == "model4" else set()
    assert ({n.rsplit(".", 2)[-2] for n in replicated} == {"wk", "wv"}) == (arch in want_rep)
    full = dict(tt.Transformer(cfg, "meta").named_parameters())
    for r in ranks:
        shapes = r[mesh_name]["models"][arch]["shapes"]
        assert sorted(shapes) == sorted(full)
        for name, shape in shapes.items():
            whole = tuple(full[name].shape)
            spec = layout[name] if name in replicated else specs[name]
            assert shape == local_shape(whole, spec, sizes), name
            if any(part == "model" for part in specs[name]):
                assert shape != whole, name
            if name in replicated:
                # the one kv head the rank's q heads read, shared with one
                # other rank: not the whole weight, twice GSPMD's even block
                assert shape == (cfg.head_dim, whole[1]), name
                assert shape[0] == 2 * local_shape(whole, specs[name], sizes)[0], name


@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_loss_match_the_reference(ranks, arch, mesh_name):
    ref = _reference(arch)
    ce, total = [], []
    for r in ranks:
        got = r[mesh_name]["models"][arch]
        _close(got["prefill"], ref["prefill"][_row_block(mesh_name, r[mesh_name]["coord"])])
        ce.append(got["loss"]["ce_loss"])
        total.append(got["loss"]["total"])
        aux = ref["aux_halves"] if mesh_name == "data2_model2" else ref["aux"]
        assert got["loss"]["aux_loss"] == pytest.approx(aux, rel=REL, abs=1e-7)
    # each rank's CE is its share of the global CE times the data ranks
    assert np.mean(ce) == pytest.approx(ref["ce"], rel=REL)
    _, cfg = _configs(arch)
    assert np.mean(total) == pytest.approx(ref["ce"] + cfg.aux_loss_weight * aux, rel=REL)


@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_sequence_sharded_cache_matches_the_reference(ranks, arch, mesh_name):
    ref = _reference(arch)["decode"]
    for r in ranks:
        got = r[mesh_name]["models"][arch]["decode"]
        want = ref[:, _row_block(mesh_name, r[mesh_name]["coord"])]
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        _close(got, want)


def _first_step_slack(m, lr, b1=0.9, eps=1e-8):
    """How far a first AdamW step moves a parameter when its gradient ``g``
    moves by ``δ = REL · max|g|``: the step is ``lr · g / (|g| + eps)``,
    whose slope ``lr · eps / (|g| + eps)²`` is ``lr / eps`` near ``g = 0``.
    ``g`` is the reference's clipped gradient, ``m / (1 − b1)``."""
    g = np.abs(np.asarray(m, np.float64)) / (1 - b1)
    return lr * eps * REL * g.max() / (g + eps) ** 2


def _jax_step(arch):
    from repro.launch.train import TrainHyperparams, make_lm_train_step

    jcfg, _ = _configs(arch, fsdp=True, **TRAINS[arch])
    params = jax.tree.map(jnp.asarray, _tree(jcfg))
    step = make_lm_train_step(jcfg, TrainHyperparams(**dataclasses.asdict(HP)))
    from repro import optim as jopt

    batch = jax.tree.map(jnp.asarray, _batch(jcfg))
    new_p, state, metrics = jax.jit(step)(params, jopt.adamw_init(params), batch)
    return new_p, state, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("arch", list(TRAINS))
def test_fsdp_train_step_matches_the_reference(ranks, arch):
    new_p, state, metrics = _jax_step(arch)
    _, cfg = _configs(arch, fsdp=True, **TRAINS[arch])
    sizes = _sizes("data2_model2")
    layout = tt.layout_specs(cfg, sizes)
    full = dict(tt.Transformer(cfg, "meta").named_parameters())
    names = {k: interop.transformer_params_from_numpy(
        jax.tree.map(np.asarray, getattr(state, k)), cfg, "cpu") for k in ("m", "v")}
    for r in ranks:
        got = r["data2_model2"]["train"][arch]
        for key in ("loss", "ce_loss", "grad_norm"):
            assert got["metrics"][key] == pytest.approx(metrics[key], rel=REL), key
        for a, b, m in zip(got["params"], jax.tree.leaves(new_p), jax.tree.leaves(state.m),
                           strict=True):
            b = np.asarray(b, np.float64)
            err = np.abs(a - b)
            assert (err <= REL * np.abs(b).max() + _first_step_slack(m, metrics["lr"])).all()
        for k in ("m", "v"):
            for name, want in names[k].named_parameters():
                _close(got["moments"][k][name], want.detach().numpy())
        for name, shape in got["moment_shapes"].items():
            assert shape == local_shape(tuple(full[name].shape), layout[name], sizes), name
        # FSDP splits every matrix's d_model dimension over data: no moment is whole
        assert all(shape != tuple(full[name].shape)
                   for name, shape in got["moment_shapes"].items() if full[name].dim() > 1)


def test_lm_server_inside_the_ranks_streams_one_process_tokens(ranks):
    """``LMServer(mesh=)`` on ``model=4`` (arctic-480b's smoke config: its 2
    kv heads replicate, its experts split) gives the tokens one process's
    server gives, on every rank."""
    from repro_torch.launch.serve import LMServer

    jcfg, cfg = _configs(SERVER["arch"])
    srv = LMServer(cfg, max_batch=len(SERVER["prompts"]), max_len=32, device="cpu",
                   params=interop.transformer_params_from_numpy(_tree(jcfg), cfg, "cpu"))
    want = [srv.generate(srv.add_request(p), SERVER["gen"]) for p in SERVER["prompts"]]
    for r in ranks:
        assert r["model4"]["server"] == want


def test_train_loop_on_the_mesh_resumes_bit_for_bit(ranks, tmp_path):
    loops = [r["data2_model2"]["loop"] for r in ranks]
    for lp in loops:
        assert lp["resumed"] == lp["straight"] == loops[0]["straight"]
        assert lp["steps"] == [2, 4]
        assert sorted(lp["straight_ck"]) == sorted(lp["resumed_ck"])
        for key, value in lp["straight_ck"].items():
            np.testing.assert_array_equal(lp["resumed_ck"][key], value, err_msg=key)
    # the checkpoint holds whole tensors: one process restores it as the mesh does
    cfg = dataclasses.replace(get_arch(LOOP["arch"]).make_smoke_config(), **LOOP["overrides"])
    run = train.setup("lm", cfg, train.TrainHyperparams(), "cpu")
    params = train.params_of(run.model)
    restored, at = ck.CheckpointManager(loops[0]["straight_dir"]).restore(
        like={"params": params, "opt": train.adamw_init(params)})
    assert at == 4
    train._restore_into(params, restored["params"])
    one = interop.transformer_params_to_numpy(run.model)
    for lp in loops:
        for a, b in zip(lp["restored"], jax.tree.leaves(one), strict=True):
            np.testing.assert_array_equal(a, b)
    single = train.train_loop(arch=LOOP["arch"], steps=4, device="cpu", log_every=100,
                              smoke_overrides=LOOP["overrides"])
    for key in ("loss", "ce_loss", "grad_norm"):
        assert loops[0]["straight"][key] == pytest.approx(single[key], rel=REL), key


# -- heads that model does not divide ----------------------------------------------------


def _padded_configs(mesh_name, key):
    arch, overrides, *_ = PADDED[mesh_name][key]
    return _configs(arch, **overrides)


def _padded_ranks(ranks, mesh_name):
    """The ranks of ``mesh_name``, in place order (model=3 holds 0-2)."""
    members = PADDED_MESHES[mesh_name][2]
    return [ranks[i] for i in (range(len(ranks)) if members is None else members)]


@pytest.mark.parametrize("mesh_name,key", PADDED_PAIRS)
def test_padded_heads_hold_the_padded_layout(ranks, mesh_name, key):
    """Each rank's heads and blocks are the padded layout's: its run of the
    padded q heads, the kv heads they read, blocks of ``layout_specs``'
    local shapes (attention's a whole number of heads), padding zero."""
    _, cfg = _padded_configs(mesh_name, key)
    *_, hq_pad, hkv_pad, sharers = PADDED[mesh_name][key]
    m = PADDED_MESHES[mesh_name][0][0]
    sizes = {"model": m}
    lay = tt._head_layout(cfg, m)
    assert (lay.hkv_pad * lay.g_pad, lay.hkv_pad, len(lay.sharers(0))) == \
        (hq_pad, hkv_pad, sharers)
    layout = tt.layout_specs(cfg, sizes)
    full = dict(tt.Transformer(cfg, "meta").named_parameters())
    zeros = 0
    for place, r in enumerate(_padded_ranks(ranks, mesh_name)):
        got = r[mesh_name]["padded"][key]
        heads = got["heads"]
        assert (heads.q, heads.kv, heads.q0) == (lay.q_heads(place), lay.kv_heads(place),
                                                 place * hq_pad // m)
        assert heads.shared == (lay.sharers(place) if sharers > 1 else ())
        for name, shape in got["shapes"].items():
            assert shape == local_shape(tuple(full[name].shape), layout[name], sizes), name
        for name, leaf in (("wq", "wq"), ("wq_b", "wq_b"), ("wk", "wk"), ("wo", "wo")):
            pname = f"layers.0.attn.{leaf}.weight"
            if pname in got["shapes"]:
                dim = 1 if leaf == "wo" else 0
                n = heads.hkv if leaf == "wk" else heads.hq
                assert got["shapes"][pname][dim] == n * tt._head_width(cfg, leaf), pname
        for name, (entries, largest) in got["padded"].items():
            assert entries > 0 and largest == 0.0, name
            zeros += entries
    # every zero head of every attention weight, over the ranks
    per_layer = sum((hq_pad - cfg.n_heads) * tt._head_width(cfg, leaf) * full[
        f"layers.0.attn.{leaf}.weight"].shape[1 if leaf != "wo" else 0]
        for leaf in ("wq", "wo", "wq_b", "wkv_b") if f"layers.0.attn.{leaf}.weight" in full)
    if cfg.attention == "gqa":
        per_layer += 2 * (hkv_pad - cfg.n_kv_heads) * cfg.head_dim * cfg.d_model
    assert zeros == cfg.n_layers * per_layer


@pytest.mark.parametrize("mesh_name,key", PADDED_PAIRS)
def test_padded_prefill_loss_and_decode_match_the_reference(ranks, mesh_name, key):
    arch, overrides, *_ = PADDED[mesh_name][key]
    ref = _reference(arch, **overrides)
    for r in _padded_ranks(ranks, mesh_name):
        got = r[mesh_name]["padded"][key]
        _close(got["prefill"], ref["prefill"])
        assert got["loss"]["ce_loss"] == pytest.approx(ref["ce"], rel=REL)
        np.testing.assert_array_equal(got["decode"].argmax(-1), ref["decode"].argmax(-1))
        _close(got["decode"], ref["decode"])


def _jax_steps(arch, overrides, n):
    """The reference's ``n`` FSDP train steps: each step's metrics, and the
    parameters and AdamW state after the first."""
    from repro import optim as jopt
    from repro.launch.train import TrainHyperparams, make_lm_train_step

    jcfg, _ = _configs(arch, fsdp=True, **overrides)
    params = jax.tree.map(jnp.asarray, _tree(jcfg))
    step = jax.jit(make_lm_train_step(jcfg, TrainHyperparams(**dataclasses.asdict(HP))))
    batch = jax.tree.map(jnp.asarray, _batch(jcfg))
    state, metrics, first = jopt.adamw_init(params), [], None
    for i in range(n):
        params, state, met = step(params, state, batch)
        metrics.append({k: float(v) for k, v in met.items()})
        if i == 0:
            first = (params, state)
    return metrics, first


def test_padded_train_steps_match_the_reference_and_keep_the_padding_zero(ranks):
    """``PADDED_TRAIN`` (3 q heads on 1 kv head, padded to 4 on
    ``data=2 × model=2``: one padded head, the kv head shared by both model
    ranks): both steps' loss and grad norm, and the parameters and moments
    after the first, match the reference's; after the second, every padded
    entry of the weights and both moments is exactly 0."""
    t = PADDED_TRAIN
    metrics, (new_p, state) = _jax_steps(t["arch"], t["overrides"], t["steps"])
    _, cfg = _configs(t["arch"], fsdp=True, **t["overrides"])
    names = {k: interop.transformer_params_from_numpy(
        jax.tree.map(np.asarray, getattr(state, k)), cfg, "cpu") for k in ("m", "v")}
    padded = 0
    for r in ranks:
        got = r["data2_model2"]["padded_train"]
        assert got["heads"].shared == (0, 1)
        for i in range(t["steps"]):
            for key in ("loss", "ce_loss", "grad_norm"):
                assert got["metrics"][i][key] == pytest.approx(metrics[i][key], rel=REL), key
        for a, b, m in zip(got["first"]["params"], jax.tree.leaves(new_p),
                           jax.tree.leaves(state.m), strict=True):
            b = np.asarray(b, np.float64)
            assert a.shape == b.shape
            err = np.abs(a - b)
            assert (err <= REL * np.abs(b).max() + _first_step_slack(m, metrics[0]["lr"])).all()
        for k in ("m", "v"):
            for name, want in names[k].named_parameters():
                _close(got["first"]["moments"][k][name], want.detach().numpy())
        for name, (entries, *largest) in got["padded"].items():
            assert largest == [0.0, 0.0, 0.0], name
            padded += entries
    # one padded q head of 4: its wq rows and wo columns, on each data rank
    assert padded == 2 * cfg.n_layers * 2 * cfg.head_dim * cfg.d_model // 2


@pytest.mark.parametrize("key", list(PADDED["model4"]))
def test_padded_interop_and_checkpoint_round_trips(ranks, key):
    """The rank's padded blocks go back to the reference's unpadded tree bit
    for bit (``interop``), a checkpoint of them holds whole tensors of the
    reference's shapes, and restoring it onto the mesh gives each rank its
    blocks bit for bit."""
    jcfg, cfg = _padded_configs("model4", key)
    want = jax.tree.leaves(_tree(jcfg))
    full = {f"params/{n}": tuple(p.shape)
            for n, p in tt.Transformer(cfg, "meta").named_parameters()}
    for r in ranks:
        got = r["model4"]["round_trip"][key]
        for a, b in zip(got["tree"], want, strict=True):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert got["ckpt_shapes"] == full
        assert got["restored_equal"]
