"""The port's mesh paths against the reference's on the CPU: the
sequence-sharded decode on K9's partials, ``moe_ffn_ep`` and training on a
mesh (``launch/train.py``).

One spawn of 4 gloo ranks (``tests/_torch_dist.mesh_ranks``) on a ``(2,
2)`` ``("data", "model")`` mesh runs every port case; the reference runs
on ``jax_mesh((2, 2))`` of the session's virtual CPU devices.

- Decode: 16 tokens into a cache of 32 positions with the sequence over
  ``("data", "model")`` (``long_500k``'s layout: ranks 2 and 3 hold no
  position), for GQA (the reference test's ``COMMON`` config) and MLA
  (minicpm3-4b's smoke config), and 20 tokens with the batch over ``data``
  and the sequence over ``model`` (``decode_32k``'s). Logits equal the
  reference's GSPMD decode within its own ``atol=5e-4, rtol=5e-3`` and the
  port's single-process decode within 1e-5.
- EP: at capacity factor 16 nothing drops and ``y`` equals the
  reference's ``moe_ffn_ep`` and ``moe_ffn`` within 1e-5; at 1.25 drops
  and aux equal the reference's to 1e-6; every gradient leaf is nonzero
  and within 1e-5 × max|g| of the reference's ``jax.grad``.
- Training: one step of qwen3-1.7b's smoke config equals the
  single-process step (loss and ``grad_norm`` within 1e-5 relative, the
  parameter change within 1e-3 of its norm), deepseek-moe-16b's with
  ``moe_impl="ep"`` equals the reference's step under ``use_mesh`` and,
  at capacity factor 16, the port's single-process step; ``train_loop
  (mesh=)`` stopped at step 2 of 4 and resumed equals the straight run
  bit for bit, and with nothing dropped and the aux loss weighted 0 its
  4 steps equal the single-process run's (EP's aux loss is the mean of
  each data shard's, by design: the reference's ``pmean``).
- Dry run: the census FLOPs of ``train_4k``'s builder at 4 × 64 tokens
  (qwen3-1.7b's smoke config) played as rank 0 of a ``fake`` group by
  ``launch.dryrun`` on meta tensors equal those of the same step run on
  the real CPU ranks within 1 %.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_dist import JOIN_TIMEOUT_S, PG_TIMEOUT_S, jax_mesh  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import shardings_for  # noqa: E402
from repro.distributed.sharding import use_mesh as juse_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import LMDataPipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim.optimizer import tree_leaves  # noqa: E402

COMMON = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=256, q_chunk=16, kv_chunk=16, loss_chunk=16)
LONG = (("data", "model"), ())                 # long_500k: (seq_axes, batch_axes)
DECODE_32K = (("model",), ("pod", "data"))
EP = dict(d=32, f=16, E=8, T=64, top_k=2, factors=(16.0, 1.25))
HP = train.TrainHyperparams(warmup_steps=2, total_steps=10)


def _tree(jcfg, seed=0):
    """A reference parameter tree filled from numpy: matrices normal × 0.1,
    vectors 1 + 0.1 × normal."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jt.init_transformer(k, jcfg), jax.random.key(0))

    def fill(s):
        a = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return a + 1 if len(s.shape) == 1 else a

    return jax.tree.map(fill, shapes)


def _configs(name):
    if name == "common":
        return (jt.TransformerConfig(name="t", dtype=jnp.float32, **COMMON),
                tt.TransformerConfig(name="t", dtype=torch.float32, **COMMON))
    return jget_arch(name).make_smoke_config(), get_arch(name).make_smoke_config()


DECODES = {
    "gqa_long": ("common", 16, LONG),
    "mla_long": ("minicpm3-4b", 16, LONG),
    "gqa_decode_32k": ("common", 20, DECODE_32K),
}
TRAINS = {"qwen3": ("qwen3-1.7b", {}), "deepseek_ep": ("deepseek-moe-16b", {"moe_impl": "ep"})}


def _decode_case(name):
    arch, steps, (seq_axes, batch_axes) = DECODES[name]
    jcfg, cfg = _configs(arch)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, steps)).astype(np.int32)
    return jcfg, dict(cfg=cfg, tree=_tree(jcfg), tokens=tokens, max_len=32,
                      seq_axes=seq_axes, batch_axes=batch_axes)


def _ep_tree():
    rng = np.random.default_rng(2)
    d, f, E = EP["d"], EP["f"], EP["E"]
    tree = {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.3,
            "w_gate": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2,
            "w_up": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2,
            "w_down": rng.standard_normal((E, f, d)).astype(np.float32) * 0.2}
    x = rng.standard_normal((EP["T"], d)).astype(np.float32)
    return tree, x


def _train_case(name):
    arch, overrides = TRAINS[name]
    jcfg, cfg = _configs(arch)
    jcfg, cfg = dataclasses.replace(jcfg, **overrides), dataclasses.replace(cfg, **overrides)
    batch = LMDataPipeline(cfg.vocab_size, 4, 64, seed=1).get_batch(0)
    return jcfg, dict(cfg=cfg, tree=_tree(jcfg), batch=batch, hp=HP)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    tree, x = _ep_tree()
    spec = {
        "decode": {name: _decode_case(name)[1] for name in DECODES},
        "ep": dict(tree=tree, x=x, top_k=EP["top_k"], factors=EP["factors"]),
        "train": {name: _train_case(name)[1] for name in TRAINS},
        "run_dir": str(tmp_path_factory.mktemp("loop")),
    }
    return spawn("_torch_dist:mesh_ranks", 4, spec, device="cpu", threads=1,
                 run_dir=str(tmp_path_factory.mktemp("ranks")), pg_timeout=PG_TIMEOUT_S,
                 join_timeout=JOIN_TIMEOUT_S)


# -- sequence-sharded decode ---------------------------------------------------------


def _jax_sharded_decode(jcfg, case):
    mesh = jax_mesh((2, 2), ("data", "model"))
    tokens = case["tokens"]
    specs = jt.cache_specs(jcfg, seq_axes=case["seq_axes"], batch_axes=case["batch_axes"])
    c_sh = shardings_for(mesh, specs)
    cache = jax.tree.map(jax.device_put, jt.make_cache(jcfg, tokens.shape[0], case["max_len"]),
                         c_sh)
    dec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t),
                  in_shardings=(None, c_sh, None), out_shardings=(None, c_sh))
    params = jax.tree.map(jnp.asarray, case["tree"])
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = dec(params, cache, jnp.asarray(tokens[:, i]))
    return np.asarray(logits)


def _port_decode(case):
    model = interop.transformer_params_from_numpy(case["tree"], case["cfg"], "cpu")
    cache = tt.make_cache(case["cfg"], case["tokens"].shape[0], case["max_len"], device="cpu")
    out = []
    for i in range(case["tokens"].shape[1]):
        logits, cache = tt.decode_step(model, case["cfg"], cache,
                                       torch.as_tensor(case["tokens"][:, i]))
        out.append(logits.numpy())
    return np.stack(out)


def _sharded_logits(ranks, name):
    """Every step's logits of all rows, from the ranks of model index 0 in
    data order; the model ranks of one data index agree bit for bit."""
    by_coord = {r["coord"]: r["decode"][name]["logits"] for r in ranks}
    for (d, m), logits in by_coord.items():
        np.testing.assert_array_equal(logits, by_coord[(d, 0)])
    if DECODES[name][2][1]:  # batch over data
        return np.concatenate([by_coord[(0, 0)], by_coord[(1, 0)]], axis=1)
    np.testing.assert_array_equal(by_coord[(0, 0)], by_coord[(1, 0)])
    return by_coord[(0, 0)]


@pytest.mark.parametrize("name", list(DECODES))
def test_sequence_sharded_decode_matches_the_reference(ranks, name):
    jcfg, case = _decode_case(name)
    got = _sharded_logits(ranks, name)
    np.testing.assert_allclose(got[-1], _jax_sharded_decode(jcfg, case), atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(got, _port_decode(case), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(DECODES))
def test_sequence_blocks_past_the_length_give_empty_partials(ranks, name):
    """A rank whose block lies past every row's length has ``l = 0`` and
    ``m = NEG_LARGE``; a rank with positions has ``l > 0``."""
    steps = DECODES[name][1]
    for r in ranks:
        dec = r["decode"][name]
        for i, l_max in enumerate(dec["l_max"]):
            if i + 1 > dec["offset"]:
                assert l_max > 0
            else:
                assert l_max == float(np.float32(tt.NEG_LARGE))
        assert len(dec["l_max"]) == steps
    assert {r["decode"][name]["offset"] for r in ranks} == (
        {0, 8, 16, 24} if DECODES[name][2] == LONG else {0, 16})


def test_sharded_cache_layout_and_write():
    """A rank's cache block and its in-place write: only the rank whose
    block holds the position writes it (mesh given as a stand-in with the
    ``DeviceMesh`` methods the layout reads)."""
    cfg = _configs("common")[1]

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 2)
        mesh = np.zeros(shape)

        def __init__(self, coord):
            self.coord = coord

        def get_local_rank(self, axis):
            return self.coord[self.mesh_dim_names.index(axis)]

    for coord, offset in (((0, 0), 0), ((0, 1), 8), ((1, 0), 16), ((1, 1), 24)):
        cache = tt.make_cache(cfg, 2, 32, device="cpu", mesh=Mesh(coord), seq_axes=LONG[0])
        assert cache["k"].shape == (3, 2, 2, 8, 16)
        assert cache["layout"].offset == offset and cache["layout"].max_len == 32
        row = torch.ones(2, 2, 16)
        tt._write_row(cache["k"][0], torch.tensor([9, 17]), row, cache["layout"])
        written = cache["k"][0].abs().sum(dim=(1, 3)).nonzero().tolist()
        assert written == [[b, p - offset] for b, p in ((0, 9), (1, 17))
                           if offset <= p < offset + 8]
    with pytest.raises(ValueError, match="does not split"):
        tt.make_cache(cfg, 2, 30, device="cpu", mesh=Mesh((0, 0)), seq_axes=LONG[0])
    with pytest.raises(ValueError, match="batch=3"):
        tt.make_cache(cfg, 3, 32, device="cpu", mesh=Mesh((0, 0)),
                      seq_axes=DECODE_32K[0], batch_axes=("data",))


def test_remat_recomputes_blocks_under_the_forward_mesh(monkeypatch):
    """A checkpointed block runs again in the backward pass, on a CUDA
    device in autograd's own thread: it must see the forward's mesh there
    too (else an EP layer recomputes with all experts)."""
    import threading

    from repro_torch.distributed import sharding

    cfg = _configs("common")[1]
    model = tt.init_transformer(cfg, device="cpu")
    params = [p.requires_grad_(True) for p in model.parameters()]
    seen, block = [], tt._block

    def spy(*args):
        seen.append(sharding.active_mesh())
        return block(*args)

    monkeypatch.setattr(tt, "_block", spy)
    mesh = {"model": 1}
    with sharding.use_mesh(mesh):
        x, _ = tt._backbone(model, cfg, torch.zeros((1, 8), dtype=torch.int32), False,
                            remat=True)
    loss = x.float().square().sum()
    worker = threading.Thread(target=lambda: torch.autograd.grad(loss, params,
                                                                 allow_unused=True))
    worker.start()
    worker.join()
    assert len(seen) == 2 * cfg.n_layers and all(m is mesh for m in seen)


# -- expert parallelism ------------------------------------------------------------


def _jax_ep(tree, x, cf):
    params = jmoe.MoEParams(**{k: jnp.asarray(v) for k, v in tree.items()})
    mesh = jax_mesh((2, 2), ("data", "model"))
    return jax.jit(lambda p, x: jmoe.moe_ffn_ep(
        p, x, top_k=EP["top_k"], capacity_factor=cf, mesh=mesh, data_axes=("data",)))(
        params, jnp.asarray(x))


def _ep_y(ranks, cf):
    by_coord = {r["coord"]: r["ep"][cf]["y"] for r in ranks}
    for (d, m), y in by_coord.items():
        np.testing.assert_array_equal(y, by_coord[(d, 0)])
    return np.concatenate([by_coord[(0, 0)], by_coord[(1, 0)]])


def test_moe_ffn_ep_drops_nothing_at_factor_16(ranks):
    tree, x = _ep_tree()
    got = _ep_y(ranks, 16.0)
    want = _jax_ep(tree, x, 16.0)
    np.testing.assert_allclose(got, np.asarray(want.y), atol=1e-5, rtol=0)
    base = tmoe.moe_ffn(_moe(tree), torch.as_tensor(x), top_k=EP["top_k"], capacity_factor=16.0)
    np.testing.assert_allclose(got, base.y.numpy(), atol=1e-5, rtol=0)
    for r in ranks:
        assert r["ep"][16.0]["dropped"] == 0.0
        # the rank's own experts (local_experts) give the same bits as the whole stacks
        np.testing.assert_array_equal(r["ep"]["local_y"], r["ep"][16.0]["y"])


def test_moe_ffn_ep_drops_and_aux_match_the_reference(ranks):
    tree, x = _ep_tree()
    want = _jax_ep(tree, x, 1.25)
    assert float(want.dropped_frac) > 0
    np.testing.assert_allclose(_ep_y(ranks, 1.25), np.asarray(want.y), atol=1e-5, rtol=0)
    for r in ranks:
        assert r["ep"][1.25]["dropped"] == pytest.approx(float(want.dropped_frac), abs=1e-6)
        assert r["ep"][1.25]["aux"] == pytest.approx(float(want.aux_loss), abs=1e-6)


def test_moe_ffn_ep_gradients_match_the_reference(ranks):
    tree, x = _ep_tree()
    params = jmoe.MoEParams(**{k: jnp.asarray(v) for k, v in tree.items()})
    mesh = jax_mesh((2, 2), ("data", "model"))

    def loss(p):
        out = jmoe.moe_ffn_ep(p, jnp.asarray(x), top_k=EP["top_k"], capacity_factor=16.0,
                              mesh=mesh, data_axes=("data",))
        return jnp.sum(out.y ** 2) + out.aux_loss

    want = jax.jit(jax.grad(loss))(params)._asdict()
    for r in ranks:
        for name, g in r["ep"]["grads"].items():
            w = np.asarray(want[name])
            assert np.abs(g).max() > 0, name
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


def _moe(tree):
    p = tmoe.MoEParams(EP["d"], EP["f"], EP["E"], torch.float32, "cpu")
    with torch.no_grad():
        for name, value in tree.items():
            getattr(p, name).copy_(torch.as_tensor(value))
    return p


# -- training on a mesh ------------------------------------------------------------


def _port_step(case):
    model = interop.transformer_params_from_numpy(case["tree"], case["cfg"], "cpu")
    opt = optim.adamw_init(train.params_of(model))
    _, _, metrics = train.make_lm_train_step(case["cfg"], HP)(model, opt, case["batch"])
    return ({k: float(v) for k, v in metrics.items()},
            tree_leaves(interop.transformer_params_to_numpy(model)))


def _jax_mesh_step(jcfg, case):
    """The reference's step, traced under ``use_mesh`` (its ``_ffn`` then
    calls ``moe_ffn_ep``)."""
    from repro.launch.train import TrainHyperparams, make_lm_train_step

    params = jax.tree.map(jnp.asarray, case["tree"])
    step = make_lm_train_step(jcfg, TrainHyperparams(**dataclasses.asdict(HP)))
    with juse_mesh(jax_mesh((2, 2), ("data", "model"))):
        new_p, _, metrics = jax.jit(step)(params, jopt.adamw_init(params),
                                          jax.tree.map(jnp.asarray, case["batch"]))
    return {k: float(v) for k, v in metrics.items()}, jax.tree.leaves(new_p)


def _assert_step_close(got, want, tree, keys=("loss", "grad_norm")):
    g_metrics, g_params = got
    w_metrics, w_params = want
    for key in keys:
        assert g_metrics[key] == pytest.approx(w_metrics[key], rel=1e-5), key
    for a, b, old in zip(g_params, w_params, jax.tree.leaves(tree), strict=True):
        da, db = a.astype(np.float64) - old, np.asarray(b, np.float64) - old
        assert np.linalg.norm(da - db) <= 1e-3 * np.linalg.norm(db)


def _mesh_step(ranks, name):
    results = [r["train"][name] for r in ranks]
    for r in results[1:]:
        assert r["metrics"] == results[0]["metrics"]
        for a, b in zip(r["params"], results[0]["params"]):
            np.testing.assert_array_equal(a, b)
    return results[0]["metrics"], results[0]["params"]


def test_mesh_train_step_equals_the_single_process_step(ranks):
    _, case = _train_case("qwen3")
    _assert_step_close(_mesh_step(ranks, "qwen3"), _port_step(case), case["tree"],
                       keys=("loss", "ce_loss", "grad_norm", "tokens"))


def test_mesh_ep_train_step_matches_the_reference(ranks):
    jcfg, case = _train_case("deepseek_ep")
    got = _mesh_step(ranks, "deepseek_ep")
    assert got[0]["aux_loss"] > 0
    _assert_step_close(got, _jax_mesh_step(jcfg, case), case["tree"],
                       keys=("loss", "ce_loss", "aux_loss", "grad_norm"))


def test_mesh_ep_loop_equals_single_process_and_resumes_bit_for_bit(ranks):
    loops = [r["loop"] for r in ranks]
    for lp in loops:
        assert lp["resumed"] == lp["straight"] == loops[0]["straight"]
        assert lp["steps"] == [2, 4]
        assert sorted(lp["straight_ck"]) == sorted(lp["resumed_ck"])
        for key, value in lp["straight_ck"].items():
            np.testing.assert_array_equal(lp["resumed_ck"][key], value, err_msg=key)
    single = train.train_loop(arch="deepseek-moe-16b", steps=4, device="cpu", log_every=100,
                              smoke_overrides={"capacity_factor": 16.0, "aux_loss_weight": 0.0})
    for key in ("loss", "ce_loss", "grad_norm"):
        assert loops[0]["straight"][key] == pytest.approx(single[key], rel=1e-5), key


# -- the dry run against real ranks ----------------------------------------------------


def test_dryrun_census_equals_real_ranks(ranks, tmp_path):
    from _torch_dist import CUT_TRAIN

    tests = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(tests), "src")
    script = ("import sys; import _torch_dist; _torch_dist.register_cut_train_cell(); "
              "from repro_torch.launch import dryrun; "
              f"sys.exit(dryrun.main(['--arch', {CUT_TRAIN['arch']!r}, "
              f"'--shape', {CUT_TRAIN['shape']!r}, '--mesh', 'data=2,model=2', '--smoke', "
              f"'--out', {str(tmp_path)!r}]))")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=f"{src}:{tests}"), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (name,) = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    with open(tmp_path / name) as f:
        dry = json.load(f)
    real = ranks[0]["census"]
    assert real["flops"] > 0
    assert dry["census"]["flops"] == pytest.approx(real["flops"], rel=1e-2)
    assert (dry["census"]["collectives"]["all-reduce"]["count"]
            == real["collectives"]["all-reduce"]["count"])
