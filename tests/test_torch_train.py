"""The port's LM training (``transformer_loss``, ``launch/train.py``) against
the reference's on the CPU, and the trainer's driver.

One parameter tree of the reference's structure (``eval_shape`` of its init,
filled from numpy) runs in both packages, carried across by ``interop``.
For each of the five LM smoke configs (float32) one ``make_lm_train_step``
holds: the loss, CE and MoE aux loss within relative 1e-5, every gradient
leaf within 1e-5 × its largest |g|, ``grad_norm`` and ``lr``, and each
parameter leaf's change in the step within 1e-3 of its norm. Then ``grad_accum=2`` against 1 and
remat on against off (mirroring ``tests/test_perf_variants.py``), the
attention kernels' refusal of autograd, ``train_loop`` resumed bit for bit
(gat-cora, and qwen3-1.7b's smoke config in bf16 through the bf16
checkpoint), the CLI, and bf16 checkpoints across the two packages in both
directions.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import checkpoint as ck  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import LMDataPipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

LMS = ["qwen3-1.7b", "minicpm3-4b", "qwen3-8b", "arctic-480b", "deepseek-moe-16b"]
REL = 1e-5


def _tree(jcfg, seed=0):
    """A reference parameter tree filled from numpy: matrices normal × 0.1,
    vectors 1 + 0.1 × normal."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jt.init_transformer(k, jcfg), jax.random.key(0))

    def fill(s):
        a = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return a + 1 if len(s.shape) == 1 or (len(s.shape) == 2 and s.shape[0] == 1) else a

    return jax.tree.map(fill, shapes)


def _reference_step(loss_fn, hp):
    """The reference's ``make_train_step`` (accum 1) that also returns the
    gradients: value_and_grad, the cosine schedule, ``adamw_update``."""
    def step(p, o, b):
        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        lr = jopt.cosine_schedule(o.step, hp.lr, hp.warmup_steps, hp.total_steps)
        new_p, new_o, om = jopt.adamw_update(g, o, p, lr=lr, b1=hp.b1, b2=hp.b2,
                                             weight_decay=hp.weight_decay,
                                             clip_norm=hp.clip_norm)
        return g, new_p, {"loss": loss, **aux, **om}
    return jax.jit(step)


def assert_grads_close(got: dict, want: dict):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * max(float(np.abs(b).max()), 1e-30))


def assert_metrics_close(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=REL,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("name", LMS)
def test_lm_train_step_matches_the_reference(name):
    jcfg, cfg = jget_arch(name).make_smoke_config(), get_arch(name).make_smoke_config()
    hp = train.TrainHyperparams(warmup_steps=2, total_steps=10)
    tree = _tree(jcfg)
    batch = LMDataPipeline(cfg.vocab_size, 2, 64, seed=1).get_batch(0)
    params = jax.tree.map(jnp.asarray, tree)
    wg, wp, wm = _reference_step(lambda p, b: jt.transformer_loss(p, jcfg, b), hp)(
        params, jopt.adamw_init(params), jax.tree.map(jnp.asarray, batch))

    model = interop.transformer_params_from_numpy(tree, cfg, "cpu")
    _, aux, grads = train.grads_of(lambda m, b: tt.transformer_loss(m, cfg, b), model, batch)
    if cfg.moe:
        assert float(aux["aux_loss"]) > 0
    else:
        assert float(aux["aux_loss"]) == 0
    assert_grads_close(interop.named_to_numpy(model, grads,
                                              interop.transformer_params_to_numpy), wg)

    opt = optim.adamw_init(train.params_of(model))
    _, new_opt, metrics = train.make_lm_train_step(cfg, hp)(model, opt, batch)
    assert int(new_opt.step) == 1
    assert_metrics_close(metrics, wm)
    for a, b, old in zip(jax.tree.leaves(interop.transformer_params_to_numpy(model)),
                         jax.tree.leaves(wp), jax.tree.leaves(tree)):
        # the step's change: lr · (g / (|g| + eps) + wd · p) with lr = 1.5e-4,
        # where the weight decay alone is about 1e-2 of its norm
        got, want = a.astype(np.float64) - old, np.asarray(b, np.float64) - old
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


def _qwen(**overrides):
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").make_smoke_config(), **overrides)
    return cfg, tt.init_transformer(cfg, device="cpu")


def test_grad_accum_matches_single_step():
    cfg1, model1 = _qwen()
    cfg2, model2 = _qwen(grad_accum=2)
    batch = LMDataPipeline(cfg1.vocab_size, 8, 64, seed=2).get_batch(0)
    before = [p.detach().clone() for p in model1.parameters()]
    _, _, m1 = train.make_lm_train_step(cfg1)(model1, optim.adamw_init(
        train.params_of(model1)), batch)
    _, _, m2 = train.make_lm_train_step(cfg2)(model2, optim.adamw_init(
        train.params_of(model2)), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b, old in zip(model1.parameters(), model2.parameters(), before):
        da, db = (x.detach().double() - old.double() for x in (a, b))
        assert float((da - db).norm()) <= 1e-3 * float(da.norm()), "the step's change"


@pytest.mark.parametrize("name", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_remat_matches_no_remat(name):
    cfg = get_arch(name).make_smoke_config()
    model = tt.init_transformer(cfg, device="cpu")
    batch = LMDataPipeline(cfg.vocab_size, 2, 64, seed=3).get_batch(0)
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out.append(train.grads_of(lambda m, b: tt.transformer_loss(m, c, b), model, batch))
    (l1, a1, g1), (l2, a2, g2) = out
    assert float(l1) == float(l2) and float(a1["aux_loss"]) == float(a2["aux_loss"])
    for key in g1:
        assert torch.equal(g1[key], g2[key]), key


def test_loss_labels_and_mask_defaults():
    cfg, model = _qwen()
    tokens = LMDataPipeline(cfg.vocab_size, 2, 64, seed=4).get_batch(0)["tokens"]
    with torch.no_grad():
        default, aux = tt.transformer_loss(model, cfg, {"tokens": tokens})
        labels = np.concatenate([tokens[:, 1:], np.zeros((2, 1), np.int32)], axis=1)
        mask = np.ones((2, 64), np.float32)
        mask[:, -1] = 0
        explicit, _ = tt.transformer_loss(model, cfg, {"tokens": tokens, "labels": labels,
                                                        "loss_mask": mask})
    assert float(default) == float(explicit) and float(aux["tokens"]) == 2 * 63
    with pytest.raises(ValueError, match="loss_chunk"):
        tt.transformer_loss(model, cfg, {"tokens": tokens[:, :40]})


def test_attention_wrappers_refuse_autograd():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn((1, 2, 16, 16), requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q, q, q)
    k = torch.randn((1, 2, 32, 16))
    with pytest.raises(ValueError, match="no backward"):
        decode_attention(q[:, :, 0], k, k, torch.tensor([20]))
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape


# -- the driver ----------------------------------------------------------------------


def _checkpoint_leaves(directory, step) -> dict:
    return {k: (v.view(torch.int16).numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in ck.load_checkpoint(directory, step).items()}


@pytest.mark.parametrize("arch,overrides", [("gat-cora", None),
                                            ("qwen3-1.7b", {"dtype": torch.bfloat16})])
def test_train_loop_resume_is_bit_for_bit(tmp_path, arch, overrides):
    """4 steps of a 6-step run, a second call to 6, equal an uninterrupted
    6-step run in every parameter and moment, bit for bit."""
    kw = dict(arch=arch, ckpt_every=2, log_every=100, device="cpu", smoke_overrides=overrides)
    a, b = str(tmp_path / "resumed"), str(tmp_path / "straight")
    train.train_loop(steps=4, ckpt_dir=a, total_steps=6, **kw)
    assert ck.CheckpointManager(a).latest_step() == 4
    resumed = train.train_loop(steps=6, ckpt_dir=a, **kw)
    straight = train.train_loop(steps=6, ckpt_dir=b, **kw)
    assert resumed == straight and np.isfinite(resumed["loss"])
    assert ck.CheckpointManager(a).all_steps() == [2, 4, 6]
    got, want = _checkpoint_leaves(a, 6), _checkpoint_leaves(b, 6)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if overrides:
        leaves = ck.load_checkpoint(a, 6)
        assert leaves["params/embed"].dtype == torch.bfloat16
        assert leaves["opt/m/embed"].dtype == np.float32


def test_train_cli_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    train.main(["--arch", "gat-cora", "--steps", "4", "--ckpt-dir", d, "--device", "cpu"])
    train.main(["--arch", "gat-cora", "--steps", "6", "--ckpt-dir", d, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out and "[train] final:" in out
    assert ck.CheckpointManager(d).latest_step() == 6


def test_train_loop_on_a_mesh_raises():
    """A mesh that is only a ``{axis: size}`` description (cells are built
    on one) has no ranks to train on: ``train_loop`` takes a
    ``DeviceMesh`` (the mesh runs themselves: ``tests/test_torch_mesh.py``)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        train.train_loop(arch="gat-cora", steps=1, mesh={"data": 2, "model": 2},
                         device="cpu")


# -- bf16 checkpoints across the packages -------------------------------------------


def _bf16_tree(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float32)
    return a, b


def test_bf16_checkpoint_from_the_reference_loads_bit_for_bit(tmp_path):
    a, b = _bf16_tree()
    state = {"w": jnp.asarray(a).astype(jnp.bfloat16), "b": [jnp.asarray(b)],
             "s": jnp.int32(3)}
    jck.save_checkpoint(state, str(tmp_path), 1)
    like = {"w": torch.zeros(5, 7, dtype=torch.bfloat16), "b": [torch.zeros(3)],
            "s": torch.zeros((), dtype=torch.int32)}
    got = ck.load_checkpoint(str(tmp_path), 1, like=like)
    assert got["w"].dtype == torch.bfloat16
    want = np.asarray(state["w"]).view(np.int16)
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(got["b"][0], b)
    assert int(got["s"]) == 3


def test_bf16_checkpoint_from_the_port_loads_bit_for_bit_in_the_reference(tmp_path):
    a, b = _bf16_tree(1)
    w = torch.from_numpy(a).to(torch.bfloat16)
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save({"w": w, "b": [torch.from_numpy(b)]}, 2, blocking=False)
    mgr.wait()
    got = jck.load_checkpoint(str(tmp_path), 2)
    assert str(got["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["w"]).view(np.int16),
                                  w.view(torch.int16).numpy())
    np.testing.assert_array_equal(got["b/0"], b)
