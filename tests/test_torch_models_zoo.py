"""Parity of the port's MLA and MoE LM families with the JAX package on the
CPU: minicpm3-4b (MLA), deepseek-moe-16b (MoE, shared experts, a leading
dense layer), arctic-480b (MoE + a dense residual) and qwen3-8b (dense
GQA), each at its smoke config (float32).

One parameter tree of the reference's structure, filled from numpy, runs
in the reference and, carried across by ``interop``, in the port: ``transformer_logits``,
``prefill`` and 8 ``decode_step`` calls from an empty cache are held to the
reference within 2e-5; ``make_cache`` has the reference's keys, shapes and
dtypes; the parameter tree makes the round trip unchanged; the parameter
counts of all five full configs equal the reference's (``eval_shape`` there,
the meta device here); and ``LMServer`` emits the reference server's token
streams for one MLA and one MoE config. MLA's padded K8 call
(``_mla_flash``) is held to the plain attention through K8's plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.serve import LMServer as JaxLMServer  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ASSIGNED, get_arch  # noqa: E402
from repro_torch.launch.serve import LMServer  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ZOO = ["minicpm3-4b", "deepseek-moe-16b", "arctic-480b", "qwen3-8b"]
LMS = ["qwen3-1.7b", *ZOO]
STEPS = 8
TOL = dict(atol=2e-5, rtol=0)

_MODELS: dict = {}


def _tree(jcfg, seed=0):
    """A parameter tree of the reference's structure (``eval_shape`` of its
    init: no compile) filled from numpy: matrices normal × 0.1, vectors (the
    norms) 1 + 0.1 × normal, so every parameter is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jt.init_transformer(k, jcfg), jax.random.key(0))

    def fill(s):
        a = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return a + 1 if len(s.shape) == 1 or (len(s.shape) == 2 and s.shape[0] == 1) else a

    return jax.tree.map(fill, shapes)


def _model(name):
    """The same parameters in both packages (numpy, the reference's tree),
    the port's copy by ``interop``, and tokens."""
    if name not in _MODELS:
        jcfg, cfg = jget_arch(name).make_smoke_config(), get_arch(name).make_smoke_config()
        tree = _tree(jcfg)
        params = jax.tree.map(jnp.asarray, tree)
        model = interop.transformer_params_from_numpy(tree, cfg, "cpu")
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        _MODELS[name] = (jcfg, cfg, params, tree, model, tokens)
    return _MODELS[name]


def _paths(tree, prefix=()):
    """``{path: leaf}`` of a parameter tree (dicts, lists, named tuples)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        items = enumerate(tree)
    elif hasattr(tree, "_fields"):
        items = tree._asdict().items()
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, sub in items:
        out.update(_paths(sub, prefix + (key,)))
    return out


@pytest.mark.parametrize("name", ZOO)
def test_logits_prefill_and_decode_match_jax(name):
    jcfg, cfg, params, _, model, tokens = _model(name)
    want = np.asarray(jax.jit(lambda p, t: jt.transformer_logits(p, jcfg, t))(params, tokens))
    np.testing.assert_allclose(tt.transformer_logits(model, cfg, tokens).numpy(), want, **TOL)
    np.testing.assert_allclose(
        tt.prefill(model, cfg, tokens).numpy(),
        np.asarray(jax.jit(lambda p, t: jt.prefill(p, jcfg, t))(params, tokens)), **TOL)

    step = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    jcache = jt.make_cache(jcfg, 2, 12)
    cache = tt.make_cache(cfg, 2, 12, device="cpu")
    for i in range(STEPS):
        wl, jcache = step(params, jcache, jnp.asarray(tokens[:, i]))
        got, cache = tt.decode_step(model, cfg, cache, tokens[:, i])
        np.testing.assert_allclose(got.numpy(), np.asarray(wl), **TOL)
    for key in jcache:
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **TOL)
    if not cfg.moe:  # an MoE step routes B tokens, the forward B·S: other capacities
        # the step's logits are the full forward's at the last fed position
        np.testing.assert_allclose(got.numpy(), want[:, STEPS - 1], atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("name", LMS)
def test_make_cache_keys_and_shapes_equal_the_reference(name):
    jcfg, cfg = jget_arch(name).make_smoke_config(), get_arch(name).make_smoke_config()
    want = jt.make_cache(jcfg, 3, 20)
    got = tt.make_cache(cfg, 3, 20, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        assert not got[key].any()
    full = get_arch(name).make_config()
    keys = set(tt.make_cache(full, 1, 1, device="meta"))
    assert keys == set(jt.make_cache(jget_arch(name).make_config(), 1, 1))


@pytest.mark.parametrize("name", ZOO)
def test_interop_round_trip(name):
    _, cfg, _, tree, model, _ = _model(name)
    back = interop.transformer_params_to_numpy(model)
    got, want = _paths(back), _paths(tree)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf.astype(np.float32), err_msg=str(path))
    again = interop.transformer_params_from_numpy(back, cfg, "cpu")
    for a, b in zip(again.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", LMS)
def test_full_config_param_counts_equal_the_reference(name):
    jcfg, cfg = jget_arch(name).make_config(), get_arch(name).make_config()
    assert tt.count_params(cfg) == jt.count_params(jcfg)
    assert tt.count_active_params(cfg) == jt.count_active_params(jcfg)
    jfields = jcfg.__dict__
    for field, value in cfg.__dict__.items():
        if field != "dtype":
            assert jfields[field] == value, field


def test_registry():
    assert get_arch("apss").family == "apss"
    for name in LMS:
        arch = get_arch(name)
        assert arch.family == "lm" and list(arch.shapes) == list(jget_arch(name).shapes)
        assert arch.source == jget_arch(name).source
    assert len(ASSIGNED) == 10 and set(LMS) <= set(ASSIGNED)
    for name in set(ASSIGNED) - set(LMS):  # the GNN and recsys families
        arch = get_arch(name)
        assert arch.family == jget_arch(name).family
        assert list(arch.shapes) == list(jget_arch(name).shapes)
        assert arch.source == jget_arch(name).source
    with pytest.raises(KeyError, match="unported"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("name", ["minicpm3-4b", "deepseek-moe-16b"])
def test_lm_server_token_streams_equal_the_reference(name, monkeypatch):
    # The reference server runs _model's parameters (its own init would
    # only compile another copy of the same kind of tree).
    monkeypatch.setattr(jserve, "init_transformer", lambda key, cfg: _model(name)[2])
    ref = JaxLMServer(jget_arch(name).make_smoke_config(), max_batch=2, max_len=32, seed=0)
    cfg = get_arch(name).make_smoke_config()
    model = interop.transformer_params_from_numpy(
        jax.tree.map(np.asarray, ref.params), cfg, "cpu")
    srv = LMServer(cfg, max_batch=2, max_len=32, params=model, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=4), rng.integers(0, cfg.vocab_size, size=3)]
    streams = []
    for s in (srv, ref):
        out = []
        for p in prompts:
            slot = s.add_request(p)
            out.append((slot, list(s.outputs[slot]), s.generate(slot, 5)))
        streams.append(out)
    assert streams[0] == streams[1]
    np.testing.assert_array_equal(srv.cache["length"].numpy(), np.asarray(ref.cache["length"]))


@pytest.mark.parametrize("dqk,dv", [(24, 16), (96, 64), (16, 16)])
def test_mla_padded_flash_equals_plain_attention(dqk, dv):
    """K8's call on MLA's head dims, through its plain version on the CPU:
    the zero padding changes no score and the scale is the unpadded one."""
    rng = np.random.default_rng(dqk)
    q, k = (torch.from_numpy(rng.standard_normal((2, 3, 70, dqk)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 3, 70, dv)).astype(np.float32))
    scale = 1.0 / dqk ** 0.5
    got = tt._mla_flash(q, k, v, scale=scale)
    want = tlayers.chunked_attention(q, k, v, causal=True, scale=scale, q_chunk=35, kv_chunk=35)
    assert got.shape == want.shape == (2, 3, 70, dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="head dims"):
        tt._mla_flash(torch.zeros(1, 1, 4, 192), torch.zeros(1, 1, 4, 192),
                      torch.zeros(1, 1, 4, 128), scale=1.0)


@pytest.mark.parametrize("name", ZOO)
def test_serve_cli_serves_every_lm(name, capsys):
    from repro_torch.launch import serve

    report = serve.main(["--mode", "lm", "--device", "cpu", "--arch", name, "--requests", "2",
                         "--gen-tokens", "3"])
    assert report["arch"] == name and report["tokens"] == 2 * (3 + 4)
    assert [len(o) for o in report["outputs"]] == [3, 3]
    assert "tok/s" in capsys.readouterr().out
