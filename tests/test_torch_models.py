"""Parity of the port's LM (``repro_torch.models``, ``repro_torch.configs``,
the interop of its parameters) with the JAX package on the CPU.

The layers get the same numpy inputs in both packages. The model is
``qwen3_1_7b.smoke_config()`` (float32) with JAX's parameters carried across
by ``interop.transformer_params_from_numpy``: ``transformer_logits``,
``prefill`` and 24 ``decode_step`` calls are held to JAX at atol 5e-4 /
rtol 5e-3 (the tolerance ``tests/test_serving.py`` holds decode to the
full forward). Elementwise layers: within 1e-5 (f32 rounding of
differently ordered sums); attention layers: 2e-5, as the kernels' tests,
and 2e-2 (the bf16 tolerance) where the probabilities are rounded to bf16:
an f32 last-bit difference in p can round it to the neighbouring bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen3_1_7b as jqwen  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import qwen3_1_7b as tqwen  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

STEPS = 24
TOL = dict(atol=5e-4, rtol=5e-3)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def smoke():
    """JAX's smoke model, its numpy tree and the port's copy of it."""
    jcfg, cfg = jqwen.smoke_config(), tqwen.smoke_config()
    params = jt.init_transformer(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = interop.transformer_params_from_numpy(tree, cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, STEPS)).astype(np.int32)
    return jcfg, cfg, params, tree, model, tokens


# -- layers ------------------------------------------------------------------------


def test_rms_norm_and_rope_match_jax():
    x = _normal((2, 5, 4, 16), 0)
    scale = _normal((16,), 1)
    pos = np.random.default_rng(2).integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.rms_norm(_t(x), _t(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tlayers.head_rms_norm(_t(x), _t(scale)).numpy(),
        np.asarray(jlayers.head_rms_norm(jnp.asarray(x), jnp.asarray(scale))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tlayers.rope_frequencies(16, 1e6).numpy(),
        np.asarray(jlayers.rope_frequencies(16, 1e6)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos))), atol=1e-5, rtol=0)


def test_swiglu_matches_jax():
    x, wg, wu, wd = _normal((3, 7, 16), 3), _normal((16, 32), 4), _normal((16, 32), 5), \
        _normal((32, 16), 6)
    got = tlayers.swiglu(*(_t(a) for a in (x, wg, wu, wd))).numpy()
    want = np.asarray(jlayers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("probs", [None, "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(causal, probs):
    q, k, v = _normal((2, 4, 48, 16), 7), _normal((2, 2, 48, 16), 8), _normal((2, 2, 48, 16), 9)
    got = tlayers.chunked_attention(
        _t(q), _t(k), _t(v), causal=causal, q_chunk=16, kv_chunk=32,
        probs_dtype=torch.bfloat16 if probs else None).numpy()
    want = np.asarray(jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, q_chunk=16,
        kv_chunk=32, probs_dtype=jnp.bfloat16 if probs else None))
    np.testing.assert_allclose(got, want, atol=2e-2 if probs else 2e-5, rtol=0)


@pytest.mark.parametrize("with_partials", [False, True])
def test_decode_attention_xla_matches_jax(with_partials):
    q, k, v = _normal((3, 4, 16), 10), _normal((3, 2, 40, 16), 11), _normal((3, 2, 40, 16), 12)
    lens = np.asarray([0, 1, 40], np.int32)
    got = tlayers.decode_attention_xla(_t(q), _t(k), _t(v), torch.from_numpy(lens),
                                       with_partials=with_partials)
    want = jlayers.decode_attention_xla(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                        with_partials=with_partials)
    for g, w in zip(got if with_partials else [got], want if with_partials else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5)


# -- the smoke model against JAX ------------------------------------------------------


def test_transformer_logits_and_prefill_match_jax(smoke):
    jcfg, cfg, params, _, model, tokens = smoke
    got = tt.transformer_logits(model, cfg, tokens).numpy()
    want = np.asarray(jt.transformer_logits(params, jcfg, jnp.asarray(tokens)))
    assert got.shape == (2, STEPS, cfg.padded_vocab)
    np.testing.assert_allclose(got, want, **TOL)
    got = tt.prefill(model, cfg, tokens)
    assert got.dtype == torch.float32
    want = np.asarray(jt.prefill(params, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_steps_match_jax_and_prefill(smoke):
    jcfg, cfg, params, _, model, tokens = smoke
    jcache = jt.make_cache(jcfg, 2, 32)
    cache = tt.make_cache(cfg, 2, 32, device="cpu")
    dec = jax.jit(lambda p, c, t: jt.decode_step(p, jcfg, c, t))
    for i in range(STEPS):
        want, jcache = dec(params, jcache, jnp.asarray(tokens[:, i]))
        got, cache = tt.decode_step(model, cfg, cache, tokens[:, i])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache["length"].numpy(), STEPS)
    assert cache["length"].dtype == torch.int32
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5, rtol=0)
    # decode over every position ends where prefill's last position does
    np.testing.assert_allclose(got.numpy(), tt.prefill(model, cfg, tokens).numpy(), **TOL)


def test_decode_cache_isolated_between_sequences(smoke):
    _, cfg, _, _, model, tokens = smoke

    def decode_all(toks):
        cache = tt.make_cache(cfg, toks.shape[0], 24, device="cpu")
        for i in range(toks.shape[1]):
            logits, cache = tt.decode_step(model, cfg, cache, toks[:, i])
        return logits

    both = decode_all(tokens[:, :16])
    first = decode_all(tokens[:1, :16])
    np.testing.assert_allclose(both[0].numpy(), first[0].numpy(), atol=1e-4, rtol=1e-4)


def test_full_cache_raises_before_writing(smoke):
    _, cfg, _, _, model, tokens = smoke
    cache = tt.make_cache(cfg, 2, 4, device="cpu")
    for i in range(4):
        tt.decode_step(model, cfg, cache, tokens[:, i])
    k = cache["k"].clone()
    with pytest.raises(ValueError, match="filled its cache of 4 positions"):
        tt.decode_step(model, cfg, cache, tokens[:, 4])
    assert torch.equal(cache["k"], k) and cache["length"].tolist() == [4, 4]


def test_count_params():
    assert tt.count_params(tqwen.config()) == 2_032_264_192
    assert tt.count_params(tqwen.smoke_config()) == jt.count_params(jqwen.smoke_config())


def test_interop_round_trip_pins_the_transpose(smoke):
    _, cfg, _, tree, model, _ = smoke
    wq = model.layers[1].attn.wq.weight
    assert wq.shape == (cfg.n_heads * cfg.head_dim, cfg.d_model)
    np.testing.assert_array_equal(wq.numpy(), tree["layers"]["attn"]["wq"][1].T)
    np.testing.assert_array_equal(model.lm_head.weight.numpy(), tree["lm_head"].T)
    back = interop.transformer_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_config_registry_and_init():
    arch = get_arch("qwen3-1.7b")
    assert arch.family == "lm" and arch.make_config() == tqwen.config()
    jfields = jqwen.config().__dict__
    for name, value in tqwen.config().__dict__.items():
        if name != "dtype":
            assert jfields[name] == value, name
    model = tt.init_transformer(tqwen.smoke_config(), device="cpu")
    w = model.layers[0].ffn.w_gate.weight
    d_ff, d = w.shape
    assert abs(w.std().item() / (2.0 / (d + d_ff)) ** 0.5 - 1) < 0.1
    assert abs(model.embed.std().item() / 0.02 - 1) < 0.1
    assert torch.equal(model.final_norm, torch.ones(d))


def test_unported_variants_and_cpu_kernel_path_raise(smoke):
    _, cfg, _, _, model, tokens = smoke
    # Every assigned architecture is ported (the recsys and GNN families in
    # tests/test_torch_recsys_gnn.py); a name the registry lacks raises there.
    for name in ("gat-cora", "two-tower-retrieval", "bert4rec", "din", "bst"):
        assert get_arch(name).family in ("gnn", "recsys")
    with pytest.raises(KeyError, match="unported"):
        get_arch("no-such-arch")
    with pytest.raises(ValueError, match="unknown attention"):
        tt.init_transformer(tt.TransformerConfig(
            name="m", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=32,
            vocab_size=64, attention="linear"), device="cpu")
    with pytest.raises(ValueError, match="use_kernel=True"):
        tt.prefill(model, cfg, tokens, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True"):
        tt.decode_step(model, cfg, tt.make_cache(cfg, 2, 8, device="cpu"), tokens[:, 0],
                       use_kernel=True)
