"""Parity of the port's dense-output kernel module (K7,
``repro_torch.kernels.apss_block.apss_block`` and ``ops.apss_block_matmul``)
with the JAX package, on the CPU.

On a CPU tensor the K7 wrapper runs its plain version,
``apss_block_plain``; these tests hold it and ``apss_block_matmul`` against
the JAX ``apss_block_matmul`` (the Pallas kernel in interpret mode) and
``apss_block_reference``. Tolerance: inputs keep every float64 score more
than 1e-5 from t, so both packages keep the same entries; the zero pattern
must be equal and values within 1e-6 (f32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import VAL_TOL, assert_clear_of_threshold, host  # noqa: E402
from repro.core.pruning import block_prune_mask as jblock_prune_mask  # noqa: E402
from repro.kernels.apss_block import ops as jops  # noqa: E402
from repro.kernels.apss_block.ref import apss_block_reference  # noqa: E402
from repro_torch.core.pruning import block_prune_mask  # noqa: E402
from repro_torch.kernels.apss_block import apss_block, fused, ops  # noqa: E402

T = 0.3


def _corp(n, m, seed, density=0.3):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < density
    return D / np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)


def _assert_same_scores(got, ref):
    g, r = host(got), np.asarray(ref)
    assert g.shape == r.shape and g.dtype == r.dtype == np.float32
    np.testing.assert_array_equal(g != 0, r != 0)
    np.testing.assert_allclose(g, r, atol=VAL_TOL, rtol=0)


@pytest.mark.parametrize(
    "case", ["self_auto_mask", "rect_no_mask", "explicit_dead_tiles", "negative_t"]
)
def test_apss_block_matmul_matches_jax_interpret(case):
    x = _corp(130, 100, seed=2)  # neither axis a tile multiple
    y, t, kw = x, T, {}
    if case == "rect_no_mask":
        y, kw = _corp(200, 100, seed=12), dict(auto_mask=False)
    elif case == "explicit_dead_tiles":
        y = _corp(200, 100, seed=13)
        mask = np.ones((2, 2), np.int32)
        mask[0, 1] = mask[1, 0] = 0
        kw = dict(block_mask=mask)
    elif case == "negative_t":
        t = -0.1  # zero-padded rows score 0 ≥ t but are sliced away
    assert_clear_of_threshold(x, y, t)
    blocks = dict(block_m=128, block_n=128, block_k=128)
    ref = jops.apss_block_matmul(
        jnp.asarray(x), jnp.asarray(y), t, interpret=True, **blocks, **kw
    )
    got = ops.apss_block_matmul(x, x if y is x else y, t, device="cpu", **blocks, **kw)
    _assert_same_scores(got, ref)
    if case == "explicit_dead_tiles":
        g = host(got)
        assert not g[:128, 128:].any() and not g[128:, :128].any()
        assert g[:128, :128].any()


@pytest.mark.parametrize("with_mask", [False, True])
def test_apss_block_plain_matches_reference(with_mask):
    x = _corp(256, 96, seed=9)
    y = _corp(384, 96, seed=10)
    assert_clear_of_threshold(x, y, T)
    mask = None
    if with_mask:
        mask = np.asarray(jblock_prune_mask(jnp.asarray(x), jnp.asarray(y), T, 64, 128,
                                            use_minsize=False)).astype(np.int32)
        mask[1, 2] = 0  # a live tile declared dead: the oracle zeroes it too
    kw = dict(block_m=64, block_n=128)
    ref = apss_block_reference(
        jnp.asarray(x), jnp.asarray(y), T,
        block_mask=None if mask is None else jnp.asarray(mask), **kw,
    )
    got = apss_block.apss_block_plain(
        torch.from_numpy(x), torch.from_numpy(y), T,
        block_mask=None if mask is None else torch.from_numpy(mask), **kw,
    )
    _assert_same_scores(got, ref)
    # A bound mask proves its dead tiles empty: masked and unmasked agree.
    bound = block_prune_mask(torch.from_numpy(x), torch.from_numpy(y), T, 64, 128,
                             use_minsize=False)
    np.testing.assert_array_equal(
        host(apss_block.apss_block_plain(torch.from_numpy(x), torch.from_numpy(y), T,
                                         block_mask=bound, **kw)),
        host(apss_block.apss_block_plain(torch.from_numpy(x), torch.from_numpy(y), T)),
    )


def test_cpu_tensors_take_the_plain_version():
    before = dict(fused.LAUNCHES)
    x = torch.from_numpy(_corp(128, 64, seed=6))
    mask = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    a = apss_block.apss_block_kernel(x, x, mask, T, block_m=64, block_n=64)
    b = apss_block.apss_block_plain(x, x, T, block_mask=mask, block_m=64, block_n=64)
    np.testing.assert_array_equal(host(a), host(b))
    assert not host(a)[:64, 64:].any()
    assert fused.LAUNCHES == before  # a plain version launches nothing


def test_bf16_inputs_are_widened_exactly():
    x = _corp(128, 96, seed=7)
    xb = torch.from_numpy(x).bfloat16()
    xw = xb.float().numpy()
    assert_clear_of_threshold(xw, xw, T)
    got = ops.apss_block_matmul(xb, xb, T, block_m=128, block_n=128, block_k=128,
                                device="cpu")
    ref = apss_block_reference(jnp.asarray(xw), jnp.asarray(xw), T)
    _assert_same_scores(got, ref)


# -- the kernel's f32 arithmetic: a three-pass TF32 split ----------------------


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, by float64
    arithmetic on the mantissa (normal numbers only)."""
    mant, exp = np.frexp(x.astype(np.float64))  # |mant| in [0.5, 1)
    q = mant * 2.0**11
    q = np.sign(q) * np.floor(np.abs(q) + 0.5)
    return np.ldexp(q / 2.0**11, exp).astype(np.float32)


def test_tf32_round_is_nearest_ties_away_from_zero():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 6, 20000)).astype(np.float32)
    # Exact ties (the 13 dropped bits 0x1000), just below and just above, both signs.
    base = rng.integers(0x3F000000, 0x40000000, 64, dtype=np.int64) & ~0x1FFF
    for low in (0x1000, 0x0FFF, 0x1001, 0x1FFF):
        bits = (base | low).astype(np.uint32).view(np.float32)
        x = np.concatenate([x, bits, -bits])
    got = host(apss_block.tf32_round(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, _tf32_reference(x))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    ties = (base | 0x1000).astype(np.uint32).view(np.float32)
    up = host(apss_block.tf32_round(torch.from_numpy(np.concatenate([ties, -ties]))))
    np.testing.assert_array_equal(np.abs(up[:64]).view(np.uint32), base.astype(np.uint32) + 0x2000)
    np.testing.assert_array_equal(up[64:], -up[:64])


def _split_cases():
    from repro_torch.data.synthetic import clustered_corpus, synthetic_corpus

    rng = np.random.default_rng(5)
    dense = rng.standard_normal((192, 640)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    return {
        # radikal's 155.8 nonzeros a row over a narrower feature range
        "synthetic_radikal_density": synthetic_corpus(256, 8192, 1072472 / 6883, seed=1),
        "clustered": clustered_corpus(256, 768, 16, n_clusters=4, seed=2),
        "dense_unit_rows": dense,  # every product nonzero: the most terms a score
        "bf16_rounded": torch.from_numpy(_corp(256, 384, seed=3)).bfloat16().float().numpy(),
        "bf16_tiny_and_huge": torch.from_numpy(np.concatenate([
            _corp(64, 384, seed=4) * 1e-3, _corp(64, 384, seed=5)])).bfloat16().float().numpy(),
    }


@pytest.mark.parametrize("case", list(_split_cases()))
def test_split_scores_within_2e6_of_f64(case):
    """hi·hi + hi·lo + lo·hi misses x·y by at most ~7.2e-7 Σ|x_i y_i| plus f32
    rounding of the sums: within 2e-6 of the float64 product on unit rows."""
    D = _split_cases()[case]
    got = host(apss_block.apss_block_split_plain(torch.from_numpy(D), torch.from_numpy(D), -2.0))
    exact = D.astype(np.float64) @ D.astype(np.float64).T
    assert np.abs(got - exact).max() <= 2e-6
    if case.startswith("bf16"):  # lo = 0: the plain full-f32 product
        plain = host(apss_block.apss_block_plain(torch.from_numpy(D), torch.from_numpy(D), -2.0))
        np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)


def test_split_parts_are_tf32_and_exact_in_sum():
    x = torch.from_numpy(_split_cases()["dense_unit_rows"])
    hi = apss_block.tf32_round(x)
    lo = apss_block.tf32_round(x - hi)
    for part in (hi, lo):
        assert not (host(part).view(np.uint32) & 0x1FFF).any()
    # |x - hi - lo| <= 2^-22 |x|: the split keeps 22 of f32's 24 bits.
    rest = np.abs(host(x).astype(np.float64) - host(hi) - host(lo))
    assert (rest <= 2.0**-22 * np.abs(host(x)) + 1e-45).all()


@pytest.mark.parametrize("t", [0.3, -0.5])
def test_split_matrix_matches_jax_off_the_band(t):
    """The split's thresholded matrix against the JAX package's
    ``apss_block_matmul`` (Pallas interpret): equal zero pattern off the
    |s - t| <= 1e-5 band, values within 2e-6, dead tiles zero."""
    x = _corp(256, 160, seed=21)
    y = _corp(384, 160, seed=22)
    mask = np.ones((2, 3), np.int32)
    mask[0, 2] = mask[1, 0] = 0
    blocks = dict(block_m=128, block_n=128)
    ref = np.asarray(jops.apss_block_matmul(jnp.asarray(x), jnp.asarray(y), t, block_mask=mask,
                                            block_k=128, interpret=True, **blocks))
    got = host(apss_block.apss_block_split_plain(torch.from_numpy(x), torch.from_numpy(y), t,
                                                  block_mask=torch.from_numpy(mask), **blocks))
    band = np.abs(x.astype(np.float64) @ y.astype(np.float64).T - t) <= 1e-5
    np.testing.assert_array_equal((got != 0)[~band], (ref != 0)[~band])
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    assert not got[:128, 256:].any() and not got[128:, :128].any()
    assert (got != 0).sum() > 0
