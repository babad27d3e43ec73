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
