"""Parity of the port's attention kernels' plain versions and their ``ops``
wrappers (K8 flash attention, K9 flash-decode partials) with the JAX package.

The same numpy inputs (from seeds) go through both packages on the CPU: the
JAX side through its Pallas kernels in interpret mode (a handful of cases,
S ≤ 256) and its jnp references, the port's side through the ops wrappers,
which on CPU tensors run the kernels' plain versions. Tolerances, as in
``tests/test_kernels.py``: f32 atol 2e-5 on attention outputs, bf16 atol
2e-2. The unnormalised decode partials: m within 2e-5, l and acc within a
relative 1e-5 (they grow with the length) plus 2e-5.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as jdops  # noqa: E402
from repro.kernels.decode_attention import ref as jdref  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_reference as jattn  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    combine_partials,
    combine_partials_reference,
    decode_attention,
    decode_attention_partials,
    decode_attention_reference,
    decode_partials_reference,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference,
    flash_attention,
)

# The kernel modules (their packages export same-named functions).
k8 = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
k9 = importlib.import_module("repro_torch.kernels.decode_attention.decode_attention")
BF16_ATOL = 2e-2


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(B, Hq, Hkv, S, D, seed=0):
    return (_normal((B, Hq, S, D), seed), _normal((B, Hkv, S, D), seed + 1),
            _normal((B, Hkv, S, D), seed + 2))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# -- K8: flash attention --------------------------------------------------------


@pytest.mark.parametrize(
    "B,Hq,Hkv,S,D",
    [
        (1, 2, 2, 1, 16),     # S = 1 (padded to 128), group 1
        (2, 4, 2, 130, 32),   # ragged S (padded to 256), group 2
        (1, 8, 2, 128, 16),   # group 4
    ],
)
def test_flash_attention_matches_pallas_interpret(B, Hq, Hkv, S, D):
    q, k, v = _qkv(B, Hq, Hkv, S, D)
    got = flash_attention(_t(q), _t(k), _t(v)).numpy()
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    ref = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_flash_attention_bf16_matches_pallas_interpret():
    q, k, v = _qkv(1, 4, 2, 128, 64, seed=3)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = flash_attention(*(_t(np.asarray(a, np.float32)).bfloat16() for a in bf))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jflash(*bf, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)


def test_flash_attention_noncausal_and_its_value_error():
    q, k, v = _qkv(1, 2, 2, 256, 32, seed=5)
    got = flash_attention(_t(q), _t(k), _t(v), causal=False).numpy()
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                             interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    q, k, v = _qkv(1, 2, 2, 130, 32, seed=6)
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(_t(q), _t(k), _t(v), causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, interpret=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_attention_reference_and_plain_version_match_jax(causal, group):
    q, k, v = _qkv(2, 4, 4 // group, 70, 16, seed=group)
    want = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = attention_reference(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    plain = k8.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal, rows=32).numpy()
    np.testing.assert_allclose(plain, want, atol=2e-5, rtol=0)


def test_k8_wrapper_on_cpu_runs_the_plain_version_without_counting():
    q, k, v = (_t(a) for a in _qkv(1, 4, 2, 64, 16, seed=9))
    before = k8.LAUNCHES["flash_attention"]
    got = k8.flash_attention_kernel(q, k, v)
    assert torch.equal(got, k8.flash_attention_plain(q, k, v))
    assert k8.LAUNCHES["flash_attention"] == before


# -- K9: flash-decode partials ----------------------------------------------------


DECODE_CASES = [
    (3, 2, 2, 100, 16, [0, 1, 100]),     # lengths 0, 1 and L; group 1
    (3, 4, 2, 1000, 64, [0, 1, 1000]),   # group 2
    (2, 8, 2, 300, 32, [150, 300]),      # group 4
]


def _decode_inputs(B, Hq, Hkv, L, D, seed):
    return (_normal((B, Hq, D), seed), _normal((B, Hkv, L, D), seed + 1),
            _normal((B, Hkv, L, D), seed + 2))


def _assert_partials(got, want):
    acc, m, l = (np.asarray(a) for a in got)
    wacc, wm, wl = (np.asarray(a) for a in want)
    np.testing.assert_allclose(m, wm, atol=2e-5, rtol=0)
    np.testing.assert_allclose(l, wl, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(acc, wacc, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("B,Hq,Hkv,L,D,lengths", DECODE_CASES)
def test_decode_partials_match_pallas_interpret_and_refs(B, Hq, Hkv, L, D, lengths):
    q, k, v = _decode_inputs(B, Hq, Hkv, L, D, seed=L)
    lens = np.asarray(lengths, np.int32)
    got = [a.numpy() for a in decode_attention_partials(_t(q), _t(k), _t(v), torch.tensor(lens))]
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    _assert_partials(got, jdops.decode_attention_partials(jq, jk, jv, jl, block_k=256,
                                                          interpret=True))
    _assert_partials(got, jdref.decode_partials_reference(jq, jk, jv, jl))
    port_ref = decode_partials_reference(_t(q), _t(k), _t(v), torch.tensor(lens))
    _assert_partials(got, [a.numpy() for a in port_ref])
    empty = lens == 0
    assert (got[1][empty] == -0.5e30).all() and (got[2][empty] == 0).all()
    out = decode_attention(_t(q), _t(k), _t(v), torch.tensor(lens)).numpy()
    np.testing.assert_allclose(out, np.asarray(jdref.decode_attention_reference(jq, jk, jv, jl)),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        decode_attention_reference(_t(q), _t(k), _t(v), torch.tensor(lens)).numpy(), out,
        atol=2e-5, rtol=0)


def test_decode_attention_bf16_matches_pallas_interpret():
    q, k, v = _decode_inputs(2, 4, 2, 200, 32, seed=11)
    lens = np.asarray([200, 77], np.int32)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = decode_attention(*(_t(np.asarray(a, np.float32)).bfloat16() for a in bf),
                           torch.tensor(lens))
    want = np.asarray(jdops.decode_attention(*bf, jnp.asarray(lens), block_k=128,
                                             interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_combine_partials_over_shards(P):
    B, Hq, Hkv, L, D = 2, 8, 4, 256, 32
    q, k, v = _decode_inputs(B, Hq, Hkv, L, D, seed=20 + P)
    lens = np.asarray([L, L // 3], np.int32)
    shard = L // P
    parts = []
    for s in range(P):
        loc = np.clip(lens - s * shard, 0, shard).astype(np.int32)
        sl = slice(s * shard, (s + 1) * shard)
        parts.append(decode_attention_partials(
            _t(q), _t(k[:, :, sl]), _t(v[:, :, sl]), torch.tensor(loc)))
    accs, ms, ls = (torch.stack(x) for x in zip(*parts))
    got = combine_partials(accs, ms, ls).numpy()
    want = np.asarray(jdref.decode_attention_reference(*(jnp.asarray(a) for a in (q, k, v, lens))))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    jcomb = jdops.combine_partials(*(jnp.asarray(a.numpy()) for a in (accs, ms, ls)))
    np.testing.assert_allclose(got, np.asarray(jcomb), atol=1e-6, rtol=0)
    np.testing.assert_allclose(combine_partials_reference(accs, ms, ls).numpy(), got,
                               atol=1e-6, rtol=0)


def test_k9_wrapper_on_cpu_runs_the_plain_version_without_counting():
    q, k, v = (_t(a) for a in _decode_inputs(2, 4, 2, 50, 16, seed=30))
    lens = torch.tensor([50, 3], dtype=torch.int32)
    before = k9.LAUNCHES["decode_attention"]
    got = k9.decode_attention_kernel(q, k, v, lens)
    for a, b in zip(got, k9.decode_attention_plain(q, k, v, lens)):
        assert torch.equal(a, b)
    assert k9.LAUNCHES["decode_attention"] == before
