"""Parity of the port's MoE layer (``repro_torch.models.moe``) with the JAX
package's ``moe_ffn`` on the CPU.

The same numpy tokens and parameters go through both packages, at a
capacity that drops tokens and at one that drops none, with a router whose
experts 1 and 5 are identical columns (every token ties them; the lower id
must come first). The routing decisions are the reference's bit for bit:
expert ids, the kept slots of the sort-based dispatch and ``dropped_frac``
exactly equal (the reference's decisions are re-derived here from its own
functions: ``lax.top_k``, a stable argsort and the capacity rule), and so
the dropped count; ``dropped_frac`` within an f32 ulp of 1 (XLA computes
``1 - mean`` as one FMA); ``y`` and ``aux_loss`` within 1e-5 (float32).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

T, D, F, E = 48, 32, 24, 8
TOL = dict(atol=1e-5, rtol=0)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((D, E)).astype(np.float32)
    router[:, 5] = router[:, 1]  # experts 1 and 5 tie on every token
    ex = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    return router, *ex


def _port(params):
    p = tmoe.MoEParams(D, F, E, torch.float32, "cpu")
    with torch.no_grad():
        for name, a in zip(("router", "w_gate", "w_up", "w_down"), params):
            getattr(p, name).copy_(torch.from_numpy(a))
    return p


def _reference_route(params, x, top_k, cf):
    """The reference's routing decisions, step by step as ``moe_ffn`` takes them."""
    C = max(1, int(T * top_k * cf / E))
    ids, slot, keep = jax.jit(functools.partial(_route, top_k=top_k, C=C))(
        jnp.asarray(params[0]), jnp.asarray(x))
    return np.asarray(ids), np.asarray(slot), np.asarray(keep), C


def _route(router, x, *, top_k, C):
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x, router), axis=-1)
    _, ids = lax.top_k(probs, top_k)
    flat = ids.reshape(-1)
    order = jnp.argsort(flat, stable=True)
    counts = jnp.bincount(flat, length=E)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(T * top_k) - starts[flat[order]]
    keep = rank < C
    slot = jnp.where(keep, flat[order] * C + rank, E * C)
    return ids, slot, keep


@pytest.mark.parametrize("top_k,cf,drops", [(3, 0.5, True), (2, 4.0, False)])
def test_moe_ffn_matches_reference(top_k, cf, drops):
    params = _params()
    x = np.random.default_rng(1).standard_normal((T, D)).astype(np.float32)
    jp = jmoe.MoEParams(*(jnp.asarray(a) for a in params))
    want = jax.jit(functools.partial(jmoe.moe_ffn, top_k=top_k, capacity_factor=cf))(
        jp, jnp.asarray(x))
    p = _port(params)
    xt = torch.from_numpy(x)
    got = tmoe.moe_ffn(p, xt, top_k=top_k, capacity_factor=cf)
    route = tmoe.moe_route(p, xt, top_k=top_k, capacity_factor=cf)
    ids, slot, keep, C = _reference_route(params, x, top_k, cf)

    assert route.capacity == C
    np.testing.assert_array_equal(route.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(route.slot.numpy(), slot)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    # The dropped count is exact (``keep`` above); XLA fuses 1 - mean into one
    # FMA, torch divides, so the fractions may part by an f32 ulp of 1.
    assert abs(float(got.dropped_frac) - float(want.dropped_frac)) <= 2 ** -23
    assert float(got.dropped_frac) == 1.0 - keep.sum() / keep.size
    assert (float(got.dropped_frac) > 0) == drops
    # the tie: expert 1 is always picked before expert 5
    both = (ids == 1).any(1) & (ids == 5).any(1)
    assert both.any()
    pos1 = np.argmax(ids == 1, axis=1)
    pos5 = np.argmax(ids == 5, axis=1)
    assert (pos1[both] < pos5[both]).all()
    assert not ((ids == 5).any(1) & ~(ids == 1).any(1)).any()

    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), **TOL)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), **TOL)


def test_capacity_truncates_as_the_reference():
    for tokens, k, cf, e in [(8, 6, 1.25, 64), (48, 3, 0.5, 8), (1, 2, 1.25, 128), (7, 2, 1.1, 3)]:
        assert tmoe.capacity(tokens, k, cf, e) == max(1, int(tokens * k * cf / e))
    # decode at batch 8 on deepseek-moe-16b: one slot per expert
    assert tmoe.capacity(8, 6, 1.25, 64) == 1


def test_init_moe_follows_the_reference_laws():
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(g, 64, 96, 16, torch.float32, "cpu")
    assert p.router.dtype == torch.float32 and tuple(p.router.shape) == (64, 16)
    assert tuple(p.w_gate.shape) == (16, 64, 96) and tuple(p.w_down.shape) == (16, 96, 64)
    for w, (a, b) in ((p.router, (64, 16)), (p.w_gate, (64, 96)), (p.w_down, (96, 64))):
        assert abs(w.std().item() / (2.0 / (a + b)) ** 0.5 - 1) < 0.1
    bf = tmoe.init_moe(g, 64, 96, 16, torch.bfloat16, "cpu")
    assert bf.router.dtype == torch.float32 and bf.w_up.dtype == torch.bfloat16
