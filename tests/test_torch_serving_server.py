"""The port's retrieval servers (``repro_torch.serving.server``) and its
``launch/serve.py`` retrieval mode, on the CPU.

Batched answers are held to the port's one-shot ``query_topk`` and to the
JAX package's (by set, counts and values within 1e-6, since on exact value
ties the JAX fold orders by worklist position); the degraded-mode contracts
(LRU, admission and deadline sheds, the kernel → plain → stale ladder,
retries, input rejection) are held to the reference's contract. The
deadline test compares the in-budget answer with the oracle to 1e-6: the
JAX test of the same contract fails on a bit-exact comparison under this
jax version. ``fault_plan`` is a stub with the reference FaultPlan's two
hooks.
"""

import contextlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import VAL_TOL  # noqa: E402
from repro.core.apss import normalize_rows as jnormalize  # noqa: E402
from repro.serving import build_index as jbuild  # noqa: E402
from repro.serving import query_topk as jquery  # noqa: E402
from repro_torch.core.matches import extract_matches  # noqa: E402
from repro_torch.core.precision import dot_f32  # noqa: E402
from repro_torch.kernels._build import KernelError  # noqa: E402
from repro_torch.serving import server as tserver  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousRetrievalServer,
    RetrievalServer,
    build_index,
    query_topk,
)

T, K = 0.3, 8


class StubFaults:
    """``fail_point(scope)`` raises for the scopes in ``errors`` (``times``
    firings each, −1: always); ``delay("serving", step)`` sleeps ``delay_s``
    once, at ``delay_step``."""

    def __init__(self, errors=(), times=-1, delay_s=0.0, delay_step=0):
        self.left = {scope: times for scope in errors}
        self.delay_s, self.delay_step = delay_s, delay_step
        self.fired = {}

    def fail_point(self, scope):
        if self.left.get(scope, 0) != 0:
            self.left[scope] -= 1
            self.fired[scope] = self.fired.get(scope, 0) + 1
            raise RuntimeError(f"injected error in {scope}")

    def delay(self, scope, step=None):
        if scope == "serving" and step == self.delay_step and self.delay_s:
            self.fired["delay"] = self.fired.get("delay", 0) + 1
            time.sleep(self.delay_s)


def _corpus_queries(n, m, density, nq, seed):
    rng = np.random.default_rng(seed)
    C = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    C *= rng.random((n, m)) < density
    Q = np.abs(rng.standard_normal((nq, m))).astype(np.float32)
    Q *= rng.random((nq, m)) < density
    return np.asarray(jnormalize(jnp.asarray(C))), np.asarray(jnormalize(jnp.asarray(Q)))


@pytest.fixture(scope="module")
def case():
    C, Q = _corpus_queries(220, 96, 0.12, 10, seed=7)
    return C, Q, build_index(C, block_rows=64, normalize=False, device="cpu")


def _oracle_row(C, q, t=T, k=K):
    m = extract_matches(dot_f32(torch.from_numpy(q[None]), torch.from_numpy(C)), t, k,
                        exclude_self=False)
    return m.values[0].numpy(), m.indices[0].numpy(), int(m.counts[0])


def _assert_result_is(res, C, q):
    v, i, c = _oracle_row(C, q)
    assert res.status == "ok" and res.count == c
    np.testing.assert_array_equal(res.indices, i)
    np.testing.assert_allclose(res.values, v, rtol=0, atol=VAL_TOL)


@pytest.mark.parametrize("server", ["step", "continuous"])
def test_batched_equals_one_shot_and_jax(case, server):
    C, Q, index = case
    jidx = jbuild(C, block_rows=64, normalize=False)
    kw = dict(threshold=T, k=K, max_batch=4, normalize=False, block_q=8)
    srv = (ContinuousRetrievalServer(index, workers=2, **kw) if server == "continuous"
           else RetrievalServer(index, **kw))
    with contextlib.closing(srv):
        results = srv.serve([Q[i] for i in range(10)])
    assert len(results) == 10 and all(r.status == "ok" for r in results)
    assert srv.stats.requests == 10 and srv.stats.cache_hits == 0
    if server == "step":
        assert srv.stats.steps == 3
    for i, res in enumerate(results):
        one = query_topk(index, Q[i][None], T, K, block_q=8)
        assert res.count == int(one.counts[0])
        np.testing.assert_array_equal(res.indices, one.indices[0].numpy())
        np.testing.assert_array_equal(res.values, one.values[0].numpy())
        j = jquery(jidx, jnp.asarray(Q[i][None]), T, K, block_q=8)
        ji = np.asarray(j.indices)[0]
        assert res.count == int(np.asarray(j.counts)[0])
        assert set(res.indices[res.indices >= 0]) == set(ji[ji >= 0])
        np.testing.assert_allclose(np.sort(res.values), np.sort(np.asarray(j.values)[0]),
                                   atol=VAL_TOL)


def test_server_on_bf16_index_equals_one_shot_and_jax():
    """The server's batch is f32 and a bf16 index scores it unrounded: each
    answer equals one-shot ``query_topk`` and the JAX package's result on
    the same bf16 index."""
    C, Q = _corpus_queries(300, 96, 0.3, 12, seed=9)
    index = build_index(torch.from_numpy(C).bfloat16(), block_rows=64, normalize=False,
                        device="cpu")
    jidx = jbuild(jnp.asarray(C).astype(jnp.bfloat16), block_rows=64, normalize=False)
    srv = RetrievalServer(index, threshold=T, k=K, max_batch=8, normalize=False, block_q=8)
    with contextlib.closing(srv):
        results = srv.serve([Q[i] for i in range(12)])
    assert all(r.status == "ok" for r in results)
    for i, res in enumerate(results):
        one = query_topk(index, Q[i][None], T, K, block_q=8)
        assert res.count == int(one.counts[0])
        np.testing.assert_array_equal(res.indices, one.indices[0].numpy())
        np.testing.assert_array_equal(res.values, one.values[0].numpy())
        j = jquery(jidx, jnp.asarray(Q[i][None]), T, K, block_q=8)
        assert res.count == int(np.asarray(j.counts)[0])
        np.testing.assert_array_equal(res.indices, np.asarray(j.indices)[0])
        np.testing.assert_allclose(res.values, np.asarray(j.values)[0], rtol=0, atol=VAL_TOL)


def test_lru_cache_hit_and_frozen_results(case):
    C, Q, index = case
    srv = RetrievalServer(index, threshold=T, k=K, cache_size=2)
    first = srv.result(srv.submit(Q[0]))
    again = srv.result(srv.submit(Q[0]))
    assert not first.cached and again.cached and srv.stats.cache_hits == 1
    np.testing.assert_array_equal(first.indices, again.indices)
    with pytest.raises(ValueError):
        first.values[0] = 1.0
    for i in (1, 2):  # evict Q[0]
        srv.result(srv.submit(Q[i]))
    assert not srv.result(srv.submit(Q[0])).cached


def test_admission_budget_sheds_overflow(case):
    C, Q, index = case
    srv = RetrievalServer(index, threshold=T, k=K, cache_size=0, max_pending=2)
    rids = [srv.submit(Q[i]) for i in range(5)]
    statuses = [srv.result(r).status for r in rids]
    assert statuses == ["ok", "ok", "shed", "shed", "shed"]
    assert srv.stats.shed == 3


def test_deadline_sheds_late_keeps_exact(case):
    """A slow step: the tight-deadline request is shed, the in-budget one is
    exact against the oracle (its identical corpus row is a match)."""
    C, _, index = case
    plan = StubFaults(delay_s=0.05)
    srv = RetrievalServer(index, threshold=T, k=K, cache_size=0, fault_plan=plan)
    rid_late = srv.submit(C[0], deadline_s=0.01)
    rid_ok = srv.submit(C[1])
    while srv._pending:
        srv.step()
    late, ok = srv.result(rid_late), srv.result(rid_ok)
    assert plan.fired["delay"] == 1
    assert late.status == "shed" and late.count == 0 and srv.stats.shed == 1
    _assert_result_is(ok, C, C[1])
    assert 1 in ok.indices


def test_kernel_tier_down_degrades_to_plain_exact(case):
    C, _, index = case
    plan = StubFaults(errors=("serving.kernel",))
    srv = RetrievalServer(index, threshold=T, k=K, cache_size=0, use_kernel=True,
                          max_retries=1, backoff_s=0.001, fault_plan=plan)
    res = srv.result(srv.submit(C[2]))
    _assert_result_is(res, C, C[2])
    assert plan.fired == {"serving.kernel": 2}
    assert srv.stats.retries == 1 and srv.stats.degraded == 1


def test_transient_error_recovers_by_retry(case):
    C, _, index = case
    plan = StubFaults(errors=("serving.plain",), times=1)
    srv = RetrievalServer(index, threshold=T, k=K, cache_size=0, max_retries=2,
                          backoff_s=0.001, fault_plan=plan)
    res = srv.result(srv.submit(C[3]))
    _assert_result_is(res, C, C[3])
    assert srv.stats.retries == 1 and srv.stats.degraded == 0


@pytest.mark.parametrize("server", ["step", "continuous"])
@pytest.mark.parametrize("fault", [KernelError("rect_tile_candidates kernel launch failed"),
                                   ValueError("block_q must be a multiple of 8")],
                         ids=["kernel_error", "refused_operands"])
def test_kernel_fault_propagates_instead_of_degrading(case, monkeypatch, server, fault):
    """A kernel that does not build or launch, or refuses its operands, is
    raised to the caller: the plain tier must not hide it."""
    C, _, index = case
    calls = []

    def broken(*args, use_kernel=False, **kw):
        calls.append(use_kernel)
        if use_kernel:
            raise fault
        return query_topk(*args, use_kernel=use_kernel, **kw)

    monkeypatch.setattr(tserver, "query_topk", broken)
    kw = dict(threshold=T, k=K, cache_size=0, use_kernel=True, max_retries=2,
              backoff_s=0.001)
    srv = (ContinuousRetrievalServer(index, workers=2, **kw) if server == "continuous"
           else RetrievalServer(index, **kw))
    with contextlib.closing(srv), pytest.raises(type(fault), match=str(fault)):
        srv.result(srv.submit(C[2]))
    assert calls == [True]
    assert srv.stats.retries == 0 and srv.stats.degraded == 0


def test_all_tiers_down_serves_stale_then_fails_on_miss(case):
    C, _, index = case
    srv = RetrievalServer(index, threshold=T, k=K, ttl_s=0.0, max_retries=0)
    warm = srv.result(srv.submit(C[4]))
    srv.fault_plan = StubFaults(errors=("serving.plain",))
    stale = srv.result(srv.submit(C[4]))
    miss = srv.result(srv.submit(C[5]))
    assert stale.status == "stale" and stale.cached
    np.testing.assert_array_equal(stale.indices, warm.indices)
    assert miss.status == "failed" and miss.count == 0
    assert srv.stats.stale == 1 and srv.stats.degraded == 2


@pytest.mark.parametrize("bad,match", [
    ("nan", "non-finite"), ("inf", "non-finite"), ("str", "not numeric"),
    ("complex", "not numeric"), ("dim", "query dim"),
])
def test_input_rejected(case, bad, match):
    _, _, index = case
    srv = RetrievalServer(index, threshold=T, k=K)
    q = np.zeros(index.m, np.float32)
    if bad == "nan":
        q[3] = np.nan
    elif bad == "inf":
        q[0] = -np.inf
    elif bad == "str":
        q = np.array(["x"] * index.m)
    elif bad == "complex":
        q = np.ones(index.m, np.complex64)
    else:
        q = np.zeros(index.m + 1, np.float32)
    with pytest.raises(ValueError, match=match):
        srv.submit(q)


def test_zero_and_integer_queries_are_served(case):
    C, _, index = case
    srv = RetrievalServer(index, threshold=T, k=K, normalize=True)
    zero = srv.result(srv.submit(np.zeros(index.m, np.float32)))
    assert zero.status == "ok" and zero.count == 0
    assert (zero.indices == -1).all() and not np.isnan(zero.values).any()
    q = (C[6] > 0).astype(np.int32)
    assert srv.result(srv.submit(q)).status == "ok"
    scaled = srv.result(srv.submit(C[6] * 7.5))  # normalize still applies
    _assert_result_is(scaled, C, C[6])


def test_continuous_slow_slot_sheds_late_keeps_exact():
    C, Q = _corpus_queries(96, 64, 0.15, 12, seed=8)
    index = build_index(C, block_rows=32, normalize=False, device="cpu")
    plan = StubFaults(delay_s=0.4)
    with ContinuousRetrievalServer(
        index, workers=1, threshold=0.2, k=4, max_batch=2, normalize=False,
        block_q=8, deadline_s=0.15, fault_plan=plan, cache_size=0,
    ) as srv:
        results = [srv.result(r, timeout_s=60) for r in [srv.submit(Q[i]) for i in range(12)]]
    assert plan.fired["delay"] == 1
    assert {"shed", "ok"} <= {r.status for r in results}
    for i, res in enumerate(results):
        if res.status == "ok":
            one = query_topk(index, Q[i][None], 0.2, 4, block_q=8)
            assert res.count == int(one.counts[0])
        else:
            assert res.count == 0


def test_continuous_many_workers_lose_no_update(case):
    """More workers than cores on a short switch interval: every request is
    answered exactly, once, and the counters add up."""
    import os
    import sys

    _, Q, index = case
    want = [query_topk(index, Q[i][None], T, K, block_q=8) for i in range(10)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ContinuousRetrievalServer(
            index, workers=2 * (os.cpu_count() or 4), threshold=T, k=K, max_batch=2,
            normalize=False, block_q=8, cache_size=4,
        ) as srv:
            rids = [srv.submit(Q[i % 10]) for i in range(120)]
            results = [srv.result(r, timeout_s=120) for r in rids]
    finally:
        sys.setswitchinterval(old)
    assert len(set(rids)) == 120
    st = srv.stats
    assert st.requests == 120 and st.degraded == st.retries == st.shed == 0
    assert sum(r.cached for r in results) == st.cache_hits
    for i, res in enumerate(results):
        assert res.status == "ok"
        np.testing.assert_array_equal(res.indices, want[i % 10].indices[0].numpy())


def test_continuous_unknown_rid_raises(case):
    _, Q, index = case
    with ContinuousRetrievalServer(index, workers=1, threshold=T, k=K, max_batch=2,
                                   normalize=False) as srv:
        rid = srv.submit(Q[0])
        srv.result(rid)
        with pytest.raises(KeyError):
            srv.result(rid + 999)


@pytest.mark.parametrize("server", ["step", "continuous"])
def test_launch_serve_retrieval_mode(server, capsys):
    from repro_torch.launch import serve

    report = serve.main([
        "--mode", "retrieval", "--corpus-n", "512", "--corpus-m", "256",
        "--requests", "24", "--batch", "8", "--block", "64", "--k", "4",
        "--server", server, "--device", "cpu",
    ])
    assert report["queries"] == 24 and report["ok"] == 24
    assert report["stats"]["degraded"] == 0 and report["matches"] > 0
    assert "QPS" in capsys.readouterr().out


def test_launch_serve_exits_nonzero_when_degraded(monkeypatch, capsys):
    """A run whose batches fell down the ladder reports, then fails."""
    from repro_torch.launch import serve

    def down(*args, **kw):
        raise RuntimeError("scoring unavailable")

    monkeypatch.setattr(tserver, "query_topk", down)
    with pytest.raises(SystemExit, match="retried or degraded"):
        serve.main([
            "--mode", "retrieval", "--corpus-n", "256", "--corpus-m", "128",
            "--requests", "8", "--batch", "8", "--block", "64", "--k", "4",
            "--server", "step", "--device", "cpu",
        ])
    assert "0 exact" in capsys.readouterr().out
