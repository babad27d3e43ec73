"""The port's telemetry (``repro_torch.planner.telemetry``) against the JAX
package's, on the CPU.

The log's scoping and LIFO rule and the counter and record hooks; every
payload, FLOP and hop formula equal to the reference's over a parametrised
grid; the ``blocked/*`` and serving records of the same calls equal the
reference's field by field; the server counters of one shed, one retry
and one degrade scenario. The distributed records ride the rank fixtures
of ``test_torch_distributed*.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_dist import jax_mesh  # noqa: E402
from repro.core import apss as japss  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.planner import CommLog as JCommLog  # noqa: E402
from repro.planner import telemetry as jt  # noqa: E402
from repro.serving import build_index as jbuild  # noqa: E402
from repro.serving import query_topk as jquery  # noqa: E402
from repro_torch.core import apss as tapss  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.planner import CommLog  # noqa: E402
from repro_torch.planner import telemetry as tt  # noqa: E402
from repro_torch.serving import RetrievalServer, build_index, query_topk  # noqa: E402

T, K = 0.35, 16


def _dense(n=128, m=96, dens=0.3, seed=0):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < dens
    return D / np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)


def fields(r) -> dict:
    """A record of either package as comparable values (no ticker)."""
    out = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
           if f.name != "step_ticker"}
    out["hops"] = [dataclasses.asdict(h) for h in r.hops]
    return out


def assert_same_records(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = fields(g), fields(r)
        assert g.pop("flops") == pytest.approx(r.pop("flops"), rel=1e-12, abs=0)
        assert g == r


# -- the log and its hooks ------------------------------------------------------


def test_commlog_scoping_and_lifo():
    assert not tt.enabled() and tt.active() is None
    with CommLog() as outer:
        assert tt.enabled() and tt.active() is outer
        with CommLog() as inner:
            tt.record(tt.ApssStats(variant="x", n=1, m=1))
        assert tt.active() is outer
    assert not tt.enabled()
    assert [r.variant for r in outer.records] == ["x"] == [r.variant for r in inner.records]
    assert outer.last is outer.records[-1] and outer.by_variant("x") == outer.records
    with pytest.raises(ValueError, match="empty"):
        CommLog().last
    a, b = CommLog(), CommLog()
    a.__enter__()
    b.__enter__()
    with pytest.raises(RuntimeError, match="LIFO"):
        a.__exit__(None, None, None)
    b.__exit__(None, None, None)
    a.__exit__(None, None, None)
    assert not tt.enabled()


def test_counters_and_hooks_scope_to_active_logs():
    seen_counts, seen_records = [], []

    def on_count(name, n):
        seen_counts.append((name, n))

    tt.add_counter_hook(on_count)
    tt.add_record_hook(seen_records.append)
    try:
        tt.incr("x.y")  # no active log: no-op for logs, hooks still fire
        with CommLog() as outer:
            with CommLog() as inner:
                tt.incr("x.y", 2)
            tt.incr("x.y")
            tt.record(tt.ApssStats(variant="v", n=2, m=2))
    finally:
        tt.remove_counter_hook(on_count)
        tt.remove_record_hook(seen_records.append)
    assert inner.counters["x.y"] == 2 and outer.counters["x.y"] == 3
    assert seen_counts == [("x.y", 1), ("x.y", 2), ("x.y", 1)]
    assert [r.variant for r in seen_records] == ["v"]
    tt.incr("x.y")
    assert len(seen_counts) == 3  # removed hooks hear nothing


def test_record_properties_equal_reference():
    hops = (("ppermute", "dense_block", "data", 100, 3), ("psum", "scores", "model", 7, 2))
    kw = dict(variant="v", n=8, m=4, hops=None, live_tiles=3, total_tiles=8,
              tile_counts=(0, 1, 2))
    got = tt.ApssStats(**{**kw, "hops": tuple(tt.CollectiveHop(*h) for h in hops)})
    ref = jt.ApssStats(**{**kw, "hops": tuple(jt.CollectiveHop(*h) for h in hops)})
    for name in ("wire_bytes", "hop_count", "live_fraction", "imbalance", "step_times"):
        assert getattr(got, name) == getattr(ref, name)
    assert got.bytes_by_payload() == ref.bytes_by_payload()
    assert got.bytes_by_op() == ref.bytes_by_op()
    empty = tt.ApssStats(variant="v", n=1, m=1, tile_counts=(0, 0))
    assert empty.imbalance == 1.0 and empty.live_fraction is None


# -- every formula, against the reference's -----------------------------------------


@pytest.mark.parametrize("rows, cols, m, cap, k", [
    (1, 1, 1, 1, 1), (32, 128, 96, 24, 16), (1792, 7168, 136448, 661, 32), (7, 3, 5, 2, 100),
])
def test_payload_and_flop_formulas_equal_reference(rows, cols, m, cap, k):
    for name, args in [
        ("dense_block_bytes", (rows, m)), ("dense_block_bytes", (rows, m, 2)),
        ("csr_block_bytes", (rows, cap)), ("csr_cell_bytes", (rows, cap)),
        ("matches_bytes", (rows, k)), ("dense_join_flops", (rows, cols, m)),
        ("sparse_join_flops", (rows, cols, cap)), ("delta_join_flops", (rows, cols, 2.5)),
    ]:
        assert getattr(tt, name)(*args) == getattr(jt, name)(*args), name


def _same_hops(got, ref):
    assert [dataclasses.asdict(h) for h in got] == [dataclasses.asdict(h) for h in ref]


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("schedule", ["allgather", "ring", "halfring"])
@pytest.mark.parametrize("payload", ["dense_block", "csr_block"])
def test_horizontal_hops_equal_reference(p, schedule, payload):
    args = (schedule, p, "data", 128 * 96 * 4, tt.matches_bytes(32, 16))
    _same_hops(tt.horizontal_hops(*args, payload=payload),
               jt.horizontal_hops(*args, payload=payload))


def test_unknown_schedules_raise_as_reference():
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="unknown horizontal"):
            mod.horizontal_hops("tree", 4, "data", 1, 1)
        with pytest.raises(ValueError, match="unknown vertical"):
            mod.vertical_hops("tree", "model", 4, 128, 32, 64)


@pytest.mark.parametrize("sizes", [(2,), (2, 2), (2, 4), (4, 2), (1, 4), (2, 2, 2)])
def test_hierarchical_hops_equal_reference(sizes):
    axes = ("pod", "data", "x")[:len(sizes)]
    _same_hops(tt.hierarchical_hops(sizes, axes, 1000), jt.hierarchical_hops(sizes, axes, 1000))
    _same_hops(tt.hierarchical_hops(sizes, axes, 77, payload="csr_block"),
               jt.hierarchical_hops(sizes, axes, 77, payload="csr_block"))


@pytest.mark.parametrize("acc", ["allreduce", "scatter", "compressed", "recursive"])
@pytest.mark.parametrize("p, n, block_rows, cap", [
    (1, 128, 32, 64), (2, 128, 32, 64), (4, 128, 32, 128), (8, 7168, 512, 6883), (3, 99, 33, 4),
])
def test_vertical_hops_equal_reference(acc, p, n, block_rows, cap):
    args = (acc, "model", p, n, block_rows, cap)
    _same_hops(tt.vertical_hops(*args), jt.vertical_hops(*args))
    _same_hops(tt.vertical_hops(*args, cols=n // 2), jt.vertical_hops(*args, cols=n // 2))


@pytest.mark.parametrize("acc", ["allreduce", "compressed"])
@pytest.mark.parametrize("q, r, n_loc, m, itemsize, bs, cap, cap_loc", [
    (2, 2, 64, 96, 4, 16, 128, None), (2, 2, 64, 96, 4, 16, 128, 11),
    (4, 2, 32, 1024, 2, 16, 64, None), (1, 4, 128, 96, 4, 32, 64, 5),
    (2, 2, 3584, 136448, 4, 512, 3584, 331),
])
def test_twod_hops_equal_reference(acc, q, r, n_loc, m, itemsize, bs, cap, cap_loc):
    args = (q, r, "data", "model", n_loc, m, itemsize, bs, cap, acc)
    _same_hops(tt.twod_hops(*args, cap_loc=cap_loc), jt.twod_hops(*args, cap_loc=cap_loc))


# -- the self-join's records --------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_prune_stats", [False, True])
def test_blocked_records_equal_reference(kind, use_kernel, with_prune_stats):
    """Same call, same record: the variant name (``blocked/dense-xla`` is
    the port's plain path), live tiles where a mask exists, FLOPs scaled
    by the live fraction on the kernel paths. The port's kernels run their
    plain versions on the CPU; the reference's kernel paths run Pallas in
    interpret mode."""
    D = _dense(96, 64, 0.1, seed=4)
    kw = dict(block_rows=32, use_kernel=use_kernel, with_prune_stats=with_prune_stats)
    if kind == "dense":
        got_in, ref_in = D, jnp.asarray(D)
    else:
        got_in, ref_in = tsparse.from_dense(D, device="cpu"), jsparse.from_dense(jnp.asarray(D))
    with CommLog() as got:
        tapss.apss_blocked(got_in, 0.5, K, device="cpu", **kw)
    with JCommLog() as ref:
        japss.apss_blocked(ref_in, 0.5, K, **kw)
    assert_same_records(got.records, ref.records)
    assert got.last.step_times is None  # no ticker on the blocked path


def test_no_log_no_record_and_no_cost():
    D = _dense(64, 32, seed=1)
    assert not tt.enabled()
    tapss.apss_blocked(D, 0.5, K, block_rows=32, device="cpu")
    with CommLog() as log:
        pass
    assert log.records == []


# -- the serving records ----------------------------------------------------------


def _corpus_queries(seed=5):
    C = _dense(256, 96, 0.12, seed=seed)
    Q = _dense(10, 96, 0.12, seed=seed + 1)
    return C, Q


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("early_exit", [False, True])
def test_query_records_equal_reference(kind, early_exit):
    C, Q = _corpus_queries()
    corpus = C if kind == "dense" else tsparse.from_dense(C, device="cpu")
    jcorpus = C if kind == "dense" else jsparse.from_dense(jnp.asarray(C))
    index = build_index(corpus, block_rows=64, normalize=False, device="cpu")
    jindex = jbuild(jcorpus, block_rows=64, normalize=False)
    kw = dict(block_q=8, early_exit=early_exit)
    with CommLog() as got:
        query_topk(index, Q, 0.3, K, **kw)
    with JCommLog() as ref:
        jquery(jindex, jnp.asarray(Q), 0.3, K, **kw)
    assert_same_records(got.records, ref.records)
    want = ["serving/query"] + (["serving/early-exit"] if early_exit else [])
    assert [r.variant for r in got.records] == want
    assert got.records[0].total_tiles == 2 * 4 and got.records[0].extra["batch"] == 10


def test_query_with_no_live_tile_records_no_early_exit():
    C, Q = _corpus_queries()
    index = build_index(C, block_rows=64, normalize=False, device="cpu")
    jindex = jbuild(C, block_rows=64, normalize=False)
    with CommLog() as got:
        query_topk(index, Q, 100.0, K, block_q=8, early_exit=True)
    with JCommLog() as ref:
        jquery(jindex, jnp.asarray(Q), 100.0, K, block_q=8, early_exit=True)
    assert_same_records(got.records, ref.records)
    assert got.last.live_tiles == 0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("p", [2, 4])
def test_sharded_query_records_equal_reference(kind, p):
    from repro_torch.serving.index import build_index as tbuild

    C, Q = _corpus_queries(seed=9)
    corpus = C if kind == "dense" else tsparse.from_dense(C, device="cpu")
    jcorpus = C if kind == "dense" else jsparse.from_dense(jnp.asarray(C))
    index = tbuild(corpus, block_rows=32, normalize=False, device="cpu", devices=["cpu"] * p)
    jindex = jbuild(jcorpus, block_rows=32, normalize=False, mesh=jax_mesh((p,), ("data",)))
    with CommLog() as got:
        query_topk(index, Q, 0.3, K, block_q=8)
    with JCommLog() as ref:
        jquery(jindex, jnp.asarray(Q), 0.3, K, block_q=8)
    assert_same_records(got.records, ref.records)
    assert got.last.variant == "serving/query-sharded" and len(got.last.tile_counts) == p


def test_plan_records_its_decision_as_reference():
    from repro.planner.costmodel import plan_query_topk as jplan
    from repro_torch.planner.costmodel import plan_query_topk as tplan

    C, _ = _corpus_queries()
    index = build_index(C, block_rows=64, normalize=False, device="cpu")
    jindex = jbuild(C, block_rows=64, normalize=False)
    with CommLog() as got:
        tplan(index, 10, 0.3, K)
    with JCommLog() as ref:
        jplan(jindex, 10, 0.3, K)
    g, r = fields(got.last), fields(ref.last)
    gp, rp = g["extra"].pop("plan"), r["extra"].pop("plan")
    assert gp.pop("predicted_us") == pytest.approx(rp.pop("predicted_us"), rel=1e-12)
    assert g == r and gp == rp and got.last.variant == "serving/plan"


# -- the server's counters ----------------------------------------------------------


class Faults:
    """``fail_point`` raises for the scopes in ``errors``, ``times`` firings
    each (-1: always); ``delay`` does nothing."""

    def __init__(self, errors=(), times=-1):
        self.left = {scope: times for scope in errors}

    def fail_point(self, scope):
        if self.left.get(scope, 0) != 0:
            self.left[scope] -= 1
            raise RuntimeError(f"injected error in {scope}")

    def delay(self, scope, step=None):
        pass


@pytest.fixture(scope="module")
def served():
    C, Q = _corpus_queries(seed=13)
    return Q, build_index(C, block_rows=64, normalize=False, device="cpu")


def _counters(log):
    return {k: v for k, v in log.counters.items() if k.startswith("serving.")}


def test_server_counts_requests_hits_and_sheds(served):
    Q, index = served
    srv = RetrievalServer(index, threshold=0.3, k=K, max_batch=4, max_pending=2,
                          normalize=False)
    with CommLog() as log:
        rids = [srv.submit(q) for q in Q[:3]]  # the third is shed at admission
        results = [srv.result(r) for r in rids]
        srv.submit(Q[0])  # a cache hit
    assert [r.status for r in results] == ["ok", "ok", "shed"]
    assert _counters(log) == {"serving.requests": 4, "serving.shed": 1,
                              "serving.cache_hits": 1}
    assert srv.stats.shed == 1 and srv.stats.cache_hits == 1
    assert [r.variant for r in log.records] == ["serving/query"]


def test_server_counts_retries(served):
    Q, index = served
    srv = RetrievalServer(index, threshold=0.3, k=K, max_batch=4, max_retries=2,
                          backoff_s=0.0, fault_plan=Faults(["serving.plain"], times=1),
                          normalize=False)
    with CommLog() as log:
        res = srv.serve(list(Q[:2]))
    assert all(r.status == "ok" for r in res)
    assert _counters(log) == {"serving.requests": 2, "serving.retries": 1}
    assert srv.stats.retries == 1


def test_server_counts_degrades_and_stale_answers(served):
    Q, index = served
    faults = Faults()
    srv = RetrievalServer(index, threshold=0.3, k=K, max_batch=4, max_retries=0,
                          backoff_s=0.0, ttl_s=0.0, use_kernel=True, fault_plan=faults,
                          normalize=False)
    faults.left = {"serving.kernel": -1}
    with CommLog() as first:
        ok = srv.serve([Q[0]])  # kernel tier down: served by the plain tier
    faults.left = {"serving.kernel": -1, "serving.plain": -1}
    with CommLog() as second:
        late = srv.serve([Q[0], Q[1]])  # every tier down: one stale answer, one failure
    assert ok[0].status == "ok"
    assert _counters(first) == {"serving.requests": 1, "serving.degraded": 1}
    assert [r.status for r in late] == ["stale", "failed"]
    assert _counters(second) == {"serving.requests": 2, "serving.degraded": 1,
                                 "serving.stale": 1}
    assert srv.stats.degraded == 2 and srv.stats.stale == 1
