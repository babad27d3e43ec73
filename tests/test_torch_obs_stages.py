"""The stage spans inside ``query_topk`` and ``apss_blocked``, and their
scopes in a ``torch.profiler`` trace, on the CPU.

Under a ``Tracer`` and a CPU profiler each call opens exactly its stage
spans (``serving/query/{mask,worklist,score,fold}``, only ``fold`` around
the early-exit walk; ``core/apss_blocked/{prepare,score}`` on K1's path;
``core/apss_blocked/mask`` and
``kernels/apss_sparse/{worklist,support_gather,gather,score,fold}`` on the
sparse kernel path), kineto's host records hold the same names, and every
child lies inside its parent on both clocks. The kernel wrappers called on
their own open no ``core/apss_blocked`` span. With no ``Tracer`` a profiled
run holds none of them; with a ``Tracer`` and no profiler no
``record_function`` is entered.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import apss_blocked, similarity_topk  # noqa: E402
from repro_torch.core.sparse import from_dense  # noqa: E402
from repro_torch.kernels.apss_block import ops  # noqa: E402
from repro_torch.kernels.apss_block.sparse import apss_sparse_compacted  # noqa: E402
from repro_torch.obs import Tracer, trace  # noqa: E402
from repro_torch.serving import build_index, query_topk  # noqa: E402

T, K = 0.3, 8
QUERY = ["serving/query", "serving/query/mask", "serving/query/worklist",
         "serving/query/score", "serving/query/fold"]
QUERY_WALK = ["serving/query", "serving/query/mask", "serving/query/worklist",
              "serving/query/fold"]  # the walk scores and folds tile by tile
JOIN_DENSE = ["core/apss_blocked", "core/apss_blocked/prepare", "core/apss_blocked/score"]
SPARSE_KERNEL = [f"kernels/apss_sparse/{s}" for s in (
    "worklist", "support_gather", "gather", "score", "fold")]
JOIN_SPARSE = ["core/apss_blocked", "core/apss_blocked/mask"] + SPARSE_KERNEL
STAGED = set(QUERY + JOIN_DENSE + JOIN_SPARSE + ["kernels/apss_sparse/mask"])


def _clusters(n=300, m=64, seed=0):
    """Two clusters on disjoint features, rows L2-normalised: tiles across
    the clusters are pruned, so the masks hold dead tiles."""
    rng = np.random.default_rng(seed)
    D = np.zeros((n, m), np.float32)
    h = n // 2
    D[:h, : m // 2] = rng.random((h, m // 2)) * (rng.random((h, m // 2)) < 0.4)
    D[h:, m // 2:] = rng.random((n - h, m - m // 2)) * (rng.random((n - h, m - m // 2)) < 0.4)
    D[:, 0] += 1e-3  # no empty row
    return D / np.linalg.norm(D, axis=1, keepdims=True)


D = _clusters()


def _query(**kw):
    index = build_index(D, block_rows=32, device="cpu")
    return lambda: query_topk(index, D[:20] + 0.01, T, K, block_q=8, **kw)


def _sharded_query():
    index = build_index(D, block_rows=32, device="cpu", devices=["cpu"] * 3)
    return lambda: query_topk(index, D[:20] + 0.01, T, K, block_q=8)


def _sparse_index_query(**kw):
    index = build_index(from_dense(D, device="cpu"), block_rows=32, device="cpu")
    return lambda: query_topk(index, D[:20] + 0.01, T, K, block_q=8, **kw)


CASES = {
    "query_dense": (lambda: _query(), QUERY),
    "query_dense_early_exit": (lambda: _query(early_exit=True), QUERY_WALK),
    "query_dense_early_exit_k5": (lambda: _query(early_exit=True, use_kernel=True), QUERY),
    "query_sparse_index_early_exit": (
        lambda: _sparse_index_query(early_exit=True), QUERY_WALK),
    "query_sparse_index": (_sparse_index_query, QUERY),
    "query_sharded": (_sharded_query, QUERY),
    "join_dense_k1_plain": (
        lambda: (lambda: apss_blocked(D, T, K, use_kernel=True, device="cpu")), JOIN_DENSE),
    "join_sparse_compacted": (
        lambda: (lambda sp=from_dense(D, device="cpu"): apss_blocked(
            sp, T, K, use_kernel=True, device="cpu")), JOIN_SPARSE),
}


def _host_records(prof) -> list[tuple[str, int, int]]:
    """Kineto's host records of the staged names: ``(name, start, end)`` ns."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cpu and e.name() in STAGED]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with Tracer() as tr:
            fn()
    return tr, _host_records(prof)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_call_opens_exactly_its_stage_spans(case):
    make, names = CASES[case]
    fn = make()
    tr, records = _traced(fn)
    spans = [s for s in tr.walk() if s is not tr.root]
    assert [s.name for s in spans] == names
    (top,) = tr.root.children
    assert [c.name for c in top.children] == names[1:]  # the stages are the call's children
    assert all(not c.attrs for c in top.children)
    for c in top.children:
        assert top.t0 <= c.t0 <= c.t1 <= top.t1
    for a, b in zip(top.children, top.children[1:]):
        assert a.t1 <= b.t0
    # the profiler's trace holds the same names, each once, nested alike
    assert sorted(nm for nm, _, _ in records) == sorted(names)
    at = {nm: (a, b) for nm, a, b in records}
    parent = at[names[0]]
    for nm in names[1:]:
        a, b = at[nm]
        assert parent[0] <= a <= b <= parent[1], nm


def test_query_annotations_stay_on_the_call_span():
    tr, _ = _traced(_query(early_exit=True))
    (top,) = tr.root.children
    assert {"batch", "live_tiles", "total_tiles", "early_exit_skipped_tiles"} <= set(top.attrs)
    assert all(not c.attrs for c in top.children)
    assert [r.variant for r in top.records] == ["serving/query", "serving/early-exit"]


@pytest.mark.parametrize("case", ["query_dense", "join_dense_k1_plain", "join_sparse_compacted"])
def test_no_tracer_means_no_port_scope_in_a_profile(case):
    fn = CASES[case][0]()
    assert trace.span("serving/query") is trace.NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    assert _host_records(prof) == []


def test_tracer_without_a_profiler_enters_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    fns = [CASES[c][0]() for c in ("query_dense", "join_dense_k1_plain")]
    with Tracer() as tr:
        for fn in fns:
            fn()
    assert len([s for s in tr.walk() if s.name in STAGED]) == len(QUERY) + len(JOIN_DENSE)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]), Tracer():
        fns[0]()
    assert entered == QUERY  # the same seam, while the profiler records


def test_a_failing_span_closes_its_profiler_scope():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with Tracer() as tr:
            with pytest.raises(KeyError):
                with trace.span("serving/query"):
                    with trace.span("serving/query/mask"):
                        raise KeyError("x")
            with trace.span("serving/query/fold"):
                pass
    outer, fold = tr.root.children
    assert outer.status == "error" and outer.children[0].status == "error"
    names = [nm for nm, _, _ in sorted(_host_records(prof), key=lambda r: r[1])]
    assert names == ["serving/query", "serving/query/mask", "serving/query/fold"]
    assert not torch.autograd._profiler_enabled()


WRAPPERS = {
    "apss_fused": (lambda: ops.apss_fused(D, D, T, K, block_m=128, block_n=128, device="cpu"),
                   []),
    "similarity_topk_kernel": (  # K1 once a block pair in the distributed joins
        lambda: similarity_topk(D, D, T, K, use_kernel=True, exclude_self=True, device="cpu"),
        []),
    "apss_sparse_compacted": (
        lambda: apss_sparse_compacted(from_dense(D, device="cpu"), T, K, block_m=128,
                                      device="cpu"),
        ["kernels/apss_sparse/mask"] + SPARSE_KERNEL),
}


@pytest.mark.parametrize("case", sorted(WRAPPERS))
def test_kernel_wrappers_open_no_span_of_their_callers(case):
    fn, names = WRAPPERS[case]
    with Tracer() as tr:
        with trace.span("caller"):
            fn()
    (caller,) = tr.root.children
    assert [c.name for c in caller.children] == names
    assert caller.attrs == {}


@pytest.mark.parametrize("traced", [False, True])
def test_apss_blocked_takes_any_array_like(traced):
    rows = D[:40].tolist()  # no ``.shape``: converted by the path itself
    want = apss_blocked(np.asarray(rows, np.float32), T, K, use_kernel=True, device="cpu")
    if traced:
        with Tracer() as tr:
            got = apss_blocked(rows, T, K, use_kernel=True, device="cpu")
        assert tr.root.children[0].attrs == {}
    else:
        got = apss_blocked(rows, T, K, use_kernel=True, device="cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
