"""The spans and metrics wired into the port's entry points, against the
reference's on the same inputs, and ``launch/serve.py``'s chaos, trace and
metrics flags, on the CPU.

Each case runs one call of both packages under a tracer and a metrics
registry and compares the spans the reference opens there (names and
attributes, annotations included, in tree order) and the metrics it
writes (``serving.live_tile_fraction`` snapshots,
``serving.early_exit_skipped_tiles`` counts):

- ``query_topk`` on a dense and a CSR index, with and without the kernel
  tier (the reference's in Pallas interpret mode), on a sharded index
  (``shards``) and under early exit. The port skips a tile strictly (k-th
  > bound) and the reference at ≥ (ROADMAP, deliberate differences), so
  the early-exit input has no tie at any row's k-th value: random values,
  checked below;
- ``plan_apss`` (``plan`` with ``chosen`` and ``candidates``) and
  ``Plan.run`` (``execute``), and ``apss(distribution="auto")`` (``apss``
  around both).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_dist import jax_mesh  # noqa: E402
from repro.core.distributed import apss as rapss  # noqa: E402
from repro.core.sparse import from_dense as rfrom_dense  # noqa: E402
from repro.obs import MetricsRegistry as RRegistry  # noqa: E402
from repro.obs import Tracer as RTracer  # noqa: E402
from repro.planner import costmodel as rcost  # noqa: E402
from repro.planner.plan import plan_apss as rplan  # noqa: E402
from repro.serving import build_index as rbuild  # noqa: E402
from repro.serving import query_topk as rquery  # noqa: E402
from repro_torch.core.distributed import apss  # noqa: E402
from repro_torch.core.sparse import from_dense  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.planner import costmodel  # noqa: E402
from repro_torch.planner.plan import plan_apss  # noqa: E402
from repro_torch.serving import build_index, query_topk  # noqa: E402

T, K = 0.35, 16
WIRED = ("serving/query", "plan", "execute", "apss")


def _corpus(n, m, seed, dens=0.3):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < dens
    return D / np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)


def _observed(tracer_cls, registry_cls, fn):
    """The wired spans ``(name, attrs)`` in tree order and the metrics
    snapshot of one call of ``fn``."""
    with registry_cls() as reg, tracer_cls() as tr:
        fn()
    spans = [(s.name, dict(s.attrs)) for s in tr.walk() if s.name in WIRED]
    return spans, reg.snapshot()


def _both(port_fn, ref_fn):
    got = _observed(Tracer, MetricsRegistry, port_fn)
    ref = _observed(RTracer, RRegistry, ref_fn)
    return got, ref


def _serving_metrics(snap) -> dict:
    return {"fraction": snap["histograms"].get("serving.live_tile_fraction"),
            "skipped": snap["counters"].get("serving.early_exit_skipped_tiles")}


@pytest.mark.parametrize("kind,use_kernel", [("dense", False), ("dense", True),
                                             ("sparse", False)])
def test_query_span_and_live_fraction_are_the_references(kind, use_kernel):
    C, Q = _clusters(range(0, 120, 6))  # 20 queries of the first cluster
    corpus = C if kind == "dense" else from_dense(C, device="cpu")
    rcorpus = C if kind == "dense" else rfrom_dense(jnp.asarray(C))
    index = build_index(corpus, block_rows=64, normalize=False, device="cpu")
    rindex = rbuild(rcorpus, block_rows=64, normalize=False)
    (spans, snap), (rspans, rsnap) = _both(
        lambda: query_topk(index, Q, T, K, block_q=8, use_kernel=use_kernel),
        lambda: rquery(rindex, jnp.asarray(Q), T, K, block_q=8, use_kernel=use_kernel))
    assert spans == rspans
    (name, attrs), = spans
    assert name == "serving/query" and attrs["use_kernel"] is use_kernel
    assert attrs["batch"] == 20 and attrs["total_tiles"] == 12
    assert attrs["live_tiles"] == 6  # the other cluster's corpus blocks are pruned
    assert _serving_metrics(snap) == _serving_metrics(rsnap)
    assert snap["histograms"]["serving.live_tile_fraction"]["count"] == 1


def test_sharded_query_annotates_its_shards():
    C, Q = _clusters((1, 40, 130, 200))
    index = build_index(C, block_rows=32, normalize=False, device="cpu", devices=["cpu"] * 4)
    rindex = rbuild(C, block_rows=32, normalize=False, mesh=jax_mesh((4,), ("data",)))
    (spans, snap), (rspans, rsnap) = _both(
        lambda: query_topk(index, Q, T, K, block_q=8),
        lambda: rquery(rindex, jnp.asarray(Q), T, K, block_q=8))
    assert spans == rspans and spans[0][1]["shards"] == 4
    assert _serving_metrics(snap) == _serving_metrics(rsnap)


def _clusters(rows=(3, 70, 9)):
    """Two clusters of random rows on disjoint features plus one shared,
    weak feature, and queries near the given rows: cross-cluster tiles
    stay live at a small threshold (small bounds) but lose to the
    within-cluster top-k, so early exit skips them; at ``T`` they are
    pruned."""
    rng = np.random.default_rng(11)
    m = 64
    C = np.zeros((256, m), np.float32)
    C[:128, :31] = rng.random((128, 31))
    C[128:, 32:63] = rng.random((128, 31))
    C[:, 63] = 0.05 * rng.random(256)
    Q = C[list(rows)] + 0.01 * rng.random((len(rows), m)).astype(np.float32)
    norm = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
    return norm(C).astype(np.float32), norm(Q).astype(np.float32)


def test_early_exit_skipped_tiles_are_the_references():
    C, Q = _clusters()
    k = 4
    kth = np.sort(Q.astype(np.float64) @ C.T.astype(np.float64), axis=1)[:, -k:]
    assert (np.diff(kth, axis=1) > 1e-6).all()  # no tie at any row's k-th value
    index = build_index(C, block_rows=32, normalize=False, device="cpu")
    rindex = rbuild(C, block_rows=32, normalize=False)
    (spans, snap), (rspans, rsnap) = _both(
        lambda: query_topk(index, Q, 0.01, k, block_q=8, early_exit=True),
        lambda: rquery(rindex, jnp.asarray(Q), 0.01, k, block_q=8, early_exit=True))
    assert spans == rspans
    assert spans[0][1]["early_exit_skipped_tiles"] > 0
    assert _serving_metrics(snap) == _serving_metrics(rsnap)
    assert snap["counters"]["serving.early_exit_skipped_tiles"] > 0


def test_plan_execute_and_apss_spans_are_the_references():
    D = _corpus(128, 96, seed=0)
    kw = dict(include_kernel=False, block_rows_choices=(32, 64))
    (spans, _), (rspans, _) = _both(
        lambda: plan_apss(D, T, K, None, profile=costmodel.default_profile(), device="cpu",
                          **kw).run(),
        lambda: rplan(D, T, K, None, profile=rcost.default_profile(), **kw).run())
    assert spans == rspans
    assert [n for n, _ in spans] == ["plan", "execute"]
    assert spans[0][1]["autotune"] is False and spans[0][1]["candidates"] > 1
    assert spans[1][1]["config"] == spans[0][1]["chosen"]
    (spans, _), (rspans, _) = _both(
        lambda: apss(D, T, K, None, distribution="auto", profile=costmodel.default_profile(),
                     device="cpu", **kw),
        lambda: rapss(D, T, K, None, distribution="auto", profile=rcost.default_profile(),
                      **kw))
    assert spans == rspans
    assert [n for n, _ in spans] == ["apss", "plan", "execute"]
    assert spans[0][1] == {"distribution": "auto"}


def test_no_sink_means_no_span_and_no_metric():
    C, Q = _corpus(128, 64, seed=1), _corpus(4, 64, seed=2)
    index = build_index(C, block_rows=32, normalize=False, device="cpu")
    with MetricsRegistry() as reg:
        query_topk(index, Q, T, K, block_q=8)
    assert "serving.live_tile_fraction" in reg.snapshot()["histograms"]
    with Tracer() as tr:
        pass
    query_topk(index, Q, T, K, block_q=8)  # neither active: nothing recorded anywhere
    assert [s.name for s in tr.walk()] == ["trace"]
    assert reg.snapshot()["histograms"]["serving.live_tile_fraction"]["count"] == 1


def test_serve_chaos_lane_writes_trace_and_metrics(tmp_path):
    """``--chaos --trace-out --metrics-out`` on the CPU: injected faults
    fire (delays and transient errors of the plain tier, the one that runs
    here), every answer equals one-shot ``query_topk``, and both files
    parse with the serving spans and the live-tile histogram."""
    from repro_torch.launch import serve

    trace_path, metrics_path = tmp_path / "trace.json", tmp_path / "metrics.json"
    report = serve.main(["--mode", "retrieval", "--device", "cpu", "--corpus-n", "1024",
                         "--corpus-m", "512", "--requests", "32", "--chaos",
                         "--trace-out", str(trace_path), "--metrics-out", str(metrics_path)])
    assert report["fired"]["error:serving.plain"] == 2
    assert report["differ"] == [] and report["ok"] == 32
    assert report["stats"]["retries"] == 2
    events = json.loads(trace_path.read_text())["traceEvents"]
    assert any(e.get("name") == "serving/query" for e in events)
    snap = json.loads(metrics_path.read_text())
    assert snap["histograms"]["serving.live_tile_fraction"]["count"] > 0
    assert snap["counters"]["serving.retries"] == 2
