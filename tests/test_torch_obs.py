"""The port's observability modules (``repro_torch.obs``) on the CPU.

The reference's ``tests/test_obs.py`` cases that need no mesh: span-tree
shape and exception handling, the tracer's private telemetry log, the
disabled-path no-op, histogram accuracy, the registry absorbing telemetry
counters, Chrome-trace validity, metrics files, ring steps materialized
from a ``StepTicker``, and the flight recorder (a fault firing in the live
index, the bounded buffer, a checkpoint fallback). Then the same events
driven through both packages, on one fake clock: equal span trees, equal
Prometheus text and snapshots, and Chrome traces equal but for
``otherData.producer``. And the servers' events at the reference's points.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import MetricsRegistry as RRegistry  # noqa: E402
from repro.obs import Tracer as RTracer  # noqa: E402
from repro.obs import export as rexport  # noqa: E402
from repro.obs import metrics as rmetrics  # noqa: E402
from repro.obs import trace as rtrace  # noqa: E402
from repro_torch.distributed.straggler import StepTicker  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    FlightRecorder,
    MetricsRegistry,
    Tracer,
    export,
    metrics,
    recorder,
    trace,
)
from repro_torch.obs.metrics import Histogram  # noqa: E402
from repro_torch.planner import telemetry  # noqa: E402
from repro_torch.planner.telemetry import ApssStats  # noqa: E402


# -- span tree ----------------------------------------------------------------


def test_span_tree_nesting_shape():
    with Tracer() as tr:
        with trace.span("plan", autotune=False):
            with trace.span("inner", i=0):
                trace.event("mark", x=1)
            with trace.span("inner", i=1):
                pass
        with trace.span("execute"):
            trace.annotate(config="blocked")
    assert [s.name for s in tr.walk()] == ["trace", "plan", "inner", "inner", "execute"]
    plan, execute = tr.root.children
    assert [c.attrs["i"] for c in plan.children] == [0, 1]
    assert plan.children[0].events[0][1] == "mark"
    assert execute.attrs["config"] == "blocked"
    for s in tr.walk():
        assert s.t1 is not None and s.t1 >= s.t0
    assert plan.t1 <= execute.t0


def test_span_tree_survives_exceptions():
    with Tracer() as tr:
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("boom")
        with trace.span("after"):
            pass
    outer, after = tr.root.children
    assert outer.status == "error" and "boom" in outer.error
    (inner,) = outer.children
    assert inner.t1 is not None
    assert after.parent is tr.root


def test_tracer_enters_private_commlog():
    assert not telemetry.enabled()
    with Tracer() as tr:
        assert telemetry.enabled()
        with trace.span("call"):
            telemetry.record(ApssStats(variant="blocked/fused", n=8, m=8))
    assert not telemetry.enabled()
    (call,) = tr.root.children
    assert [r.variant for r in call.records] == ["blocked/fused"]


def test_disabled_span_is_shared_noop_singleton():
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", x=1) is trace.NULL_SPAN
    with trace.span("a") as s:
        assert s is None
    trace.event("nothing", x=1)
    trace.annotate(y=2)
    metrics.observe("serving.latency_s", 0.1)  # no registry: dropped
    recorder.trigger("no-op")


def test_no_sinks_means_no_records_on_the_live_index():
    """With no sink active the live index's spans are the shared no-op and
    it records nothing; under a tracer its ops land as spans with their
    delta-join records."""
    from repro_torch.serving import MutableAPSSIndex

    rng = np.random.default_rng(0)
    D = rng.normal(size=(40, 16)).astype(np.float32)
    mi = MutableAPSSIndex(D[:24], threshold=0.2, k=4, device="cpu")
    mi.append(D[24:])
    assert not telemetry.enabled() and not trace.enabled()
    with Tracer() as tr:
        mi.append(D[:8])
        mi.delete([0])
    append, delete = tr.root.children
    assert (append.name, append.attrs) == ("mutable/append", {"rows": 8})
    assert [r.variant for r in append.records] == ["serving/delta-join"]
    assert (delete.name, delete.attrs) == ("mutable/delete", {"rows": 1})


# -- histogram and registry ------------------------------------------------------


def test_histogram_quantiles_track_numpy():
    rng = np.random.default_rng(42)
    samples = rng.lognormal(mean=0.0, sigma=1.0, size=5000)
    h = Histogram()
    for v in samples:
        h.observe(float(v))
    for q in (0.5, 0.9, 0.95, 0.99):
        want = float(np.quantile(samples, q))
        assert abs(h.quantile(q) - want) / want < 0.15, q
    snap = h.snapshot()
    assert snap["count"] == 5000
    assert snap["min"] == pytest.approx(samples.min())
    assert snap["max"] == pytest.approx(samples.max())
    assert snap["mean"] == pytest.approx(samples.mean())


def test_histogram_edge_cases_and_merge():
    h = Histogram()
    assert math.isnan(h.quantile(0.5))
    h.observe(0.0)
    h.observe(-1.0)
    h.observe(2.0)
    assert h.count == 3 and h.zeros == 2
    assert h.quantile(0.0) == 0.0
    assert h.quantile(1.0) == pytest.approx(2.0, rel=0.19)
    g = Histogram()
    g.observe(4.0)
    h.merge(g)
    assert h.count == 4 and h.max == 4.0
    with pytest.raises(ValueError, match="bases"):
        h.merge(Histogram(base=2.0))


def test_registry_absorbs_telemetry_counters_and_derives_hit_rate():
    with MetricsRegistry() as reg:
        telemetry.incr("serving.requests", 4)
        telemetry.incr("serving.cache_hits")
        metrics.observe("serving.latency_s", 0.010)
        metrics.gauge("queue.depth", 3)
    snap = reg.snapshot()
    assert snap["counters"]["serving.requests"] == 4
    assert snap["derived"]["serving.cache_hit_rate"] == 0.25
    assert snap["gauges"]["queue.depth"] == 3
    assert snap["histograms"]["serving.latency_s"]["count"] == 1
    prom = reg.to_prometheus()
    assert "repro_serving_requests_total 4" in prom
    assert 'repro_serving_latency_s{quantile="0.99"}' in prom


# -- chrome trace export -----------------------------------------------------------


def test_chrome_trace_is_valid_and_monotonic(tmp_path):
    with Tracer() as tr:
        with trace.span("plan"):
            with trace.span("plan/inner"):
                trace.event("mark")
        with trace.span("serving/step", step=0):
            pass
    with MetricsRegistry() as reg:
        reg.incr("x")
    path = tmp_path / "trace.json"
    doc = export.write_chrome_trace(str(path), tr, reg)
    assert json.loads(path.read_text()) == doc
    events = doc["traceEvents"]
    for e in events:
        assert {"name", "ph", "pid", "tid"} <= e.keys()
        if e["ph"] in ("X", "i"):
            assert e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
    ts = [e["ts"] for e in events if e["ph"] in ("X", "i")]
    assert ts == sorted(ts)
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {"plan", "serving"}
    assert doc["otherData"]["metrics"]["counters"]["x"] == 1


def test_write_metrics_formats(tmp_path):
    with MetricsRegistry() as reg:
        reg.incr("a.b", 2)
    jpath = tmp_path / "m.json"
    export.write_metrics(str(jpath), reg)
    assert json.loads(jpath.read_text())["counters"]["a.b"] == 2
    ppath = tmp_path / "m.prom"
    export.write_metrics(str(ppath), reg)
    assert "repro_a_b_total 2" in ppath.read_text()


def test_trace_materializes_ring_steps_matching_ticker():
    """A record carrying a ``StepTicker`` becomes ``ring_step`` children of
    the span it fired in, whose extents are the ticker's step times, and
    the step-time and skew histograms land in the live registry."""
    with MetricsRegistry() as reg, Tracer() as tr:
        with trace.span("apss_2d"):
            ticker = StepTicker("cpu")
            for step in range(3):
                for rank in range(4):
                    ticker.emit(step, rank, None)
            telemetry.record(ApssStats(variant="2d/checkerboard", n=64, m=32, devices=4,
                                       step_ticker=ticker))
    (sp,) = tr.root.children
    steps = [c for c in sp.children if c.name == "ring_step"]
    assert [c.attrs["i"] for c in steps] == [0, 1, 2]
    assert all(c.attrs["ranks"] == 4 and c.attrs["variant"] == "2d/checkerboard"
               for c in steps)
    assert [c.duration_s for c in steps] == pytest.approx(ticker.step_times(), rel=1e-6)
    assert reg.histograms["sweep.step_time_s"].count == 3
    assert reg.histograms["sweep.step_skew_s"].count == 3


# -- flight recorder -----------------------------------------------------------------


def test_flight_recorder_dumps_on_injected_fault(tmp_path):
    """A kill fault firing in the live index freezes the lead-up: the
    spans of the ops before it are in the dump."""
    from repro_torch.robust import Fault, FaultPlan, SweepKilled
    from repro_torch.serving import MutableAPSSIndex

    rng = np.random.default_rng(5)
    D = rng.normal(size=(48, 16)).astype(np.float32)
    plan = FaultPlan([Fault("kill", scope="mutable.append", step=2)])
    with FlightRecorder(directory=str(tmp_path / "fr")) as fr, Tracer():
        mi = MutableAPSSIndex(D[:32], threshold=0.2, k=4, directory=str(tmp_path / "wal"),
                              fault_plan=plan, device="cpu")
        with pytest.raises(SweepKilled):
            mi.append(D[32:])
    assert plan.fired["kill:mutable.append"] == 1
    (reason, payload, path) = fr.dumps[0]
    assert reason == "fault:kill:mutable.append"
    assert payload["attrs"]["step"] == 2
    assert any(e["kind"] == "span" and e["name"] == "mutable/append" for e in payload["events"])
    assert json.loads(open(path).read())["reason"] == "fault:kill:mutable.append"


def test_flight_recorder_ring_buffer_bounded():
    with FlightRecorder(capacity=4) as fr:
        for i in range(10):
            recorder.note("event", f"e{i}")
        payload = fr.trigger("overflow-check")
    assert len(payload["events"]) == 4
    assert payload["events"][0]["name"] == "e6"


def test_recorder_triggers_on_checkpoint_corruption_fallback(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.robust import FaultPlan

    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"x": np.arange(8, dtype=np.float32)}
    mgr.save(state, step=1)
    mgr.save({"x": state["x"] + 1}, step=2)
    FaultPlan(seed=3).corrupt_file(str(tmp_path / "step_0000000002" / "x.npy"))
    with FlightRecorder() as fr, pytest.warns(UserWarning, match="falling back"):
        _, step = mgr.restore(like=state, fallback=True)
    assert step == 1
    assert [r for r, _, _ in fr.dumps] == ["checkpoint.corruption_fallback"]


# -- the same events through both packages --------------------------------------------


class _Clock:
    """A deterministic clock: each read advances by 1 ms."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _drive(Tracer_, trace_, Registry, metrics_, telemetry_incr):
    with Registry() as reg, Tracer_(clock=_Clock()) as tr:
        with trace_.span("serving/step", step=0):
            trace_.event("admit", rid=0)
            with trace_.span("serving/score", batch=2):
                trace_.annotate(tier="kernel")
            trace_.event("merge", batch=2)
        with pytest.raises(KeyError):
            with trace_.span("mutable/append", rows=3):
                with trace_.span("checkpoint/save", step=1):
                    raise KeyError("x")
        with trace_.span("mutable/delete", rows=1):
            trace_.event("degrade", tier="stale")
        for v in (0.001, 0.004, 0.02, 0.0):
            metrics_.observe("serving.latency_s", v)
        metrics_.gauge("queue.depth", 2)
        telemetry_incr("serving.requests", 4)
        telemetry_incr("serving.cache_hits")
    return tr, reg


def _both():
    from repro.planner import telemetry as rtelemetry

    return (_drive(Tracer, trace, MetricsRegistry, metrics, telemetry.incr),
            _drive(RTracer, rtrace, RRegistry, rmetrics, rtelemetry.incr))


def test_same_events_give_the_same_span_tree():
    (tr, _), (rtr, _) = _both()
    assert tr.as_dict() == rtr.as_dict()


def test_same_events_give_the_same_metrics():
    (_, reg), (_, rreg) = _both()
    assert reg.to_prometheus() == rreg.to_prometheus()
    assert reg.snapshot() == rreg.snapshot()


def test_same_events_give_the_same_chrome_trace():
    (tr, reg), (rtr, rreg) = _both()
    doc, rdoc = export.chrome_trace(tr, reg), rexport.chrome_trace(rtr, rreg)
    assert doc["otherData"].pop("producer") == "repro_torch.obs"
    assert rdoc["otherData"].pop("producer") == "repro.obs"
    assert doc == rdoc


# -- the servers' events ----------------------------------------------------------------


def test_server_events_at_the_reference_points():
    """A step server over a live index: admit, cache_hit, batch, merge and
    the serving/step and serving/score spans; a ladder that falls to the
    stale tier traces retry and degrade and dumps the flight recorder."""
    from repro_torch.robust import Fault, FaultPlan
    from repro_torch.serving import MutableAPSSIndex, RetrievalServer

    rng = np.random.default_rng(7)
    D = rng.normal(size=(40, 16)).astype(np.float32)
    mi = MutableAPSSIndex(D, threshold=0.2, k=4, device="cpu")
    srv = RetrievalServer(mi, threshold=0.2, k=4, max_batch=2, max_retries=1,
                          backoff_s=0.0)
    with MetricsRegistry() as reg, Tracer() as tr, FlightRecorder() as fr:
        srv.serve([D[0], D[1]])
        srv.serve([D[0]])  # a cache hit
        mi.append(D[:2])
        srv.fault_plan = FaultPlan([Fault("error", scope="serving.plain", times=9)])
        srv.serve([D[1]])
    names = [e[1] for s in tr.walk() for e in s.events]
    for name in ("admit", "batch", "merge", "cache_hit", "retry", "degrade"):
        assert name in names, name
    steps = [s for s in tr.walk() if s.name == "serving/step"]
    scores = [s for s in tr.walk() if s.name == "serving/score"]
    assert len(steps) == len(scores) == 2
    assert [s.attrs["tier"] for s in scores] == ["plain", "stale"]
    assert [r for r, _, _ in fr.dumps] == ["fault:error:serving.plain"] * 2 + [
        "serving.tier_down"]
    assert reg.histograms["serving.latency_s"].count == 4
    assert reg.histograms["serving.batch_occupancy"].count == 2
