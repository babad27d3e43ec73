"""The port's drift detection (``repro_torch.obs.drift``) against the
reference's (``tests/test_obs.py``'s drift cases) on the CPU.

The same records priced by the same profile give the same predictions in
both packages (every schedule family: blocked, overlapped rings, the
sequential vertical, sparse, ranks, imbalance); the same residuals give the
same report (``as_dict`` equal); the trace join pins one residual to each
record of a traced span, on a fake clock and over a traced
``plan_apss(...).run()``, whose residuals predict what the reference's do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.apss import normalize_rows  # noqa: E402
from repro.obs import Tracer as RTracer  # noqa: E402
from repro.obs import drift as rdrift  # noqa: E402
from repro.planner import costmodel as rcost  # noqa: E402
from repro.planner import telemetry as rtelemetry  # noqa: E402
from repro.planner.plan import plan_apss as rplan  # noqa: E402
from repro_torch.obs import Tracer, drift, trace  # noqa: E402
from repro_torch.planner import costmodel, telemetry  # noqa: E402
from repro_torch.planner.plan import plan_apss  # noqa: E402

T, K = 0.35, 16


def _dense(n=128, m=96, dens=0.3, seed=0):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < dens
    return np.asarray(normalize_rows(jnp.asarray(D)))


def _stats(tm, variant="blocked/fused", flops=4e9, wire=0, hops=0, **kw):
    """One record of the telemetry module ``tm`` (either package's)."""
    hop = ((tm.CollectiveHop(op="ppermute", payload="dense_block", axis="data",
                             bytes_per_hop=wire // max(hops, 1), hops=hops),)
           if hops else ())
    return tm.ApssStats(variant=variant, n=1024, m=1024, flops=flops, hops=hop, **kw)


CASES = [
    dict(),
    dict(variant="horizontal/ring", flops=40e9, wire=4_000_000_000, hops=4),
    dict(variant="horizontal/halfring", flops=1e9, wire=4_000_000_000, hops=2, devices=4),
    dict(variant="vertical/allreduce", flops=40e9, wire=4_000_000_000, hops=4),
    dict(variant="2d/checkerboard", flops=3e9, wire=1_000_000, hops=3, devices=4,
         tile_counts=(3, 1, 2, 2)),
    dict(variant="blocked/sparse", flops=2e8, sparse=True),
    dict(variant="hierarchical/ring", flops=5e9, wire=8_000_000, hops=6, devices=8,
         sparse=True, tile_counts=(4, 4, 1, 7)),
]
PROFILE = dict(device_kind="test", matmul_gflops=40.0, gather_gflops=3.0,
               sharded_matmul_gflops=11.0, collective_gbps=2.5,
               collective_latency_us=30.0, overhead_us=120.0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.get("variant", "blocked/fused"))
def test_predict_seconds_equals_the_reference(case):
    got = drift.predict_seconds(_stats(telemetry, **case), costmodel.CalibrationProfile(**PROFILE))
    ref = rdrift.predict_seconds(_stats(rtelemetry, **case), rcost.CalibrationProfile(**PROFILE))
    assert got == pytest.approx(ref, rel=1e-12, abs=0)


def test_predict_seconds_matches_profile_arithmetic():
    prof = costmodel.CalibrationProfile(matmul_gflops=40.0, overhead_us=0.0)
    assert drift.predict_seconds(_stats(telemetry, flops=40e9), prof) == pytest.approx(1.0)
    ring = _stats(telemetry, variant="horizontal/ring", flops=40e9, wire=4_000_000_000, hops=4)
    seq = _stats(telemetry, variant="vertical/allreduce", flops=40e9, wire=4_000_000_000,
                 hops=4)
    # overlapped schedules take max(compute, comm), sequential ones add
    assert drift.predict_seconds(seq, prof) > drift.predict_seconds(ring, prof)


@pytest.mark.parametrize("gflops,stale", [(40.0, False), (4000.0, True), (0.2, True)])
def test_drift_report_equals_the_reference(gflops, stale):
    """A profile whose throughput rotted by 100x (either way) is stale and
    names the worst variants and the port's recalibration entry point; the
    honest one stays fresh; every other field is the reference's."""
    flops = (10e9, 20e9, 40e9, 5e9)
    measured = [f / 40e9 for f in flops]  # truth at 40 GF/s
    variants = ["blocked/fused", "blocked/fused", "horizontal/ring", "blocked/sparse"]

    def report(pkg, tm, prof):
        profile = prof.CalibrationProfile(matmul_gflops=gflops, overhead_us=0.0,
                                          device_kind="test")
        res = [pkg.Residual(variant=v, measured_s=m,
                            predicted_s=pkg.predict_seconds(_stats(tm, v, f), profile))
               for v, f, m in zip(variants, flops, measured)]
        return pkg.drift_report(res, profile=profile)

    got = report(drift, telemetry, costmodel)
    ref = report(rdrift, rtelemetry, rcost)
    assert got.stale is stale
    g, r = got.as_dict(), ref.as_dict()
    assert g.pop("recommendation") == r.pop("recommendation").replace(
        "repro.planner.calibrate", "repro_torch.planner.calibrate")
    assert g == r
    assert got.describe() == ref.describe().replace(
        "repro.planner.calibrate", "repro_torch.planner.calibrate")
    if stale:
        assert "repro_torch.planner.calibrate.calibrate" in got.recommendation
        assert "STALE" in got.describe()
    empty = drift.drift_report([])
    assert not empty.stale and empty.median_ratio == 1.0 and empty.profile_kind == "unknown"


def test_residuals_from_trace_joins_records_to_spans():
    clock = iter(np.arange(0.0, 100.0, 0.5))
    with Tracer(clock=lambda: float(next(clock))) as tr:
        with trace.span("execute"):
            telemetry.record(_stats(telemetry, flops=40e9))
            telemetry.record(_stats(telemetry, variant="blocked/sparse", flops=40e9))
    prof = costmodel.CalibrationProfile(matmul_gflops=40.0, overhead_us=0.0)
    a, b = drift.residuals_from_trace(tr, prof)
    assert (a.variant, b.variant) == ("blocked/fused", "blocked/sparse")
    assert a.predicted_s == pytest.approx(1.0)
    assert a.measured_s == b.measured_s == pytest.approx(0.25)  # one step, two records
    assert a.source == "trace"


def test_residuals_from_estimates_skip_unmeasured():
    prof = costmodel.default_profile()
    plan = plan_apss(_dense(64, 64, seed=9), T, K, None, include_kernel=False, profile=prof,
                     device="cpu")
    assert drift.residuals_from_estimates(plan.estimates) == []
    plan.estimates[0].measured_s = plan.estimates[0].total_s * 2
    (res,) = drift.residuals_from_estimates(plan.estimates)
    assert res.ratio == pytest.approx(2.0)
    assert res.source == "estimate" and res.variant == plan.estimates[0].config.name


def test_residuals_from_a_traced_planned_run_are_the_references():
    """One residual per record of a traced ``plan_apss(...).run()``, each
    pinned to the ``execute`` span, predicting what the reference's
    residuals predict for the same run."""
    D = _dense()
    kw = dict(include_kernel=False, block_rows_choices=(32, 64))
    with Tracer() as tr:
        plan_apss(D, T, K, None, profile=costmodel.default_profile(), device="cpu", **kw).run()
    with RTracer() as rtr:
        rplan(D, T, K, None, profile=rcost.default_profile(), **kw).run()
    records = [(sp.name, r.variant) for sp in tr.walk() for r in sp.records]
    got = drift.residuals_from_trace(tr, costmodel.default_profile())
    ref = rdrift.residuals_from_trace(rtr, rcost.default_profile())
    assert records and {name for name, _ in records} == {"execute"}
    assert [r.variant for r in got] == [v for _, v in records] == [r.variant for r in ref]
    assert [r.predicted_s for r in got] == pytest.approx([r.predicted_s for r in ref],
                                                         rel=1e-12, abs=0)
    assert all(r.measured_s > 0 and r.source == "trace" for r in got)


def test_rank_runs_return_drift_residuals(tmp_path):
    """``launch.apss_mesh.run_variants`` given a profile traces each
    variant's first run in the ranks and returns one residual per record of
    the rank, measured by the ``apss`` span, priced as ``predict_seconds``
    prices the record."""
    from _torch_dist import JOIN_TIMEOUT_S, PG_TIMEOUT_S, variant
    from repro_torch.launch.mesh import spawn

    np.save(tmp_path / "c.npy", _dense(256, 64, seed=2))
    prof = costmodel.default_profile()
    (rec,) = (r["ring"] for r in spawn(
        "repro_torch.launch.apss_mesh:run_variants", 2, {"dense": str(tmp_path / "c.npy")},
        [variant("ring", "horizontal", (2,), ("data",), gather="data", schedule="ring")],
        T, K, 1, prof, device="cpu", threads=1, run_dir=str(tmp_path),
        pg_timeout=PG_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S)[:1])
    (res,), (r,) = rec["residuals"], rec["records"]
    assert res["variant"] == r["variant"] == "horizontal/ring"
    stats = telemetry.ApssStats(
        **{f: r[f] for f in ("variant", "n", "m", "devices", "block_rows", "sparse", "flops",
                             "live_tiles", "total_tiles", "tile_counts")},
        hops=tuple(telemetry.CollectiveHop(**h) for h in r["hops"]))
    assert res["predicted_s"] == pytest.approx(drift.predict_seconds(stats, prof), rel=1e-12)
    assert 0 < res["measured_s"] and res["source"] == "trace"
