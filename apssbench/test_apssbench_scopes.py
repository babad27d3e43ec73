"""The readers of the port's stage spans and of the device idle time inside
its scopes, on hand-made traces and runs."""

from pathlib import Path

import numpy as np
import pytest
import torch

from apssbench import harness
from apssbench.kineto import Trace
from apssbench.scopes import idle_ms

ROOT = Path(__file__).resolve().parents[1]
MS = 1_000_000  # ns


def _reader(name):
    return harness.load_module(ROOT / "apssbench" / "metrics" / f"{name}.py").read


def _run(trace=None, spans=()):
    return harness.Run(cell=None, device=torch.device("cpu"), gen=torch.Generator(),
                       trace=trace, spans=list(spans))


def _trace(device, host):
    return Trace([(nm, a * MS, b * MS) for nm, a, b in device],
                 [(a * MS, b * MS, nm) for a, b, nm in host], 0)


# Two serving/query scopes inside the query loop's own: the first is covered by
# overlapping records over [100, 150], [170, 180] and [195, 200] (65 of its
# 100 ms), the second by none; a core/apss_blocked scope is covered whole.
TRACE = _trace(
    device=[("k1", 90, 130), ("k2", 120, 150), ("k3", 125, 140), ("k4", 170, 180),
            ("k5", 195, 260), ("k6", 500, 520), ("k7", 505, 530)],
    host=[(95, 410, "apssbench.query"), (100, 200, "serving/query"),
          (300, 400, "serving/query"), (110, 120, "serving/query/mask"),
          (500, 530, "core/apss_blocked"), (0, 1000, "aten::empty")],
)


def test_idle_inside_a_scope_clips_the_union_of_device_records():
    assert idle_ms(_run(TRACE), "serving/query") == pytest.approx((35 + 100) / 2)
    assert idle_ms(_run(TRACE), "core/apss_blocked") == 0.0
    assert idle_ms(_run(TRACE), "serving/query/mask") == 0.0


def test_the_idle_readers_read_their_scopes():
    assert _reader("query_idle_ms")(_run(TRACE)) == pytest.approx(67.5)
    assert _reader("join_idle_ms")(_run(TRACE)) == 0.0


def test_a_scope_with_no_device_record_is_idle_throughout():
    t = _trace(device=[], host=[(10, 14, "core/apss_blocked"), (20, 30, "core/apss_blocked")])
    assert _reader("join_idle_ms")(_run(t)) == pytest.approx(7.0)


@pytest.mark.parametrize("run", [
    _run(None),
    _run(_trace(device=[("k", 0, 5)], host=[(0, 10, "apssbench.query")])),
], ids=["no_trace", "no_scope"])
def test_without_trace_or_scope_the_idle_readers_return_none(run):
    assert _reader("query_idle_ms")(run) is None
    assert _reader("join_idle_ms")(run) is None


def test_idle_matches_brute_force_on_random_records():
    rng = np.random.default_rng(5)
    starts = rng.integers(0, 900, 60)
    device = [(f"k{i}", int(a), int(a + rng.integers(1, 40))) for i, a in enumerate(starts)]
    host = [(int(a), int(a + rng.integers(1, 120)), "serving/query")
            for a in rng.integers(0, 950, 12)]
    busy = np.zeros(1200, bool)
    for _, a, b in device:
        busy[a:b] = True
    brute = np.mean([(~busy[a:b]).sum() for a, b, _ in host])
    assert idle_ms(_run(_trace(device, host)), "serving/query") == pytest.approx(brute)


SPANS = [("serving/query", 0.050), ("serving/query/mask", 0.001),
         ("serving/query/worklist", 0.0002), ("serving/query/score", 0.0004),
         ("serving/query/fold", 0.046), ("serving/query", 0.052),
         ("serving/query/mask", 0.003), ("serving/query/worklist", 0.0004),
         ("serving/query/score", 0.0006), ("serving/query/fold", 0.044)]


@pytest.mark.parametrize("metric,expected", [
    ("query_mask_ms", 2.0), ("query_worklist_ms", 0.3), ("query_fold_ms", 45.0),
    ("query_host_ms", 51.0),
])
def test_the_span_readers_take_each_stage_mean(metric, expected):
    assert _reader(metric)(_run(spans=SPANS)) == pytest.approx(expected)


@pytest.mark.parametrize("metric", ["query_mask_ms", "query_worklist_ms", "query_fold_ms"])
def test_a_program_without_the_stage_spans_reads_none(metric):
    assert _reader(metric)(_run(spans=[("serving/query", 0.05)])) is None
    assert _reader(metric)(_run()) is None


def test_the_stages_sum_to_no_more_than_the_call():
    run = _run(spans=SPANS)
    stages = sum(_reader(m)(run) for m in ("query_mask_ms", "query_worklist_ms",
                                           "query_fold_ms"))
    assert stages <= _reader("query_host_ms")(run)
