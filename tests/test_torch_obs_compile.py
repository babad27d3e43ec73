"""The port's compile monitor (``repro_torch.obs.compile``) on the CPU.

The counterparts of the reference's ``tests/test_obs_compile.py`` cases: the
registry and its groups; the contracts (passing, raising at mark time,
unnamed, unwatched names, the exit check); a library load under a contract
dumping a flight record; the serving and live-index hot paths under their
group contracts. In the port a "trace" is a kernel library's build (an
``nvcc`` run) or load (a ``ctypes.CDLL``): here a stand-in compiler script
and the process's own symbols stand in for ``nvcc`` and a kernel library, so the real
``_build.build`` and ``_build.load`` mark. Then ``measure`` on a matmul
(record fields, the ``compile/<name>`` span), capture nesting, and the
captured serving inners replayed under ``measure`` equal to the
``query_topk`` call that offered them.
"""

import ctypes
import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.interop import matches_to_numpy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import FlightRecorder, RetraceError, Tracer  # noqa: E402
from repro_torch.obs import compile as obs_compile  # noqa: E402
from repro_torch.obs.compile import CompileMonitor  # noqa: E402


# -- registry ----------------------------------------------------------------


def test_mark_counts_and_snapshot_is_a_copy():
    mon = CompileMonitor()
    mon.mark("a")
    mon.mark("a")
    mon.mark("b")
    snap = mon.snapshot()
    assert snap == {"a": 2, "b": 1}
    snap["a"] = 99
    assert mon.counts["a"] == 2  # snapshot is detached


def test_registered_groups_resolve_to_entry_points():
    import repro_torch.serving.mutable  # noqa: F401  (registers its group on import)

    mon = CompileMonitor()
    mon.register_entry_points("grp", "x", "y")
    c = mon.assert_no_retrace("grp", "z")
    assert c.names == ("x", "y", "z")
    assert obs_compile.entry_points("serving.query") == (
        "rect_tile_candidates", "rect_tile_candidates_ee", "rect_sparse_tile_candidates")
    assert obs_compile.entry_points("serving.mutable") == ("rect_tile_candidates",)
    assert set(obs_compile.entry_points("serving.query")) <= set(_build.sources())


# -- contracts ---------------------------------------------------------------


def test_contract_passes_when_nothing_retraces():
    mon = CompileMonitor()
    mon.mark("warm")
    with mon.assert_no_retrace("warm"):
        pass  # no marks inside


def test_contract_raises_at_mark_time():
    mon = CompileMonitor()
    with pytest.raises(RetraceError, match="'hot'"):
        with mon.assert_no_retrace("hot"):
            mon.mark("hot")


def test_contract_watches_everything_when_unnamed():
    mon = CompileMonitor()
    with pytest.raises(RetraceError):
        with mon.assert_no_retrace():
            mon.mark("anything-at-all")


def test_contract_ignores_unwatched_names():
    mon = CompileMonitor()
    with mon.assert_no_retrace("only-this"):
        mon.mark("something-else")


def test_contract_exit_catches_direct_counter_bumps():
    """A bump that bypassed mark() is caught by the exit check."""
    mon = CompileMonitor()
    with pytest.raises(RetraceError):
        with mon.assert_no_retrace("legacy"):
            mon.counts["legacy"] += 1


@pytest.fixture
def fake_library(tmp_path, monkeypatch):
    """A library ``fake`` built by a stand-in ``nvcc`` (it writes an empty
    output and a ``ptxas`` report) into ``tmp_path``, and loaded as the
    running process's own symbols: the real ``build``/``load`` paths without
    a CUDA toolchain."""
    src = tmp_path / "csrc" / "fake.cu"
    src.parent.mkdir()
    src.write_text("// stand-in source\n")
    compiler = tmp_path / "nvcc"
    compiler.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        ": > \"$out\"\n"
        "echo \"ptxas info    : Compiling entry function 'fake_k' for 'sm_90a'\"\n"
        "echo \"ptxas info    : Used 40 registers, 1024 bytes smem, 0 bytes cmem[0]\"\n"
    )
    compiler.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "sources", lambda: {"fake": src})
    monkeypatch.setattr(_build, "nvcc", lambda: str(compiler))
    monkeypatch.setattr(_build, "_LIBS", {})
    real = ctypes.CDLL
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: real(None))  # this process
    return "fake"


def test_build_and_load_mark_the_monitor(fake_library):
    before = obs_compile.snapshot().get("fake", 0)
    s0 = _build.BUILD_SECONDS.get("fake", 0.0)
    path = _build.build(["fake"])["fake"]
    assert path.is_file() and obs_compile.snapshot()["fake"] == before + 1  # the nvcc run
    assert _build.BUILD_SECONDS["fake"] > s0
    assert _build.ptxas_report("fake") == [
        {"entry": "fake_k", "registers": 40, "static_smem_bytes": 1024}]
    _build.build(["fake"])  # built already: no nvcc, no mark
    _build.load("fake")
    assert obs_compile.snapshot()["fake"] == before + 2  # the load
    _build.load("fake")  # cached: no mark
    assert obs_compile.snapshot()["fake"] == before + 2


def test_library_load_under_contract_dumps_flight_record(fake_library, tmp_path):
    """The acceptance scenario: a warmed library, then its cache dropped
    under an active contract — RetraceError at the load, with a flight
    record dumped for the post-mortem."""
    _build.load("fake")  # warm
    with FlightRecorder(directory=str(tmp_path)) as fr:
        with obs_compile.assert_no_retrace("fake"):
            _build.load("fake")  # cached: fine
            _build._LIBS.clear()
            with pytest.raises(RetraceError, match="fake"):
                _build.load("fake")  # loaded again
    assert fr.dumps and fr.dumps[0][0] == "compile.retrace.fake"
    files = glob.glob(str(tmp_path / "flight_*compile*retrace*fake*.json"))
    assert files, "expected a flight_NNN_compile.retrace.fake dump on disk"


def _corpus(n=128, m=64, seed=0):
    rng = np.random.default_rng(seed)
    X = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    X *= rng.random((n, m)) < 0.3
    X[:, 0] += 0.01
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def test_query_topk_hot_path_contract_is_active():
    """Warm query_topk, then hold the serving.query group under a contract:
    a warmed batch builds and loads nothing (on the CPU the wrappers run
    their plain versions, so nothing is loaded at all)."""
    from repro_torch.core.sparse import from_dense
    from repro_torch.serving import build_index, query_topk

    D = _corpus()
    for data in (D, from_dense(D, device="cpu")):
        index = build_index(data, block_rows=32, device="cpu")
        query_topk(index, D[:4], 0.3, 4)
        with obs_compile.assert_no_retrace("serving.query"):
            query_topk(index, D[:4], 0.3, 4)
            query_topk(index, D[:4], 0.3, 4, block_q=16)


def test_mutable_append_delete_contract_is_active():
    from repro_torch.serving.mutable import MutableAPSSIndex

    rng = np.random.default_rng(0)

    def rows(n):
        X = np.abs(rng.standard_normal((n, 32))).astype(np.float32)
        return X / np.linalg.norm(X, axis=1, keepdims=True)

    mi = MutableAPSSIndex(rows(16), threshold=0.2, k=4, block_rows=64, device="cpu")
    Q = rows(4)
    for _ in range(2):  # warm every delta-join/query/delete shape once
        mi.append(rows(8))
        mi.query(Q)
        mi.delete([int(mi.graph()[0][0])])
    with obs_compile.assert_no_retrace("serving.mutable"):
        mi.append(rows(8))
        mi.query(Q)
        mi.delete([int(mi.graph()[0][0])])


# -- measured calls ----------------------------------------------------------


def test_measure_records_wall_bytes_and_census():
    mon = CompileMonitor()
    x = torch.ones((16, 8))

    def f(x):
        return (x @ x.T).sum()

    with Tracer() as tr:
        out, rec = mon.measure(f, x, name="matmul16x8")
    assert rec.name == "matmul16x8"
    assert float(out) == pytest.approx(16 * 16 * 8)
    assert rec.t_lower_s > 0 and rec.t_compile_s == 0  # nothing built
    assert rec.argument_bytes == 16 * 8 * 4 and rec.output_bytes == 4
    assert rec.temp_bytes == 0 and rec.code_bytes == 0 and rec.kernels == []  # CPU
    assert rec.total_bytes == rec.argument_bytes + rec.output_bytes + rec.temp_bytes
    assert rec.analysis["flops"] == 2 * 16 * 16 * 8
    assert mon.records == [rec]
    assert "compile/matmul16x8" in [s.name for s in tr.walk()]
    d = rec.as_dict()
    assert d["total_bytes"] == rec.total_bytes and d["kernels"] == []


# -- call-site capture -------------------------------------------------------


def test_capture_calls_first_offer_wins_and_nests():
    obs_compile.offer_capture("x", None)  # no context: dropped
    with obs_compile.capture_calls() as outer:
        obs_compile.offer_capture("x", "first", 1, a=2)
        obs_compile.offer_capture("x", "second")
        with obs_compile.capture_calls() as inner:
            obs_compile.offer_capture("x", "inner-first")
        obs_compile.offer_capture("y", "why")
    assert outer["x"].fn == "first"
    assert outer["x"].args == (1,) and outer["x"].kwargs == {"a": 2}
    assert outer["y"].fn == "why"
    assert inner["x"].fn == "inner-first"
    assert obs_compile._CAPTURE is None  # context fully unwound


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_captured_serving_call_replays_the_real_call(rep):
    """The audit seam end to end: capture the query inner from a real
    query_topk call, replay it under ``measure``, and get the hot path's
    Matches back, with the census of its products."""
    from repro_torch.core.sparse import from_dense
    from repro_torch.serving import build_index, query_topk

    D = _corpus(seed=3)
    data = D if rep == "dense" else from_dense(D, device="cpu")
    index = build_index(data, block_rows=32, device="cpu")
    Q = D[5:9] + 0.01
    with obs_compile.capture_calls() as calls:
        got = query_topk(index, Q, 0.3, 4, block_q=8)
    call = calls[f"serving.{rep}_inner"]
    assert list(calls) == [f"serving.{rep}_inner"]
    assert call.kwargs["block_q"] == 8 and call.kwargs["block_c"] == 32
    replayed, rec = CompileMonitor().measure(call.fn, *call.args, name="cap", **call.kwargs)
    for a, b in zip(matches_to_numpy(replayed), matches_to_numpy(got)):
        np.testing.assert_array_equal(a, b)
    T = call.args[2].shape[1]
    depth = index.bx.shape[2] if rep == "sparse" else index.corpus.shape[1]
    assert rec.analysis["flops"] == 2 * T * 8 * 32 * depth  # one product per tile
    assert rec.argument_bytes > 0 and rec.output_bytes > 0
    assert call.fn.__module__ == "repro_torch.serving.query"
