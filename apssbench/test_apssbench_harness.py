"""The harness end to end on the CPU at tiny sizes: every cell, a cell added
as files only, the faults a cell can have, and the control.

The port's entry points run their plain versions on the CPU, so these runs
drive everything of a chip run but the card: the harness's look for a card
(``run.py``) is the part they skip.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from apssbench import control, harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY = {"n": 320, "m": 3000, "nnz": 320 * 40, "k": 8}
SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The benchmark's files with every configuration cut to ``TINY`` rows
    and dimensions and every query mix to 4 batches of 16."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "apssbench", root / "apssbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    for entry in SPEC["configs"]:
        path = root / entry["file"]
        path.write_text(json.dumps({**json.loads(path.read_text()), **TINY}))
    for path in (root / "apssbench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        if "batch" in tr:
            path.write_text(json.dumps({**tr, "batch": 16, "pool_batches": 4}))
    (root / "BENCHMARK.json").write_text(json.dumps(SPEC))
    return root


def _run(root, cell, **kw):
    return harness.run_cell(root, cell, seed=kw.pop("seed", SEED), seconds=kw.pop("seconds", 0.2),
                            trace=kw.pop("trace", False), device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[0] == "correct" and list(out)[-1] == "checks"
    want = {m["name"] for m in harness.load_cell(tiny_root, cell).metrics(False)}
    assert {"setup_s", "join_ms" if cell.startswith("join") else "query_qps"} <= want
    assert set(out["metrics"]) == want - {"peak_mem_gib"}  # no device memory on the CPU
    assert out["checks"]["value_gap"]["value"] < out["checks"]["value_gap"]["limit"]


# A driver added as a file: the query loop with a check of its own, the
# share of the window's batches whose answers the judge found wrong.
EXTRA_DRIVER = """
from pathlib import Path

from apssbench.harness import load_module

base = load_module(Path(__file__).resolve().parent / "query_loop.py")


class Driver(base.Driver):
    def judge(self, limits):
        numbers, failed = super().judge(limits)
        return {**numbers, "failed_share": failed / max(1, len(self.outs))}, failed
"""
# A law added as a file: the zipf law over the first half of the
# dimensions only.
EXTRA_LAW = """
from apssbench.gen import zipf_csr


def draw(config, gen):
    return zipf_csr(config["n"], config["m"] // 2, config["nnz"] / config["n"],
                    config["assumed"]["zipf_alpha"], gen)._replace(m=config["m"])
"""


def _grown(tiny_root, tmp_path, limits):
    """``tiny_root`` with a configuration, a law, a mix, a driver, a metric
    and a cell that exist only as new files and entries."""
    root = tmp_path / "grown"
    shutil.copytree(tiny_root, root)
    bench = root / "apssbench"
    (bench / "configs" / "tiny_extra.json").write_text(json.dumps(
        {"n": 200, "m": 1500, "nnz": 200 * 25, "t": 0.3, "k": 5,
         "assumed": {"law": "half_zipf", "zipf_alpha": 1.1}}))
    (bench / "laws" / "half_zipf.py").write_text(EXTRA_LAW)
    (bench / "drivers" / "query_loop_shared.py").write_text(EXTRA_DRIVER)
    (bench / "traffic" / "query_dense_b8.json").write_text(json.dumps(
        {"driver": "query_loop_shared", "batch": 8, "pool_batches": 3, "rows": "scattered",
         "noise": 0.02}))
    (bench / "metrics" / "batches_done.py").write_text(
        "def read(run):\n    return len(run.step_s)\n")
    (bench / "limits" / "query_extra.json").write_text(json.dumps(limits))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_extra", "source": "a test", "reduced": [],
                            "file": "apssbench/configs/tiny_extra.json", "why": "a test"})
    spec["workloads"].append({"name": "query_extra", "config": "tiny_extra",
                              "traffic": "query_dense_b8", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("query_qps", "batch_p95_ms", "query_host_ms"):
            m["workloads"].append("query_extra")
    spec["per_layer"].append({"name": "batches_done", "unit": "batches", "better": "higher",
                              "source": "host_clock", "layer": "serving/query",
                              "moves": "query_qps", "workloads": ["query_extra"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_a_cell_added_as_files_only(tiny_root, tmp_path):
    """A configuration with its law, a mix with its driver and a check of
    its own, a metric and a cell are found by name, with no file of the
    harness edited."""
    limits = {"value_gap": 1e-05, "rows_wrong": 0, "failed_share": 0.0}
    root = _grown(tiny_root, tmp_path, limits)
    out = _run(root, "query_extra", trace=True)
    assert out["correct"]
    assert list(out["checks"]) == list(limits) and out["checks"]["failed_share"]["value"] == 0.0
    assert out["metrics"]["batches_done"]["value"] == out["attempted"] >= 1
    assert "query_host_ms" in out["metrics"]  # the port's own spans, read under a Tracer
    assert "k1_roofline" not in out["metrics"]
    plain = _run(root, "query_extra")
    assert {"query_qps", "batch_p95_ms", "setup_s"} <= set(plain["metrics"])
    cell = harness.load_cell(root, "query_extra")
    run = harness.start(root, "query_extra", SEED, "cpu")
    harness.prepared(run)
    assert run.csr.m == 1500 and int(run.csr.indices.max()) < 750, "the new law drew the corpus"
    assert cell.traffic["driver"] == "query_loop_shared"


def test_a_check_that_the_driver_does_not_return_fails(tiny_root, tmp_path):
    root = _grown(tiny_root, tmp_path, {"value_gap": 1e-05, "rows_wrong": 0, "recall_short": 0})
    out = _run(root, "query_extra")
    assert not out["correct"] and out["checks"]["recall_short"]["value"] is None


def _broken(fn, fault):
    """``fn`` with its ``Matches`` broken where they are produced."""
    from repro_torch import Matches

    def wrapped(*args, **kw):
        m = fn(*args, **kw)
        v, i, c = (x.clone() for x in m)
        if fault == "answer_altered":
            r = int(torch.nonzero(i[:, 0] >= 0)[0])
            i[r, 0] = (i[r, 0] + 1) % max(2, int(i.max()) + 1)
        else:  # half of the batch left out
            h = v.shape[0] // 2
            v[h:], i[h:], c[h:] = float("-inf"), -1, 0
        return Matches(v, i, c)
    return wrapped


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    import repro_torch
    import repro_torch.serving.query as query

    if cell.startswith("join"):
        monkeypatch.setattr(repro_torch, "apss_blocked", _broken(repro_torch.apss_blocked, fault))
    else:
        monkeypatch.setattr(query, "query_topk", _broken(query.query_topk, fault))
    out = _run(tiny_root, cell)
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    """The control in the program's place fails the cell's limits; the
    program's own readings pass them."""
    limits = harness.load_cell(tiny_root, cell).limits
    r = control.readings(tiny_root, cell, SEED, device="cpu", control=True)
    assert r["program"]["value_gap"] <= limits["value_gap"]
    assert r["program"]["rows_wrong"] <= limits["rows_wrong"]
    assert (r["control"]["value_gap"] > limits["value_gap"]
            or r["control"]["rows_wrong"] > limits["rows_wrong"])


def test_run_exits_without_a_result_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would measure the cell")
    out = subprocess.run(
        [sys.executable, str(ROOT / "apssbench" / "run.py"), "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
