"""Cells of several ranks on the CPU under gloo: a 4-rank cell of the port's
horizontal ring added as files only, a rank that raises and a rank that
hangs, the one-chip path that starts nothing, a driver that does not match
its cell's chips, and the breakdown summed over cards.

Each rank is a spawned process that imports torch, so every test here that
starts ranks bounds its own time (a subprocess timeout, or the launcher's).
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from apssbench import harness, kineto, ranks
from apssbench.test_apssbench_spec import check_contract

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"n": 128, "m": 1000, "nnz": 128 * 20, "k": 8}
SEED = 2**31 + 4242
CELL = "join_radikal_ring4"
RUN_S = 120  # a run of 4 ranks on a busy CPU, start to end

# The port's 1-D horizontal ring (K1 at each step's offsets) on every rank;
# each join's Matches gathered to every rank, so rank 0 holds every row.
RING_DRIVER = """
RANKS = True

from pathlib import Path

from apssbench.harness import load_module

base = load_module(Path(__file__).resolve().parent / "join_loop.py")


class Driver(base.Driver):
    def prepare(self):
        from repro_torch.launch.mesh import make_mesh

        super().prepare()
        self.mesh = make_mesh((self.run.world,), ("data",))

    def _join(self):
        from repro_torch.core.distributed import apss, gather_matches

        cfg = self.run.config
        m = apss(self.corpus, cfg["t"], cfg["k"], self.mesh, distribution="horizontal",
                 axis_name="data", schedule="ring", use_kernel=True, device=self.run.device)
        out = gather_matches(m, self.mesh, "data")
        self.run.sync()
        return out
"""
# The ring, with rank 1 raising or hanging at the window's first step; every
# rank leaves its pid under ``pids/`` of the root.
FAULT_DRIVER = """
RANKS = True

import os
import time
from pathlib import Path

from apssbench.harness import load_module

base = load_module(Path(__file__).resolve().parent / "join_ring.py")


class Driver(base.Driver):
    def prepare(self):
        super().prepare()
        pids = self.run.cell.root / "pids"
        pids.mkdir(exist_ok=True)
        (pids / str(os.getpid())).touch()

    def step(self, i):
        if self.run.rank == 1:
            if self.run.traffic["fault"] == "raises":
                raise RuntimeError("rank 1 raises")
            time.sleep(3600)
        return super().step(i)
"""
CARDS_TRACED = '''"""Cards whose port spans reached rank 0."""


def read(run):
    return sum(1 for c in run.cards if c.spans)
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "apssbench").rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """The benchmark's files with every configuration cut to ``SMALL``."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "apssbench", root / "apssbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    for entry in SPEC["configs"]:
        path = root / entry["file"]
        path.write_text(json.dumps({**json.loads(path.read_text()), **SMALL}))
    (root / "BENCHMARK.json").write_text(json.dumps(SPEC))
    return root


@pytest.fixture(scope="module")
def ring_root(small_root, tmp_path_factory):
    """``small_root`` grown, by new files and entries only, by the 4-rank
    cell ``join_radikal_ring4`` and the per-layer metric ``cards_traced``."""
    root = tmp_path_factory.mktemp("ring") / "grown"
    shutil.copytree(small_root, root)
    bench = root / "apssbench"
    (bench / "drivers" / "join_ring.py").write_text(RING_DRIVER)
    (bench / "drivers" / "join_ring_fault.py").write_text(FAULT_DRIVER)
    (bench / "traffic" / "join_ring.json").write_text(json.dumps({"driver": "join_ring"}))
    for fault in ("raises", "hangs"):
        (bench / "traffic" / f"join_ring_{fault}.json").write_text(
            json.dumps({"driver": "join_ring_fault", "fault": fault}))
    (bench / "limits" / f"{CELL}.json").write_text(
        json.dumps({"value_gap": 1e-05, "rows_wrong": 0}))
    (bench / "metrics" / "cards_traced.py").write_text(CARDS_TRACED)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "radikal", "traffic": "join_ring",
                              "chips": 4, "why": "the horizontal ring on 4 ranks"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("join_ms", "idle_pct.join", "join_idle_ms"):
            m["workloads"].append(CELL)
    spec["per_layer"].append({"name": "cards_traced", "unit": "cards", "better": "higher",
                              "source": "program_span", "layer": "join entry",
                              "moves": "join_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _variant(ring_root, tmp_path, **cell) -> Path:
    """``ring_root`` with the ring cell's entry changed by ``cell``."""
    root = tmp_path / "variant"
    shutil.copytree(ring_root, root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    next(w for w in spec["workloads"] if w["name"] == CELL).update(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run_py_argv(root: Path, cell: str, trace: int = 0, timeout_s=None, prelude: str = "") -> list:
    """The command of ``run.py``'s entry on the CPU for ``cell`` of ``root``,
    after the Python code ``prelude``. A process of its own: a test process
    may hold JAX, which ``run.py`` refuses."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            f"{prelude}\n"
            "from pathlib import Path\n"
            "from apssbench.harness import load_module\n"
            "run = load_module(Path(sys.argv[1]) / 'apssbench' / 'run.py')\n"
            f"sys.exit(run.main(sys.argv[3:], device='cpu', timeout_s={timeout_s!r}))\n")
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds", "0.5", "--trace", str(trace)]
    return [sys.executable, "-c", code, str(root), str(ROOT / "src"), *argv]


def _run_py(root: Path, cell: str, trace: int = 0, timeout_s=None,
            prelude: str = "") -> subprocess.CompletedProcess:
    return subprocess.run(_run_py_argv(root, cell, trace, timeout_s, prelude),
                          capture_output=True, text=True, timeout=RUN_S)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    status = Path(f"/proc/{pid}/status")
    return not (status.exists() and "\nState:\tZ" in status.read_text())


def test_a_cell_on_four_ranks_added_as_files_only(small_root, ring_root):
    """The ring cell passes every rule of the contract, adds files and
    entries only, and runs correct on 4 ranks, with every rank's spans
    read through ``run.cards``."""
    check_contract(ring_root)
    base, grown = _digests(small_root), _digests(ring_root)
    assert {k: grown[k] for k in base} == base, "a file of the copied apssbench/ changed"
    spec0 = json.loads((small_root / "BENCHMARK.json").read_text())
    spec1 = json.loads((ring_root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for old, new in zip(spec0[key], spec1[key]):
            assert {**new, "workloads": None} == {**old, "workloads": None}
            kept = old.get("workloads", [])
            assert new.get("workloads", [])[:len(kept)] == kept

    out = _run_py(ring_root, CELL, trace=1)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["count"] == 4 and len(line["device"]["cards"]) == 4
    assert line["metrics"]["cards_traced"]["value"] == 4.0
    assert "check value_gap" in out.stderr


def test_control_runs_a_cell_on_four_ranks(ring_root):
    """``control.py`` on the ring cell: the program on 4 ranks, the judge and
    the control on rank 0; the control fails the cell's limits."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from pathlib import Path\n"
            "from apssbench.harness import load_module\n"
            "c = load_module(Path(sys.argv[1]) / 'apssbench' / 'control.py')\n"
            "sys.exit(c.main(sys.argv[3:], device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code, str(ring_root), str(ROOT / "src"),
                          "--workload", CELL, "--seeds", str(SEED), "--control-seeds", str(SEED)],
                         capture_output=True, text=True, timeout=RUN_S)
    assert out.returncode == 0, out.stderr[-4000:]
    row, summary = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    limits = harness.load_cell(ring_root, CELL).limits
    assert row["seed"] == SEED and summary["seeds"] == 1
    assert row["program"]["value_gap"] <= limits["value_gap"] and row["program"]["rows_wrong"] == 0
    assert (row["control"]["value_gap"] > limits["value_gap"]
            or row["control"]["rows_wrong"] > limits["rows_wrong"])


@pytest.mark.parametrize("fault,timeout_s", [("raises", None), ("hangs", 15.0)])
def test_a_rank_that_fails_ends_the_run_with_no_result(ring_root, tmp_path, fault, timeout_s):
    """Rank 1 raises, or hangs, at the window's first step: ``run.py`` exits
    non-zero with no result line within the collective timeout and a
    minute, and no rank is left."""
    root = _variant(ring_root, tmp_path, traffic=f"join_ring_{fault}")
    t0 = time.monotonic()
    out = _run_py(root, CELL, timeout_s=timeout_s)
    took = time.monotonic() - t0
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert took < (timeout_s or ranks.COLLECTIVE_TIMEOUT_S) + 60
    pids = [int(p.name) for p in (root / "pids").iterdir()]
    assert len(pids) == 4
    assert not [p for p in pids if _alive(p)], "a rank outlived the run"


def test_no_rank_outlives_the_process_that_launched_it(ring_root, tmp_path):
    """The process of ``run.py`` is killed while its ranks run (rank 1
    hangs, the others wait in a collective): every rank dies with it."""
    root = _variant(ring_root, tmp_path, traffic="join_ring_hangs")
    proc = subprocess.Popen(_run_py_argv(root, CELL), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL,
                            env={**os.environ, "TMPDIR": str(tmp_path)})  # the killed run's store
    try:
        deadline = time.monotonic() + RUN_S
        while len(list((root / "pids").glob("*")) if (root / "pids").is_dir() else []) < 4:
            assert proc.poll() is None and time.monotonic() < deadline, "the ranks did not start"
            time.sleep(0.2)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    pids = [int(p.name) for p in (root / "pids").iterdir()]
    deadline = time.monotonic() + 30
    while [p for p in pids if _alive(p)] and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not [p for p in pids if _alive(p)], "a rank outlived the process that launched it"


# Every way to start a process or a group, and every side-group call, made to fail.
REFUSE_PROCESSES_AND_GROUPS = """
import multiprocessing, subprocess
import torch.distributed as dist
import torch.multiprocessing as tmp

def refuse(*args, **kw):
    raise AssertionError("the one-chip path started a process or a group")

for mod, name in [(tmp, "start_processes"), (tmp, "spawn"), (multiprocessing.Process, "start"),
                  (subprocess, "Popen"), (dist, "init_process_group"), (dist, "new_group"),
                  (dist, "barrier"), (dist, "broadcast"), (dist, "gather_object")]:
    setattr(mod, name, refuse)
"""


def test_a_one_chip_cell_starts_no_process_and_no_group(ring_root):
    """The one-chip path: no process, no process group, no side-group call
    (where the ring cell of 4 ranks is refused at its start)."""
    out = _run_py(ring_root, "join_radikal_dense", trace=1, prelude=REFUSE_PROCESSES_AND_GROUPS)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["count"] == 1 and "cards" not in line["device"]
    ring = _run_py(ring_root, CELL, prelude=REFUSE_PROCESSES_AND_GROUPS)
    assert ring.returncode != 0 and "started a process or a group" in ring.stderr


@pytest.mark.parametrize("chips,traffic", [(1, "join_ring"), (4, "join_dense")])
def test_a_driver_that_does_not_match_its_chips_is_refused(ring_root, tmp_path, monkeypatch,
                                                          chips, traffic):
    """A driver that takes ranks in a one-chip cell, and one that does not
    in a 4-chip cell, are refused before any step or rank."""
    import torch.multiprocessing as tmp

    monkeypatch.setattr(tmp, "start_processes", lambda *a, **kw: pytest.fail("ranks started"))
    root = _variant(ring_root, tmp_path, chips=chips, traffic=traffic)
    run = harness.load_module(root / "apssbench" / "run.py")
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "0.2", "--trace", "0"]
    with pytest.raises(ValueError, match="RANKS"):
        run.main(argv, device="cpu")


def test_the_breakdown_sums_over_cards_and_one_card_reads_alone():
    a = kineto.Trace([("k1", 0, 40), ("copy", 50, 60), ("k1", 100, 130)],
                     [(40, 50, "host_a"), (60, 100, "host_b")], 0)
    b = kineto.Trace([("k1", 0, 10), ("copy", 20, 80)], [(10, 20, "host_a")], 0)
    assert kineto.ranked(kineto.summed([a.op_ns()])) == [["k1", 70 / 1e9], ["copy", 10 / 1e9]]
    assert kineto.ranked(kineto.summed([a.op_ns(), b.op_ns()])) == [["k1", 80 / 1e9],
                                                                    ["copy", 70 / 1e9]]
    assert kineto.ranked(kineto.summed([a.gap_ns(), b.gap_ns()])) == [["host_b", 40 / 1e9],
                                                                     ["host_a", 20 / 1e9]]
    assert kineto.ranked(kineto.summed([a.gap_ns()]), 1) == [["host_b", 40 / 1e9]]
