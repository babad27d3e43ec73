"""BENCHMARK.json against the benchmark's contract, and the import guard."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from apssbench import harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    script = ROOT / SPEC["command"][1]
    assert script.is_file() and any(script.is_relative_to(ROOT / p) for p in SPEC["paths"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    r = SPEC["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert PATH.match(entry["file"]) and entry["file"].startswith(tuple(SPEC["paths"]))
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert len(entry["reduced"]) <= 16 and all(k in cfg and NAME.match(k) for k in entry["reduced"])
    assert entry["name"] in {w["config"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_entry_and_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] == 1
    loaded = harness.load_cell(ROOT, cell["name"])
    assert (ROOT / "apssbench" / "drivers" / f"{loaded.traffic['driver']}.py").is_file()
    assert loaded.limits and all(NAME.match(k) for k in loaded.limits)
    assert all(isinstance(v, (int, float)) for v in loaded.limits.values())
    assert (ROOT / "apssbench" / "laws" / f"{loaded.config['assumed']['law']}.py").is_file()
    e2e = loaded.metrics(trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert loaded.metrics(trace=True), "every cell reports a per-layer metric"


def test_cells_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs) == len({w["name"] for w in SPEC["workloads"]})


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    per_layer = metric in SPEC["per_layer"]
    allowed = {"name", "unit", "better", "source"} | (
        {"layer", "moves", "workloads"} if per_layer else {"bound", "workloads"})
    assert set(metric) <= allowed and NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert callable(harness.load_module(ROOT / "apssbench" / "metrics" / f"{metric['name']}.py").read)
    if per_layer:
        assert _line(metric["layer"])
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_names_unique():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


def test_configurations_are_the_papers_table_1():
    from repro_torch.data.synthetic import PAPER_DATASETS

    table = {"radikal": "radikal", "20news": "20-newsgroups", "20news_topics": "20-newsgroups"}
    for entry in SPEC["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        row = PAPER_DATASETS[table[entry["name"]]]
        assert {k: cfg[k] for k in ("n", "m", "nnz", "t")} == row and entry["reduced"] == []
        law = cfg["assumed"]["law"]
        assert law == "topical" or cfg["assumed"]["zipf_alpha"] == 1.1
    sources = [entry["source"] for entry in SPEC["configs"]]
    assert len(set(sources)) == len(sources)


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.partition(".")[0])
    return tops


def test_nothing_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "apssbench").rglob("*.py") if not p.name.startswith("test_")]
    for p in files:
        assert not _imports(p) & set(harness.FORBIDDEN), p


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "apssbench" / "reference").rglob("*.py"):
        assert not _imports(p) & {"repro_torch", *harness.FORBIDDEN}, p


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.core", "torch", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.apss", "jaxlib.xla_client", "flax"], ["flax", "jaxlib", "repro"]),
    (["jax_fake", "reprox", "jax"], ["jax"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "import apssbench.harness as h, apssbench.kineto, apssbench.control, apssbench.readers\n"
        "for d in ('drivers/join_loop', 'drivers/query_loop', 'laws/zipf', 'laws/topical'):\n"
        "    h.load_module(h.Path(sys.argv[1]) / 'apssbench' / (d + '.py'))\n"
        "import repro_torch, repro_torch.serving.index, repro_torch.serving.query\n"
        "import repro_torch.obs.trace\n"
        "print(h.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
