"""BENCHMARK.json against the benchmark's contract, and the import guard.

Each rule of the contract is a ``check_*`` function of a root's
``BENCHMARK.json`` and files, so that a copy of the benchmark grown by new
files (``test_apssbench_ranks.py``) is held to the same rules
(:func:`check_contract`)."""

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


def check_top_level_keys_and_command(root: Path, spec: dict) -> None:
    assert set(spec) == KEYS
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) for p in spec["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    script = root / spec["command"][1]
    assert script.is_file() and any(script.is_relative_to(root / p) for p in spec["paths"])
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024


def check_run_seconds(spec: dict) -> None:
    r = spec["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def check_config_entry(root: Path, spec: dict, entry: dict) -> None:
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert PATH.match(entry["file"]) and entry["file"].startswith(tuple(spec["paths"]))
    cfg = json.loads((root / entry["file"]).read_text())
    assert len(entry["reduced"]) <= 16 and all(k in cfg and NAME.match(k) for k in entry["reduced"])
    assert entry["name"] in {w["config"] for w in spec["workloads"]}


def check_workload_entry_and_its_files(root: Path, cell: dict) -> None:
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4)
    loaded = harness.load_cell(root, cell["name"])
    assert (root / "apssbench" / "drivers" / f"{loaded.traffic['driver']}.py").is_file()
    assert loaded.limits and all(NAME.match(k) for k in loaded.limits)
    assert all(isinstance(v, (int, float)) for v in loaded.limits.values())
    assert (root / "apssbench" / "laws" / f"{loaded.config['assumed']['law']}.py").is_file()
    e2e = loaded.metrics(trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert loaded.metrics(trace=True), "every cell reports a per-layer metric"


def check_driver_declares_ranks_exactly_on_several_chips(root: Path, cell: dict) -> None:
    loaded = harness.load_cell(root, cell["name"])
    path = root / "apssbench" / "drivers" / f"{loaded.traffic['driver']}.py"
    assert bool(getattr(harness.load_module(path), "RANKS", False)) == (cell["chips"] > 1)
    loaded.driver()  # the harness's own refusal agrees


def check_four_chip_quota(spec: dict) -> None:
    """At most a quarter of the cells, rounded down, on four chips; one always may."""
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)


def check_cells_unique(spec: dict) -> None:
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs) == len({w["name"] for w in spec["workloads"]})


def check_metric_entry_and_reader(root: Path, spec: dict, metric: dict) -> None:
    per_layer = metric in spec["per_layer"]
    allowed = {"name", "unit", "better", "source"} | (
        {"layer", "moves", "workloads"} if per_layer else {"bound", "workloads"})
    assert set(metric) <= allowed and NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in spec["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert callable(harness.load_module(root / "apssbench" / "metrics" / f"{metric['name']}.py").read)
    if per_layer:
        assert _line(metric["layer"])
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = {m["name"]: m for m in spec["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def check_names_unique(spec: dict) -> None:
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))


def check_nothing_imports_jax_or_the_jax_package(root: Path) -> None:
    files = [p for p in (root / "apssbench").rglob("*.py") if not p.name.startswith("test_")]
    for p in files:
        assert not _imports(p) & set(harness.FORBIDDEN), p


def check_contract(root: Path) -> None:
    """Every rule above over ``root``'s ``BENCHMARK.json`` and files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    check_top_level_keys_and_command(root, spec)
    check_run_seconds(spec)
    for entry in spec["configs"]:
        check_config_entry(root, spec, entry)
    for cell in spec["workloads"]:
        check_workload_entry_and_its_files(root, cell)
        check_driver_declares_ranks_exactly_on_several_chips(root, cell)
    check_four_chip_quota(spec)
    check_cells_unique(spec)
    for metric in spec["end_to_end"] + spec["per_layer"]:
        check_metric_entry_and_reader(root, spec, metric)
    check_names_unique(spec)
    check_nothing_imports_jax_or_the_jax_package(root)


def test_top_level_keys_and_command():
    check_top_level_keys_and_command(ROOT, SPEC)


def test_run_seconds_fits_the_check_with_24_cells():
    check_run_seconds(SPEC)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    check_config_entry(ROOT, SPEC, entry)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_entry_and_its_files(cell):
    check_workload_entry_and_its_files(ROOT, cell)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_driver_declares_ranks_exactly_on_several_chips(cell):
    check_driver_declares_ranks_exactly_on_several_chips(ROOT, cell)


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    check_four_chip_quota(SPEC)


@pytest.mark.parametrize("chips,cells,allowed", [
    ((1, 1, 1), 3, True), ((4, 1, 1), 3, True), ((4, 4, 1), 3, False),
    ((4, 4) + (1,) * 6, 8, True), ((4, 4, 4) + (1,) * 6, 9, False),
])
def test_four_chip_quota_is_a_quarter_rounded_down_and_one_always(chips, cells, allowed):
    spec = {"workloads": [{"chips": c} for c in chips]}
    assert len(chips) == cells
    if allowed:
        check_four_chip_quota(spec)
    else:
        with pytest.raises(AssertionError):
            check_four_chip_quota(spec)


def test_cells_unique():
    check_cells_unique(SPEC)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    check_metric_entry_and_reader(ROOT, SPEC, metric)


def test_names_unique():
    check_names_unique(SPEC)


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
    check_nothing_imports_jax_or_the_jax_package(ROOT)


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
        "import apssbench.ranks\n"
        "for d in ('drivers/join_loop', 'drivers/query_loop', 'laws/zipf', 'laws/topical'):\n"
        "    h.load_module(h.Path(sys.argv[1]) / 'apssbench' / (d + '.py'))\n"
        "import repro_torch, repro_torch.serving.index, repro_torch.serving.query\n"
        "import repro_torch.obs.trace\n"
        "print(h.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
