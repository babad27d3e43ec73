"""One run of one cell: inputs from the seed, the port's set-up, the window,
the check, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- its configuration: the file that the ``configs`` entry names, whose
  ``assumed.law`` names the law its corpus is drawn from,
  ``apssbench/laws/<law>.py`` (``draw(config, gen)``);
- its traffic: ``apssbench/traffic/<traffic>.json``, whose ``driver`` names
  ``apssbench/drivers/<driver>.py``;
- its limits for ``correct``: ``apssbench/limits/<cell>.json``, a limit for
  each named number that the driver's ``judge(limits)`` returns (every
  number is bounded above; a number the driver does not return fails);
- each metric's reader: ``apssbench/metrics/<metric>.py`` (``read(run)``
  returns the number, or ``None`` where there is nothing to read);
- each kernel's roofline count: ``apssbench/roofline/<kernel>.py``.

So a later cell, mix, metric or kernel count is a new file and a new entry,
and no file here changes. The program under test is ``repro_torch`` only.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from apssbench.gen import Csr

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, whole


def load_module(path: Path):
    """The Python file ``path`` as a module of its own (names may hold dots)."""
    name = "apssbench_file_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` and its files describe it."""

    root: Path
    spec: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"] if self._has(m)]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (self._has(m) if "workloads" in m else m["moves"] in moved)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str):
        return load_module(self.root / "apssbench" / "metrics" / f"{metric}.py")

    def roofline(self, kernel: str):
        return load_module(self.root / "apssbench" / "roofline" / f"{kernel}.py")

    def law(self):
        return load_module(self.root / "apssbench" / "laws" / f"{self.config['assumed']['law']}.py")

    def driver(self):
        return load_module(self.root / "apssbench" / "drivers" / f"{self.traffic['driver']}.py")


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        root=root, spec=spec, workload=w,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((root / "apssbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((root / "apssbench" / "limits" / f"{workload}.json").read_text()),
    )


@dataclass
class Run:
    """What a run hands its metric readers and its driver."""

    cell: Cell
    device: torch.device
    gen: torch.Generator
    csr: Csr | None = None
    pool: Csr | None = None  # the query batches, stacked, where the traffic has them
    setup_s: float = 0.0
    window_s: float = 0.0
    step_s: list = field(default_factory=list)
    step_items: list = field(default_factory=list)
    step_keys: list = field(default_factory=list)
    peak_bytes: int = 0
    counters: dict = field(default_factory=dict)
    trace: object = None  # kineto.Trace of the traced window
    spans: list = field(default_factory=list)  # (name, seconds) of the port's spans
    phases: dict = field(default_factory=dict)  # host-clock seconds of the run's phases

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that are JAX's or the JAX package's, compared whole: ``repro_torch``
    is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in (name.partition(".")[0] for name in names) if m in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def start(root: Path, workload: str, seed: int, device: str) -> Run:
    """A run of ``workload`` whose draws come from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    return Run(cell=load_cell(root, workload), device=dev, gen=gen)


def prepared(run: Run):
    """The run's inputs drawn and its traffic's driver, prepared."""
    run.csr = run.cell.law().draw(run.config, run.gen)
    driver = run.cell.driver().Driver(run)
    driver.prepare()
    return driver


def run_cell(root: Path, workload: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = start(root, workload, seed, device)
    cell, dev = run.cell, run.device
    clock = _Phases(run, t_start)
    clock("imports_context")
    driver = prepared(run)
    clock("inputs")
    pre_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver.setup()
    clock("port_setup")
    driver.warm()
    clock("warm")
    run.setup_s = time.perf_counter() - t_start

    profiled = tracer = None
    if trace:
        from repro_torch.obs.trace import Tracer

        from apssbench.kineto import LEAD_LAUNCHES, Profiled

        if dev.type == "cuda":
            profiled = Profiled().__enter__()
        tracer = Tracer().__enter__()
    t0 = time.perf_counter()
    end = t0
    i = 0
    while end - t0 < seconds:
        a = time.perf_counter()
        items, key = driver.step(i)
        end = time.perf_counter()
        run.step_s.append(end - a)
        run.step_items.append(items)
        run.step_keys.append(key)
        i += 1
    run.window_s = end - t0
    if tracer is not None:
        tracer.__exit__(None, None, None)
        run.spans = [(s.name, s.duration_s) for s in tracer.walk() if s is not tracer.root]
    if profiled is not None:
        profiled.__exit__(None, None, None)
        run.trace = profiled.trace
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(max(pre_peak, run.peak_bytes))}
    out = {"attempted": len(run.step_s), "metrics": metrics, "device": info}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
        out["trace_lead"] = {"launches": LEAD_LAUNCHES, "records": run.trace.lead_records}
    if dev.type == "cuda":
        out["card"] = power_limit()

    driver.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    clock("report")
    numbers, failed_steps = driver.judge(cell.limits)
    clock("check")
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in cell.limits.items()}
    correct = bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                                   for c in checks.values())
    out["phases_s"] = run.phases
    out["step_ms"] = [1e3 * x for x in run.step_s]
    return {"correct": bool(correct), "failed": int(failed_steps), **out, "checks": checks}


class _Phases:
    """``clock(name)`` records under ``name`` the seconds since the last call
    (the first call: since ``t_start``), the card synchronized."""

    def __init__(self, run, t_start: float):
        self.run, self.last = run, t_start

    def __call__(self, name: str) -> None:
        self.run.sync()
        now = time.perf_counter()
        self.run.phases[name] = now - self.last
        self.last = now
