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

A cell's ``chips`` decides how it runs. With 1, :func:`run_cell` runs it in
the calling process on one card, with the :class:`Solo` lockstep, which
waits for no one. With more, ``apssbench/ranks.py`` starts one rank a card
and each rank runs :func:`run_cell` with a lockstep of its own, which keeps
the ranks' phases and the window's steps together; rank 0 reads every
card's records (``Run.cards``), reports and judges. A driver that takes
ranks says so with a module-level ``RANKS = True``, and only such a driver
may serve a cell on more than one chip.
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

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def driver(self):
        """The traffic's driver module; a ``ValueError`` where it declares
        ``RANKS`` and the cell is on one chip, or the other way round: each
        rank would run the whole job alone, or the job would wait for ranks
        that never come."""
        mod = load_module(self.root / "apssbench" / "drivers" / f"{self.traffic['driver']}.py")
        if bool(getattr(mod, "RANKS", False)) != (self.chips > 1):
            raise ValueError(
                f"{self.name}: chips {self.chips} and driver {self.traffic['driver']!r} "
                f"{'declares' if getattr(mod, 'RANKS', False) else 'lacks'} RANKS = True; "
                "a driver takes ranks exactly when its cell has more than one chip")
        return mod


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
class Card:
    """What one card of a run recorded: its peak since the port's set-up
    (``peak_bytes``), its process's peak (``memory_peak_bytes``, the
    inputs drawn before that set-up too), the traced window's
    ``kineto.Trace`` and the port's spans ``(name, seconds)``."""

    peak_bytes: int = 0
    memory_peak_bytes: int = 0
    trace: object = None
    spans: list = field(default_factory=list)


@dataclass
class Run:
    """What a run hands its metric readers and its driver. In a run of
    several ranks, each rank has its own; rank 0's holds every card's
    records in ``cards`` (rank order), the fullest card's peak in
    ``peak_bytes``, and its own trace and spans in ``trace`` and ``spans``."""

    cell: Cell
    device: torch.device
    gen: torch.Generator
    rank: int = 0
    world: int = 1
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
    cards: list = field(default_factory=list)  # a Card a card, rank order

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


def start(root: Path, workload: str, seed: int, device: str, *, rank: int = 0,
          world: int = 1) -> Run:
    """A run of ``workload`` whose draws come from ``seed`` on ``device``,
    as rank ``rank`` of ``world`` (every rank draws the same)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    cell = load_cell(root, workload)
    if world != cell.chips:
        raise ValueError(f"{workload} runs on {cell.chips} chip(s), one rank each; "
                         f"this run has {world} rank(s)")
    return Run(cell=cell, device=dev, gen=gen, rank=rank, world=world)


def prepared(run: Run):
    """The run's inputs drawn and its traffic's driver, prepared."""
    run.csr = run.cell.law().draw(run.config, run.gen)
    driver = run.cell.driver().Driver(run)
    driver.prepare()
    return driver


class Solo:
    """The lockstep of a run in one process on one card: no other rank to
    wait for, signal or hear from (``apssbench/ranks.py`` has the lockstep
    of a run of several ranks)."""

    rank, world = 0, 1

    def barrier(self) -> None:
        pass

    def go_on(self, go: bool) -> bool:
        return go

    def gather(self, record) -> list:
        return [record]


def run_cell(root: Path, workload: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             lockstep=None) -> dict | None:
    """One run; returns the result line's object (``checks`` last). With a
    ``lockstep`` of several ranks, this is one rank's part: the ranks pass
    each phase together, rank 0's clock decides when the window closes, and
    rank 0 gathers every card's records, reports and judges; the other
    ranks return ``None``."""
    t_start = time.perf_counter() if t_start is None else t_start
    lock = Solo() if lockstep is None else lockstep
    run = start(root, workload, seed, device, rank=lock.rank, world=lock.world)
    cell, dev = run.cell, run.device
    clock = _Phases(run, t_start)
    clock("imports_context")
    driver = prepared(run)
    lock.barrier()
    clock("inputs")
    pre_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver.setup()
    lock.barrier()
    clock("port_setup")
    driver.warm()
    lock.barrier()
    clock("warm")
    run.setup_s = time.perf_counter() - t_start

    profiled = tracer = None
    if trace:
        from repro_torch.obs.trace import Tracer

        from apssbench.kineto import Profiled

        if dev.type == "cuda":
            profiled = Profiled().__enter__()
        tracer = Tracer().__enter__()
    lock.barrier()
    t0 = time.perf_counter()
    end = t0
    i = 0
    while lock.go_on(end - t0 < seconds):  # rank 0's clock, outside every step's time
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
    card = Card(run.peak_bytes, int(max(pre_peak, run.peak_bytes)), run.trace, run.spans)
    cards = lock.gather(card)
    if cards is None:  # a rank other than 0: its records are with rank 0
        driver.free()
        return None
    run.cards = cards
    run.peak_bytes = max(c.peak_bytes for c in cards)
    out = report(run, trace)

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


def report(run: Run, trace: bool) -> dict:
    """The result line's metrics and device, read from ``run`` (every card
    of it in ``run.cards``): the device's peak is the fullest card's, its
    busy seconds the mean of the cards', and the breakdown sums each device
    operation's and each gap label's seconds over the cards."""
    cell, dev = run.cell, run.device
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": len(run.cards),
            "memory_peak_bytes": max(c.memory_peak_bytes for c in run.cards)}
    out = {"attempted": len(run.step_s), "metrics": metrics, "device": info}
    traces = [c.trace for c in run.cards if c.trace is not None]
    if traces:
        from apssbench.kineto import LEAD_LAUNCHES, ranked, summed

        info["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        info["window_s"] = run.window_s
        out["breakdown"] = {"device_ops": ranked(summed(t.op_ns() for t in traces)),
                            "idle_gaps": ranked(summed(t.gap_ns() for t in traces))}
        out["trace_lead"] = {"launches": LEAD_LAUNCHES, "records": run.trace.lead_records}
    if len(run.cards) > 1:
        info["cards"] = [{"memory_peak_bytes": c.memory_peak_bytes,
                          **({"busy_s": c.trace.busy_s} if c.trace is not None else {})}
                         for c in run.cards]
    if dev.type == "cuda":
        out["card"] = power_limit()
    return out


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
