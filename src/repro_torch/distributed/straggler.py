"""Straggler detection: per-step timing ledger + slow-rank reporting.

On a synchronous cluster one slow rank stalls every step. The launcher
records per-step wall times per rank; ranks consistently slower than
``median × tolerance`` are reported (``StragglerReport.evict``) so that the
orchestration layer can drain or replace them at the next checkpoint.

:class:`StepTicker` stamps the steps of the ring sweeps
(``core.distributed._checkerboard_sweep`` and ``_nested_ring_sweep``): the
port's ring steps are Python loops, so each tick is a plain host call.
With telemetry on, ``apss_2d`` and the hierarchical schedule create one
when the caller passes none and attach it to their ``ApssStats`` record,
as the reference's do.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict, deque

import torch


@dataclasses.dataclass
class StragglerReport:
    rank_ema: dict
    median_ema: float
    evict: list
    tolerance: float

    def __str__(self) -> str:
        bad = ", ".join(
            f"rank{r}: {t*1e3:.1f}ms"
            for r, t in self.rank_ema.items()
            if r in self.evict
        )
        return (
            f"StragglerReport(median={self.median_ema*1e3:.1f}ms, "
            f"tolerance={self.tolerance}x, evict=[{bad}])"
        )


class StepTimer:
    """Per-rank step-time ledger with EMA-based straggler detection."""

    def __init__(self, *, ema: float = 0.9, tolerance: float = 1.5, window: int = 64):
        self.ema_coeff = ema
        self.tolerance = tolerance
        self.rank_ema: dict = {}
        self.history: dict = defaultdict(lambda: deque(maxlen=window))
        self._start: float | None = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, rank: int = 0) -> float:
        if self._start is None:
            raise RuntimeError("start() not called")
        dt = time.perf_counter() - self._start
        self._start = None
        self.record(rank, dt)
        return dt

    def record(self, rank: int, step_time: float) -> None:
        prev = self.rank_ema.get(rank)
        self.rank_ema[rank] = (
            step_time
            if prev is None
            else self.ema_coeff * prev + (1 - self.ema_coeff) * step_time
        )
        self.history[rank].append(step_time)

    def report(self) -> StragglerReport:
        if not self.rank_ema:
            return StragglerReport({}, 0.0, [], self.tolerance)
        times = sorted(self.rank_ema.values())
        median = times[len(times) // 2]
        evict = [
            r for r, t in self.rank_ema.items() if t > self.tolerance * median
        ]
        return StragglerReport(dict(self.rank_ema), median, evict, self.tolerance)


class StepTicker:
    """Per-step per-rank ticks of a ring sweep, on the host ``perf_counter``
    timeline.

    :meth:`emit` is called once per rank per ring step with ``dep``, a value
    the step computed. For a CPU ``dep`` the tick is stamped at once. For a
    CUDA ``dep`` a ``torch.cuda.Event`` is recorded on the device's current
    stream and nothing is stamped yet: settling (every reader below)
    synchronizes those events and places each tick at the creation stamp
    plus its ``elapsed_time`` from an event recorded at creation on
    ``device`` (default: the current CUDA device, where there is one). So a
    tick marks when the step's device work ended, not when it was enqueued
    (the counterpart of the reference's ``jax.effects_barrier``), provided
    the device's queue was idle when the ticker was created.

    ``step_times()[s]`` is the gap between the latest rank tick of step
    ``s`` and of step ``s-1`` (step 0 is measured from creation).
    :meth:`to_step_timer` folds per-rank deltas into a :class:`StepTimer`
    ledger so that ``report().evict`` names the slow ranks.
    """

    def __init__(self, device: str | torch.device | None = None):
        self._lock = threading.Lock()
        self.ticks: list[tuple[int, int, float]] = []  # (rank, step, t), settled
        self._pending: list = []  # (rank, step, event) of CUDA deps
        self._created = time.perf_counter()
        self._device = None  # the CUDA device of ``_base``, the creation event
        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available() else None)
        if dev is not None and dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self._device = dev
            self._base = torch.cuda.Event(enable_timing=True)
            self._base.record(torch.cuda.current_stream(dev))

    def emit(self, step, rank, dep) -> None:
        """Tick ``(step, rank)`` once ``dep``, computed by the step, is ready."""
        if isinstance(dep, torch.Tensor) and dep.is_cuda:
            if dep.device != self._device:
                raise ValueError(
                    f"a tick on {dep.device} from a ticker created for {self._device}"
                )
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dep.device))
            with self._lock:
                self._pending.append((int(rank), int(step), ev))
        else:
            with self._lock:
                self.ticks.append((int(rank), int(step), time.perf_counter()))

    def _settled(self) -> list[tuple[int, int, float]]:
        with self._lock:
            pending, self._pending = self._pending, []
        settled = []
        for rank, step, ev in pending:
            ev.synchronize()
            settled.append((rank, step, self._created + self._base.elapsed_time(ev) / 1e3))
        with self._lock:
            self.ticks.extend(settled)
            return list(self.ticks)

    @property
    def created(self) -> float:
        """``perf_counter`` stamp at ticker creation (step 0's baseline)."""
        return self._created

    def tick_log(self) -> list[tuple[int, int, float]]:
        """Settled ``(rank, step, t)`` ticks on the host ``perf_counter``
        timeline."""
        return self._settled()

    @property
    def n_steps(self) -> int:
        ticks = self._settled()
        return 1 + max((s for _, s, _ in ticks), default=-1)

    def step_times(self) -> tuple[float, ...]:
        """One wall-time entry per ring step (slowest rank sets the pace)."""
        ticks = self._settled()
        by_step: dict[int, float] = {}
        for _, s, t in ticks:
            by_step[s] = max(t, by_step.get(s, -1.0))
        out, prev = [], self._created
        for s in sorted(by_step):
            out.append(by_step[s] - prev)
            prev = by_step[s]
        return tuple(out)

    def to_step_timer(self, **timer_kwargs) -> StepTimer:
        """Fold per-rank step deltas into a :class:`StepTimer` ledger."""
        timer = StepTimer(**timer_kwargs)
        per_rank: dict[int, dict[int, float]] = defaultdict(dict)
        for r, s, t in self._settled():
            per_rank[r][s] = max(t, per_rank[r].get(s, -1.0))
        for r, by_s in per_rank.items():
            steps = sorted(by_s)
            if len(steps) == 1:
                timer.record(r, by_s[steps[0]] - self._created)
            for a, b in zip(steps, steps[1:]):
                timer.record(r, by_s[b] - by_s[a])
        return timer
