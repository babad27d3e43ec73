"""Execution tracing: a context-propagated span tree with zero idle cost.

The planner's :class:`~repro_torch.planner.telemetry.ApssStats` records are
*models*: shapes, modeled FLOPs, no wall-clock (except the
:class:`~repro_torch.distributed.straggler.StepTicker`). This module adds the
measured half: a :class:`Tracer` collects a tree of :class:`Span` objects
(monotonic ``perf_counter`` wall-clock, nesting, per-span attributes) from
the instrumented paths: the serving request lifecycle (admit → batch →
score → merge, with shed/degrade/retry events), the live index's WAL ops
and replay, checkpoint save/restore, and the distributed ring sweeps, whose
per-step ticks (``StepTicker``) become ``ring_step`` child spans at
finalize.

Span clocks are host clocks: a span ends when its Python call returns, and
no span synchronizes the card, so a span around queued device work measures
the enqueue unless the code inside it waits. The ring-step children are the
exception: a ticker settles its CUDA events when the tracer finalizes.
While ``torch.profiler`` records (``torch.autograd._profiler_enabled()``),
each span also opens ``torch.profiler.record_function(<span name>)`` for
its lifetime, errors included: the span is then a host scope of the
profiler's trace, on the clock of its device records, so a kineto trace
taken while a :class:`Tracer` is active names the port's stages beside the
kernels they launch. With no profiler recording, no ``record_function`` is
made.

Guard discipline mirrors ``telemetry.enabled()``: with no active
:class:`Tracer`, :func:`span` returns one shared no-op context manager and
:func:`event`/:func:`annotate` return immediately, so instrumented hot
paths allocate nothing and add no device work.

Entering a :class:`Tracer` also enters a private ``telemetry.CommLog``:
tracing alone turns on the record/ticker seams, and every ``ApssStats``
emitted during a span is pinned to it. This is the reference's
``repro.obs.trace``, span for span.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

import torch

from repro_torch.obs import recorder as _recorder
from repro_torch.planner import telemetry


class Span:
    """One timed node of the trace tree (times on the ``perf_counter``
    timeline of the owning :class:`Tracer`)."""

    __slots__ = (
        "name", "attrs", "t0", "t1", "parent", "children", "events",
        "status", "error", "records",
    )

    def __init__(self, name: str, attrs: dict, t0: float,
                 parent: Optional["Span"] = None):
        self.name = name
        self.attrs = dict(attrs)
        self.t0 = t0
        self.t1: Optional[float] = None
        self.parent = parent
        self.children: list[Span] = []
        # point events: (t, name, attrs)
        self.events: list[tuple[float, str, dict]] = []
        self.status = "ok"
        self.error: Optional[str] = None
        # ApssStats emitted while this span was current (telemetry hook)
        self.records: list = []

    @property
    def duration_s(self) -> float:
        end = self.t1 if self.t1 is not None else self.t0
        return max(0.0, end - self.t0)

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "duration_s": self.duration_s,
            "status": self.status,
            **({"error": self.error} if self.error else {}),
            "attrs": self.attrs,
            "events": [
                {"t": t, "name": n, "attrs": a} for t, n, a in self.events
            ],
            "children": [c.as_dict() for c in self.children],
        }


class Tracer:
    """Collects a span tree; context manager, stacked like ``CommLog``.

    ::

        with Tracer() as tr:
            with span("plan"):
                plan = plan_apss(D, 0.5, 32, mesh)
            with span("execute", config=plan.config.name):
                out = plan.run(D)
        export.write_chrome_trace("trace.json", tr)

    Entering also enters a private ``CommLog`` so the distributed sweeps
    create their ``StepTicker`` and emit ``ApssStats`` records; on exit
    (:meth:`finalize`) each recorded ticker is adapted into ``ring_step``
    child spans of the span that was current when its record fired, and
    per-step skew is observed into the active metrics registry (if any).
    """

    def __init__(self, *, clock=time.perf_counter):
        self.clock = clock
        self.root = Span("trace", {}, clock())
        self._open: list[Span] = [self.root]
        self._lock = threading.Lock()
        self._log: Optional[telemetry.CommLog] = None
        self.finalized = False

    # -- context ------------------------------------------------------------

    def __enter__(self) -> "Tracer":
        _STACK.append(self)
        self._log = telemetry.CommLog()
        self._log.__enter__()
        telemetry.add_record_hook(self._on_record)
        return self

    def __exit__(self, *exc) -> None:
        telemetry.remove_record_hook(self._on_record)
        if self._log is not None:
            self._log.__exit__(*exc)
            self._log = None
        if _STACK and _STACK[-1] is self:
            _STACK.pop()
        else:  # defensive: never leave a dead tracer active
            if self in _STACK:
                _STACK.remove(self)
        self.finalize()

    @property
    def log(self) -> Optional[telemetry.CommLog]:
        return self._log

    # -- span lifecycle ------------------------------------------------------

    def start(self, name: str, attrs: dict) -> Span:
        with self._lock:
            parent = self._open[-1]
            s = Span(name, attrs, self.clock(), parent)
            parent.children.append(s)
            self._open.append(s)
        return s

    def end(self, s: Span, *, error: Optional[str] = None) -> None:
        with self._lock:
            s.t1 = self.clock()
            if error is not None:
                s.status = "error"
                s.error = error
            # pop to (and including) s — tolerates a child left open by an
            # exception that skipped its __exit__
            while len(self._open) > 1:
                top = self._open.pop()
                if top.t1 is None:
                    top.t1 = s.t1
                if top is s:
                    break
        if _recorder.enabled():
            _recorder.note(
                "span", s.name, duration_s=s.duration_s, status=s.status,
                **s.attrs,
            )

    def current(self) -> Span:
        return self._open[-1]

    def add_event(self, name: str, attrs: dict) -> None:
        with self._lock:
            self._open[-1].events.append((self.clock(), name, attrs))

    # -- telemetry join ------------------------------------------------------

    def _on_record(self, stats) -> None:
        with self._lock:
            self._open[-1].records.append(stats)

    def finalize(self) -> None:
        """Close the root and adapt recorded StepTickers into ``ring_step``
        child spans (safe only after execution: settling a ticker waits
        for the CUDA events of its ticks)."""
        if self.finalized:
            return
        self.finalized = True
        if self.root.t1 is None:
            self.root.t1 = self.clock()
        from repro_torch.obs import metrics as _metrics
        for sp in list(self.root.walk()):
            for stats in sp.records:
                ticker = getattr(stats, "step_ticker", None)
                if ticker is None:
                    continue
                self._materialize_ring_steps(sp, stats, ticker, _metrics)

    def _materialize_ring_steps(self, sp: Span, stats, ticker, _metrics):
        by_step: dict[int, dict[int, float]] = {}
        for rank, step, t in ticker.tick_log():
            per = by_step.setdefault(step, {})
            per[rank] = max(t, per.get(rank, -1.0))
        prev = ticker.created
        for step in sorted(by_step):
            per = by_step[step]
            end = max(per.values())
            skew = (max(per.values()) - min(per.values())) if len(per) > 1 else 0.0
            child = Span(
                "ring_step",
                {"i": step, "variant": stats.variant, "skew_s": skew,
                 "ranks": len(per)},
                prev, sp,
            )
            child.t1 = end
            sp.children.append(child)
            if _metrics.enabled():
                _metrics.observe("sweep.step_time_s", end - prev)
                _metrics.observe("sweep.step_skew_s", skew)
            prev = end

    def walk(self) -> Iterator[Span]:
        return self.root.walk()

    def as_dict(self) -> dict:
        return self.root.as_dict()


_STACK: list[Tracer] = []


def enabled() -> bool:
    """True iff a :class:`Tracer` is active (instrumentation guard)."""
    return bool(_STACK)


def active() -> Optional[Tracer]:
    return _STACK[-1] if _STACK else None


class _NullSpanCtx:
    """Shared no-op: the disabled-path ``span()`` result. One instance for
    the whole process — the hot-path cost of disabled tracing is a list
    truthiness check plus returning this singleton."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpanCtx()


class _SpanCtx:
    __slots__ = ("_name", "_attrs", "_span", "_scope")

    def __init__(self, name: str, attrs: dict):
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None
        self._scope = None  # the profiler's record_function, while it records

    def __enter__(self) -> Optional[Span]:
        t = active()
        if t is None:
            return None
        if torch.autograd._profiler_enabled():
            self._scope = torch.profiler.record_function(self._name)
            self._scope.__enter__()
        self._span = t.start(self._name, self._attrs)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            t = active()
            if t is not None and self._span is not None:
                err = None if exc is None else repr(exc)
                t.end(self._span, error=err)
        finally:
            if self._scope is not None:
                self._scope.__exit__(exc_type, exc, tb)
                self._scope = None
        return False


def span(name: str, **attrs):
    """Open a child span of the current span (no-op when tracing is off)."""
    if not _STACK:
        return NULL_SPAN
    return _SpanCtx(name, attrs)


def event(name: str, **attrs) -> None:
    """Record a point event on the current span (and into any active flight
    recorder). No-op when neither sink is active."""
    t = active()
    if t is not None:
        t.add_event(name, attrs)
    if _recorder.enabled():
        _recorder.note("event", name, **attrs)


def annotate(**attrs) -> None:
    """Merge attributes into the current span (no-op when tracing is off)."""
    t = active()
    if t is not None:
        t.current().attrs.update(attrs)
