"""Compile-time observability: the build/load registry, no-rebuild contracts,
measured calls and call-site capture.

The reference's ``repro.obs.compile`` counts jit retraces and reads XLA's
``memory_analysis()``. Eager PyTorch traces nothing; what the port compiles
is its kernel libraries. So here:

- :class:`CompileMonitor` (module singleton :data:`MONITOR`) holds
  :attr:`~CompileMonitor.counts` per kernel library. A "trace" is one
  build of a library (an ``nvcc`` run) or one load (a ``ctypes.CDLL``):
  ``kernels/_build.py``'s ``build`` and ``load`` call :func:`mark` with
  the library's name. Hot-path groups are registered by name
  (:func:`register_entry_points`): ``"serving.query"`` (the libraries
  ``query_topk`` launches) and ``"serving.mutable"`` (the live index's).
- :func:`assert_no_retrace` is the budget contract, with the reference's
  semantics: inside the context a watched library that is built or loaded
  fires every active :class:`~repro_torch.obs.recorder.FlightRecorder`
  (reason ``compile.retrace.<name>``) and raises :class:`RetraceError` at
  mark time, so the call that loaded it is still on the stack; on exit a
  direct bump of the counter is caught too. A warmed query batch builds
  and loads nothing.
- :meth:`CompileMonitor.measure` is the port's counterpart of
  ``lower_and_compile``: it runs the call once under the op census
  (``launch.op_analysis``) inside a ``compile/<name>`` span and returns
  ``(result, record)``, the :class:`CompileRecord` holding the call's
  host wall, the ``nvcc`` seconds it spent, its memory and the libraries
  it launched, and the census as ``record.analysis``. It is the workhorse
  of :mod:`repro_torch.obs.audit`.
- :func:`capture_calls` / :func:`offer_capture`, unchanged: host-staged call
  sites (the serving and live-index inners, whose worklists are built on
  the host) hand one real ``(fn, args, kwargs)`` triple to the audit, which
  replays it under :meth:`~CompileMonitor.measure`.

Guard discipline matches the rest of ``obs``: counting is always on (one
``Counter`` increment per build or load, not per call); contracts, spans,
metrics and recorder notes cost nothing unless their sink is active.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import types
from typing import Iterator, Optional

import torch

from repro_torch.obs import metrics, recorder, trace


class RetraceError(RuntimeError):
    """A kernel library was built or loaded under an active no-retrace
    contract."""


@dataclasses.dataclass
class CompileRecord:
    """One measured call (:meth:`CompileMonitor.measure`).

    ``t_lower_s`` is the call's host wall, to a ``torch.cuda.synchronize()``
    on a card; ``t_compile_s`` the ``nvcc`` seconds spent in it (0 when
    every library was built already; summed over libraries, whose builds
    run together); ``argument_bytes`` and ``output_bytes`` the bytes of the
    tensors in the arguments and the result; ``temp_bytes`` the peak CUDA
    allocation of the call above its arguments and outputs (0 on the CPU,
    which reports none); ``code_bytes`` the sizes of the libraries it
    launched, and ``kernels`` their ``ptxas`` rows (registers, static
    shared memory, spills).
    """

    name: str
    t_lower_s: float
    t_compile_s: float
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    code_bytes: int = 0
    kernels: list = dataclasses.field(default_factory=list)
    analysis: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        """Peak live-buffer footprint: arguments + outputs + temporaries."""
        return self.argument_bytes + self.output_bytes + self.temp_bytes

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "t_lower_s": self.t_lower_s,
            "t_compile_s": self.t_compile_s,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "code_bytes": self.code_bytes,
            "total_bytes": self.total_bytes,
            "kernels": list(self.kernels),
        }


@dataclasses.dataclass
class CapturedCall:
    """One call site offered to :func:`capture_calls`."""

    name: str
    fn: object
    args: tuple
    kwargs: dict


class _NoRetraceContract:
    """Snapshot-on-enter budget: watched counters must not move."""

    __slots__ = ("monitor", "names", "baseline", "watch_all", "violated")

    def __init__(self, monitor: "CompileMonitor", names: tuple):
        self.monitor = monitor
        self.names = names
        self.watch_all = not names
        self.baseline: dict = {}
        self.violated: set = set()

    def __enter__(self) -> "_NoRetraceContract":
        counts = self.monitor.counts
        watched = self.names if self.names else tuple(counts)
        self.baseline = {n: counts[n] for n in watched}
        self.monitor._contracts.append(self)
        return self

    def __exit__(self, exc_type, *exc) -> None:
        stack = self.monitor._contracts
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if exc_type is not None:
            return  # already failing (possibly with our own RetraceError)
        # A direct bump of a counter (one that bypassed mark()) is caught
        # here; names already raised at mark time are not raised again.
        counts = self.monitor.counts
        for n in (counts if self.watch_all else self.names):
            if n not in self.violated and counts[n] > self.baseline.get(n, 0):
                self.violated.add(n)
                self.monitor._violate(n, self.baseline.get(n, 0))

    def check(self, name: str) -> None:
        if not self.watch_all and name not in self.names:
            return
        if name in self.violated:
            return
        allowed = self.baseline.get(name, 0)
        if self.monitor.counts[name] > allowed:
            self.violated.add(name)
            self.monitor._violate(name, allowed)


class CompileMonitor:
    """Public registry of build/load counts, contracts and measured calls."""

    def __init__(self) -> None:
        self.counts: collections.Counter = collections.Counter()
        self.records: list[CompileRecord] = []
        self.groups: dict[str, tuple[str, ...]] = {}
        self._contracts: list[_NoRetraceContract] = []

    # -- build/load registry ---------------------------------------------

    def mark(self, name: str) -> None:
        """Count one build or load of kernel library ``name``."""
        self.counts[name] += 1
        if metrics.enabled():
            metrics.incr(f"compile.traces.{name}")
        if recorder.enabled():
            recorder.note("compile", name, count=self.counts[name])
        for c in reversed(self._contracts):
            c.check(name)

    def snapshot(self) -> dict:
        """Plain dict copy of the current counts (the public read API)."""
        return dict(self.counts)

    def register_entry_points(self, group: str, *names: str) -> None:
        """Declare a named hot-path group for :meth:`assert_no_retrace`."""
        self.groups[group] = tuple(names)

    def _resolve(self, names: tuple) -> tuple:
        out: list[str] = []
        for n in names:
            out.extend(self.groups.get(n, (n,)))
        return tuple(dict.fromkeys(out))

    def assert_no_retrace(self, *names: str) -> _NoRetraceContract:
        """Context manager: watched libraries must not be built or loaded
        inside.

        ``names`` are library names and/or registered group names
        (``"serving.query"``, ``"serving.mutable"``); with no names, EVERY
        library is watched. A violation fires the flight recorder (reason
        ``compile.retrace.<name>``) and raises :class:`RetraceError` at the
        build or load.
        """
        return _NoRetraceContract(self, self._resolve(names))

    def _violate(self, name: str, allowed: int) -> None:
        count = self.counts[name]
        if metrics.enabled():
            metrics.incr("compile.retrace_violations")
        recorder.trigger(
            f"compile.retrace.{name}",
            entry_point=name, count=count, allowed=allowed,
        )
        raise RetraceError(
            f"kernel library '{name}' built or loaded under a no-retrace "
            f"contract (builds and loads {count} > budget {allowed}): the hot "
            "path was not warmed, or its library cache was dropped (see the "
            "flight-record dump for the lead-up)"
        )

    # -- measured calls --------------------------------------------------

    def measure(self, fn, *args, name: Optional[str] = None, **kwargs):
        """``fn(*args, **kwargs)`` once, with full accounting: the port's
        counterpart of the reference's ``CompileMonitor.lower_and_compile``
        (eager PyTorch has nothing to lower, so the call runs).

        Runs the call under ``launch.op_analysis.analyze`` inside a
        ``compile/<name>`` span carrying the wall and ``nvcc`` seconds,
        appends a :class:`CompileRecord` (see its fields) and returns
        ``(result, record)``; ``record.analysis`` is the census.
        """
        from repro_torch.kernels import _build
        from repro_torch.launch import op_analysis

        label = name or getattr(fn, "__name__", None) or repr(fn)
        arg_bytes, devices = _tensor_bytes((args, kwargs))
        cuda = any(d.type == "cuda" for d in devices)
        with trace.span(f"compile/{label}"):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            nvcc0 = sum(_build.BUILD_SECONDS.values())
            t0 = time.perf_counter()
            result, analysis = op_analysis.analyze(fn, *args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
            t_call = time.perf_counter() - t0
            t_nvcc = sum(_build.BUILD_SECONDS.values()) - nvcc0
            trace.annotate(t_lower_s=t_call, t_compile_s=t_nvcc)
        out_bytes, _ = _tensor_bytes(result)
        temp = 0
        if cuda:
            temp = max(0, torch.cuda.max_memory_allocated() - base - out_bytes)
        libs = analysis["libraries"]
        rec = CompileRecord(
            name=label, t_lower_s=t_call, t_compile_s=t_nvcc,
            argument_bytes=arg_bytes, output_bytes=out_bytes, temp_bytes=temp,
            code_bytes=sum(_build.library_path(lib).stat().st_size for lib in libs),
            kernels=[dict(row, library=lib) for lib in libs
                     for row in _build.ptxas_report(lib)],
            analysis=analysis,
        )
        self.records.append(rec)
        if metrics.enabled():
            metrics.observe("compile.lower_s", t_call)
            metrics.observe("compile.compile_s", t_nvcc)
        if recorder.enabled():
            recorder.note(
                "compile.aot", label,
                t_compile_s=t_nvcc, total_bytes=rec.total_bytes,
            )
        return result, rec

    def reset(self) -> None:
        """Drop counts and records (test isolation only)."""
        self.counts.clear()
        self.records.clear()


def _tensor_bytes(obj, depth: int = 4) -> tuple[int, set]:
    """Bytes of the distinct tensors reachable from ``obj`` (containers,
    named tuples and objects' attributes, ``depth`` levels down) and their
    devices."""
    seen: set = set()
    devices: set = set()
    total = 0

    def walk(x, d):
        nonlocal total
        if id(x) in seen or d < 0:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
            devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v, d - 1)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v, d - 1)
        elif hasattr(x, "__dict__") and not (callable(x) or isinstance(x, types.ModuleType)):
            for v in vars(x).values():
                walk(v, d - 1)

    walk(obj, depth)
    return total, devices


# ---------------------------------------------------------------------------
# Module singleton + functional API
# ---------------------------------------------------------------------------

MONITOR = CompileMonitor()


def mark(name: str) -> None:
    """Count one build or load of ``name`` on the module :data:`MONITOR`."""
    MONITOR.mark(name)


def snapshot() -> dict:
    return MONITOR.snapshot()


def register_entry_points(group: str, *names: str) -> None:
    MONITOR.register_entry_points(group, *names)


def entry_points(group: str) -> tuple[str, ...]:
    """The registered library names of a hot-path group."""
    return MONITOR.groups.get(group, ())


def assert_no_retrace(*names: str) -> _NoRetraceContract:
    return MONITOR.assert_no_retrace(*names)


def measure(fn, *args, name: Optional[str] = None, **kwargs):
    return MONITOR.measure(fn, *args, name=name, **kwargs)


# ---------------------------------------------------------------------------
# Call-site capture (audit seam)
# ---------------------------------------------------------------------------

_CAPTURE: Optional[dict] = None


@contextlib.contextmanager
def capture_calls() -> Iterator[dict]:
    """Collect ``offer_capture``'d call sites into the yielded dict.

    The first offer per name wins (the audit wants one representative
    call, not every batch). Nests by shadowing: the inner context sees a
    fresh dict, the outer resumes on exit.
    """
    global _CAPTURE
    prev, _CAPTURE = _CAPTURE, {}
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = prev


def offer_capture(name: str, fn, *args, **kwargs) -> None:
    """Record a call site for later replay (no-op unless a
    :func:`capture_calls` context is active — one ``is None`` check)."""
    if _CAPTURE is not None and name not in _CAPTURE:
        _CAPTURE[name] = CapturedCall(name, fn, args, dict(kwargs))
