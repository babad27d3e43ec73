"""Process-local metrics registry: counters, gauges, exponential histograms.

The registry absorbs the existing ``telemetry.incr`` counter namespace: on
``__enter__`` it subscribes to the telemetry counter hook, so every
``serving.shed`` / ``sweep.checkpoints`` / ``mutable.replayed_ops``
increment lands in both the active :class:`~repro_torch.planner.telemetry.CommLog`
and here — the two views never diverge. On top of counters it adds gauges
and exponential-bucket histograms for the measured distributions the
CommLog cannot hold: serving latency (p50/p95/p99), batch occupancy, cache
hit rate, live-tile fraction, per-ring-step time and skew.

Histogram design: bucket ``i`` covers ``(base**(i-1), base**i]`` with
``base = 2**0.25`` (≈ 19 % wide), so any quantile read off the geometric
bucket midpoint is within ~9 % relative error of the true sample quantile
— asserted against numpy in ``tests/test_torch_obs.py``. Non-positive samples
land in a dedicated zero bucket (latencies and fractions are ≥ 0).

Snapshots: :meth:`MetricsRegistry.snapshot` (JSON-ready dict) and
:meth:`MetricsRegistry.to_prometheus` (text exposition format; histograms
as quantile summaries). Module-level :func:`incr`/:func:`observe`/
:func:`gauge` no-op when no registry is active — same guard discipline as
``telemetry``.
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.planner import telemetry

_DEFAULT_BASE = 2.0 ** 0.25


class Histogram:
    """Exponential-bucket histogram over positive samples."""

    __slots__ = ("base", "_log_base", "buckets", "zeros", "count", "total",
                 "min", "max")

    def __init__(self, base: float = _DEFAULT_BASE):
        if base <= 1.0:
            raise ValueError("histogram base must be > 1")
        self.base = base
        self._log_base = math.log(base)
        self.buckets: dict[int, int] = {}
        self.zeros = 0            # samples ≤ 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= 0.0:
            self.zeros += 1
            return
        # bucket i covers (base**(i-1), base**i]
        i = math.ceil(math.log(v) / self._log_base - 1e-9)
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def quantile(self, q: float) -> float:
        """Sample quantile from the bucket CDF (geometric bucket midpoint,
        clamped to the observed [min, max])."""
        if self.count == 0:
            return math.nan
        q = min(1.0, max(0.0, q))
        target = q * (self.count - 1) + 1  # 1-indexed rank, linear in q
        cum = self.zeros
        if cum >= target:
            return max(self.min, 0.0) if self.zeros < self.count else self.min
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= target:
                mid = self.base ** (i - 0.5)
                return min(self.max, max(self.min, mid))
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s samples into this histogram, in place.

        Bucket-wise exact (same-``base`` histograms partition the axis
        identically, so merged quantiles equal the quantiles of the
        concatenated sample streams up to the usual bucket-midpoint
        error). Used to aggregate per-CI-matrix-cell metrics artifacts.
        """
        if abs(other.base - self.base) > 1e-12:
            raise ValueError(
                f"cannot merge histograms with different bases "
                f"({self.base} vs {other.base})"
            )
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        self.zeros += other.zeros
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Stacked context manager holding counters/gauges/histograms.

    ::

        with MetricsRegistry() as reg:
            server.serve(queries)           # telemetry.incr -> reg.counters
            metrics.observe("serving.latency_s", dt)
        print(reg.snapshot()["histograms"]["serving.latency_s"]["p99"])
    """

    def __init__(self, *, base: float = _DEFAULT_BASE):
        self._base = base
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    # -- context -------------------------------------------------------------

    def __enter__(self) -> "MetricsRegistry":
        _STACK.append(self)
        telemetry.add_counter_hook(self._on_incr)
        return self

    def __exit__(self, *exc) -> None:
        telemetry.remove_counter_hook(self._on_incr)
        if _STACK and _STACK[-1] is self:
            _STACK.pop()
        elif self in _STACK:
            _STACK.remove(self)

    def _on_incr(self, name: str, n: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    # -- instruments ---------------------------------------------------------

    def incr(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(self._base)
        h.observe(value)

    def histogram(self, name: str) -> Optional[Histogram]:
        return self.histograms.get(name)

    # -- aggregation ---------------------------------------------------------

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` into this registry, in place: counters add,
        histograms bucket-merge, gauges take ``other``'s value when both
        set one (last-writer-wins — gauges are point-in-time readings,
        not accumulable). Aggregates per-shard / per-CI-matrix-cell
        metrics artifacts into one fleet view."""
        for name, v in other.counters.items():
            self.counters[name] = self.counters.get(name, 0) + v
        self.gauges.update(other.gauges)
        for name, h in other.histograms.items():
            mine = self.histograms.get(name)
            if mine is None:
                mine = self.histograms[name] = Histogram(h.base)
            mine.merge(h)
        return self

    # -- exposition ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready snapshot: counters, gauges, histogram summaries, and
        derived ratios (cache hit rate) when their inputs are present."""
        out = {
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "histograms": {
                k: h.snapshot() for k, h in sorted(self.histograms.items())
            },
        }
        hits = self.counters.get("serving.cache_hits")
        reqs = self.counters.get("serving.requests")
        if hits is not None and reqs:
            out["derived"] = {"serving.cache_hit_rate": hits / reqs}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters as ``_total``, histograms
        as quantile summaries)."""
        lines: list[str] = []
        for name, v in sorted(self.counters.items()):
            mn = _prom_name(name) + "_total"
            lines.append(f"# TYPE {mn} counter")
            lines.append(f"{mn} {_prom_num(v)}")
        for name, v in sorted(self.gauges.items()):
            mn = _prom_name(name)
            lines.append(f"# TYPE {mn} gauge")
            lines.append(f"{mn} {_prom_num(v)}")
        for name, h in sorted(self.histograms.items()):
            mn = _prom_name(name)
            lines.append(f"# TYPE {mn} summary")
            for q in (0.5, 0.9, 0.95, 0.99):
                lines.append(
                    f'{mn}{{quantile="{q}"}} {_prom_num(h.quantile(q))}'
                )
            lines.append(f"{mn}_sum {_prom_num(h.total)}")
            lines.append(f"{mn}_count {h.count}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return "repro_" + out


def _prom_num(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return repr(float(v)) if not float(v).is_integer() else str(int(v))


_STACK: list[MetricsRegistry] = []


def enabled() -> bool:
    """True iff a registry is active (instrumentation guard)."""
    return bool(_STACK)


def active() -> Optional[MetricsRegistry]:
    return _STACK[-1] if _STACK else None


def incr(name: str, n: float = 1) -> None:
    for reg in _STACK:
        reg.incr(name, n)


def gauge(name: str, value: float) -> None:
    for reg in _STACK:
        reg.gauge(name, value)


def observe(name: str, value: float) -> None:
    """Observe ``value`` into histogram ``name`` in every active registry
    (no-op when none is active)."""
    for reg in _STACK:
        reg.observe(name, value)
