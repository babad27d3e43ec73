"""Device idle time inside the port's own host scopes of the traced run.

While a ``repro_torch.obs.trace.Tracer`` is active under ``torch.profiler``,
every port span is also a host record of kineto's trace, named as the span
and on the clock of the device records (``apssbench/kineto.py``). For a
scope name, :func:`idle_ms` clips the union of the device records (kernels,
memcpys, memsets) to each record of that name and returns the mean time in
which no device record ran.
"""

from __future__ import annotations

import numpy as np


def _busy_union(device: list) -> tuple[np.ndarray, np.ndarray]:
    """The device records ``(name, start, end)``, sorted by start, merged
    into disjoint busy intervals ``(starts, ends)`` in ns."""
    if not device:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    s = np.array([a for _, a, _ in device], np.int64)
    e = np.array([b for _, _, b in device], np.int64)
    reach = np.maximum.accumulate(e)
    first = np.ones(len(s), bool)
    first[1:] = s[1:] > reach[:-1]
    heads = np.flatnonzero(first)
    return s[heads], np.maximum.reduceat(e, heads)


def idle_ms(run, scope: str):
    """Mean device-idle milliseconds inside the host records named
    ``scope`` in ``run.trace.host``: for each record, its length less the
    time that the union of device records covers within it, summed and
    divided by the number of such records. ``None`` without a trace or
    without any record of that name (a program that does not open the
    scope)."""
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    scopes = [(a, b) for a, b, nm in trace.host if nm == scope]
    if not scopes:
        return None
    starts, ends = _busy_union(trace.device)
    idle = 0
    for a, b in scopes:
        lo = np.searchsorted(ends, a, side="right")  # the first interval ending after a
        hi = np.searchsorted(starts, b, side="left")  # past the last starting before b
        covered = np.minimum(ends[lo:hi], b) - np.maximum(starts[lo:hi], a)
        idle += (b - a) - int(np.clip(covered, 0, None).sum())
    return idle / len(scopes) / 1e6
