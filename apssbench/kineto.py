"""The traced run's device time, read from kineto's raw events.

``Profiled`` opens ``torch.profiler`` over the measured window. On an H100
kineto drops the first device records of a trace as out of its window, so
the trace opens with ``LEAD_LAUNCHES`` throwaway launches of
``torch.cuda._sleep`` inside the host scope ``LEAD_SCOPE``: they take that
loss and are left out of every figure. Device time counts kernels, memcpys
and memsets, not the device-side spans of ``record_function`` scopes.
Reading raw events skips torch's tree of ``FunctionEvent``\\ s, which takes
minutes to build for 10⁵ launches.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

LEAD_LAUNCHES = 1024
LEAD_SCOPE = "apssbench.profile_lead"
LEAD_KERNEL = "spin_kernel"
GAPS_LABELLED = 1000  # the longest idle gaps that the breakdown labels


class Trace:
    """The device records (name, start ns, end ns) of the window, the lead
    left out, and the host records (start ns, end ns, name) of every
    thread."""

    def __init__(self, device: list, host: list, lead_records: int):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host
        self.lead_records = lead_records

    @property
    def busy_s(self) -> float:
        return sum(b - a for _, a, b in self.device) / 1e9

    def seconds_of(self, names) -> float:
        """Device seconds of the records whose name holds any of ``names``."""
        return sum(b - a for nm, a, b in self.device if any(s in nm for s in names)) / 1e9

    def op_ns(self) -> dict:
        """Device nanoseconds by operation name."""
        by = defaultdict(int)
        for nm, a, b in self.device:
            by[nm] += b - a
        return by

    def gap_ns(self) -> dict:
        """Idle nanoseconds between device records by what the host was
        doing: each of the ``GAPS_LABELLED`` longest gaps takes the name of
        the shortest host record spanning its middle (``host`` where none
        does)."""
        if len(self.device) < 2:
            return {}
        starts = np.array([a for _, a, _ in self.device], np.int64)
        ends = np.maximum.accumulate(np.array([b for _, _, b in self.device], np.int64))
        gap = starts[1:] - ends[:-1]
        order = np.argsort(-gap)[:GAPS_LABELLED]
        order = order[gap[order] > 0]
        if not len(order):
            return {}
        h0 = np.array([a for a, _, _ in self.host], np.int64)
        h1 = np.array([b for _, b, _ in self.host], np.int64)
        names = [nm for _, _, nm in self.host]
        by = defaultdict(int)
        for g in order:
            mid = (ends[g] + starts[g + 1]) // 2
            span = np.where((h0 <= mid) & (h1 >= mid), h1 - h0, np.iinfo(np.int64).max)
            label = names[int(np.argmin(span))] if len(span) and span.min() < np.iinfo(
                np.int64).max else "host"
            by[label] += int(gap[g])
        return by


def summed(by_trace) -> dict:
    """Nanoseconds by name, summed over several traces' ``op_ns()`` or
    ``gap_ns()`` (the cards of one run)."""
    total = defaultdict(int)
    for by in by_trace:
        for nm, ns in by.items():
            total[nm] += ns
    return total


def ranked(by: dict, n: int = 10) -> list:
    """The ``n`` names of ``by`` with the most nanoseconds, as ``[name, s]``."""
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[nm[:160], ns / 1e9] for nm, ns in top]


def read(prof) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    device, host, lead = [], [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if e.duration_ns() <= 0 or e.is_user_annotation():
                continue
            if LEAD_KERNEL in e.name():
                lead += 1
                continue
            device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() != LEAD_SCOPE:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    return Trace(device, host, lead)


class Profiled:
    """``with Profiled() as p: ...``: the block under the profiler, opened
    by the lead; ``p.trace`` afterwards."""

    def __enter__(self) -> "Profiled":
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        with record_function(LEAD_SCOPE):
            for _ in range(LEAD_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        self.trace = read(self.prof)
