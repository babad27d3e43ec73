"""Shared arithmetic of the metric readers in ``apssbench/metrics/``."""

from __future__ import annotations

from apssbench.roofline import bound_s


def idle_pct(run):
    """Percent of the traced window in which no device operation ran."""
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)


def roofline_pct(run, kernel: str):
    """The kernel's share of its roofline over the traced window: the sum of
    each call's bound (``apssbench/roofline/<kernel>.py``) over the
    kernel's device seconds in the trace. ``None`` where the trace holds no
    record of the kernel or its count does not apply to the cell."""
    if run.trace is None:
        return None
    mod = run.cell.roofline(kernel)
    device_s = run.trace.seconds_of(mod.DEVICE_NAMES)
    counts = mod.count(run)
    if device_s <= 0 or counts is None:
        return None
    bounds = {key: bound_s(ops, nbytes)[0] for key, (ops, nbytes) in counts.items()}
    return 100.0 * sum(bounds[key] for key in run.step_keys) / device_s


def span_mean_ms(run, name: str):
    """Mean host milliseconds of the port's ``name`` spans in the window."""
    times = [s for nm, s in run.spans if nm == name]
    return 1e3 * sum(times) / len(times) if times else None
