"""Milliseconds a self-join: the window's host-clock time, to the end of
its last join (a ``synchronize()``), over the joins it completed."""


def read(run):
    joins = sum(run.step_items)
    return 1e3 * run.window_s / joins if joins else None
