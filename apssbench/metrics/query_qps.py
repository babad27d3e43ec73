"""Queries answered in the window over the window's host-clock seconds
(to the moment the last batch's ``Matches`` were on the host)."""


def read(run):
    return sum(run.step_items) / run.window_s if run.window_s > 0 else None
