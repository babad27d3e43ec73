"""Percent of the traced window in which no device operation ran (query cells)."""

from apssbench.readers import idle_pct


def read(run):
    return idle_pct(run)
