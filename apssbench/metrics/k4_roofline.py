"""K4's share of its roofline over the traced window (``apssbench/roofline/k4.py``)."""

from apssbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k4")
