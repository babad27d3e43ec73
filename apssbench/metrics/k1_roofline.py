"""K1's share of its roofline over the traced window (``apssbench/roofline/k1.py``)."""

from apssbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1")
