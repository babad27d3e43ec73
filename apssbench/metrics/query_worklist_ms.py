"""Mean host milliseconds of the port's ``serving/query/worklist`` span a
batch: the host worklist of live tiles (``compact_rect_worklist``) and its
bounds, numpy work that waits on nothing."""

from apssbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "serving/query/worklist")
