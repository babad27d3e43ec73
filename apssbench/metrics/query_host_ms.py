"""Mean host milliseconds of the port's own ``serving/query`` span a batch,
under an ``obs.trace.Tracer``. The span holds the whole call: it waits on
the copies of the query mask and of the folded answers to the host, so it
reads the batch's time, the kernels' included, and not the host's staging
alone."""

from apssbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "serving/query")
