"""Mean host milliseconds of the port's ``serving/query/mask`` span a batch:
padding the batch, its block stats, live mask and tile bounds on the
device, and their copies to the host, so it includes the batch's first
wait on the device (``repro_torch/serving/query.py``)."""

from apssbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "serving/query/mask")
