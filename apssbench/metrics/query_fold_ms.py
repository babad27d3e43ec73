"""Mean host milliseconds of the port's ``serving/query/fold`` span a batch:
``fold_rect_packets``, which sizes its buffer from a count on the device
and so waits there for the scoring kernel (K4) to finish; it reads K4's
device time as well as the fold's."""

from apssbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "serving/query/fold")
