"""Mean device-idle milliseconds inside each host record named
``serving/query`` of the traced run: the port's ``query_topk`` span as a
scope of kineto's trace, on the device records' clock
(``apssbench/scopes.py``). Idle time between batches, outside the call,
is not counted."""

from apssbench.scopes import idle_ms


def read(run):
    return idle_ms(run, "serving/query")
