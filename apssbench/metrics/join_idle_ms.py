"""Mean device-idle milliseconds inside each host record named
``core/apss_blocked`` of the traced run: the port's self-join span as a
scope of kineto's trace, on the device records' clock
(``apssbench/scopes.py``). The span ends when ``apss_blocked`` returns,
before K1 finishes, so the join loop's wait on K1 and its copies to the host are
not counted."""

from apssbench.scopes import idle_ms


def read(run):
    return idle_ms(run, "core/apss_blocked")
