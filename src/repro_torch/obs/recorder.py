"""Flight recorder: bounded ring buffer of recent events, auto-dumped on
failure triggers — postmortems for the chaos lane.

A :class:`FlightRecorder` keeps the last ``capacity`` observability events
(span closures and point events fed by ``obs.trace``, plus anything noted
directly) in a ``deque``. It costs O(1) per event and never grows; when a
failure trigger fires the buffer is snapshotted — to a JSON artifact under
``directory`` when one is configured, and always onto ``.dumps`` in
memory — so the *lead-up* to the failure survives even though nobody was
watching.

Wired triggers (each calls :func:`trigger` only when a recorder is active,
so the instrumented paths stay free when observability is off):

- ``robust.faults.FaultPlan`` firing any armed fault (kill/delay/error/
  corruption) — reason ``fault:<kind>:<scope>``;
- the serving degradation ladder moving down a tier — reason
  ``serving.tier_down``;
- ``CheckpointManager.restore(fallback=True)`` skipping a corrupt step —
  reason ``checkpoint.corruption_fallback``.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional


class FlightRecorder:
    """Stacked context manager; see module docstring.

    Args:
      capacity: ring-buffer length (events beyond it are dropped oldest
        first).
      directory: where trigger dumps are written as
        ``flight_<seq>_<reason>.json``; None keeps dumps in memory only
        (``.dumps``).
    """

    def __init__(self, *, capacity: int = 512,
                 directory: Optional[str] = None,
                 clock=time.perf_counter):
        self.capacity = int(capacity)
        self.directory = directory
        self.clock = clock
        self.buffer: collections.deque = collections.deque(maxlen=capacity)
        # (reason, payload dict, path | None), newest last
        self.dumps: list[tuple[str, dict, Optional[str]]] = []

    def __enter__(self) -> "FlightRecorder":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if _STACK and _STACK[-1] is self:
            _STACK.pop()
        elif self in _STACK:
            _STACK.remove(self)

    def note(self, kind: str, name: str, **attrs) -> None:
        self.buffer.append(
            {"t": self.clock(), "kind": kind, "name": name, "attrs": attrs}
        )

    def trigger(self, reason: str, **attrs) -> dict:
        """Snapshot the ring buffer now; returns the dump payload."""
        payload = {
            "reason": reason,
            "t": self.clock(),
            "attrs": attrs,
            "events": list(self.buffer),
        }
        path = None
        if self.directory is not None:
            os.makedirs(self.directory, exist_ok=True)
            safe = "".join(
                c if c.isalnum() or c in "._-" else "_" for c in reason
            )
            path = os.path.join(
                self.directory, f"flight_{len(self.dumps):03d}_{safe}.json"
            )
            with open(path, "w") as f:
                json.dump(payload, f, indent=1)
        self.dumps.append((reason, payload, path))
        self.note("dump", reason, **attrs)
        return payload


_STACK: list[FlightRecorder] = []


def enabled() -> bool:
    """True iff a recorder is active (instrumentation guard)."""
    return bool(_STACK)


def active() -> Optional[FlightRecorder]:
    return _STACK[-1] if _STACK else None


def note(kind: str, name: str, **attrs) -> None:
    for r in _STACK:
        r.note(kind, name, **attrs)


def trigger(reason: str, **attrs) -> None:
    """Fire every active recorder's dump (no-op when none is active)."""
    for r in _STACK:
        r.trigger(reason, **attrs)
