"""Chrome trace-event export: span trees → Perfetto / ``chrome://tracing``.

Emits the JSON *object* flavor of the trace-event format: a
``traceEvents`` list of complete (``"ph": "X"``) events — one per span,
``ts``/``dur`` in microseconds relative to the trace root — plus instant
(``"ph": "i"``) events for span point events, and thread-name metadata
(``"ph": "M"``) rows. Tracks (``tid``) are assigned one per *device-visible
phase*: the first path segment of each top-level span name (``plan``,
``execute``, ``serving``, ``sweep``, ``mutable``, ``checkpoint`` …), so
ring steps nest visually under their sweep while serving steps get their
own lane. A metrics snapshot (when a registry is passed) rides in
``otherData.metrics`` — Perfetto preserves it and ``jq`` can read it.

Spans whose ticker-derived children outlive them (async dispatch: the
wrapper returns before the device finishes) are widened to cover their
children, so the nesting renders correctly. For the same events the JSON
is the reference's (``repro.obs.export``) but for ``otherData.producer``,
which names this package.
"""

from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Span, Tracer


def _jsonable(v):
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v
    return str(v)


def _span_end(s: Span) -> float:
    end = s.t1 if s.t1 is not None else s.t0
    for c in s.children:
        end = max(end, _span_end(c))
    return end


def chrome_trace(tracer: Tracer,
                 registry: Optional[MetricsRegistry] = None) -> dict:
    """Build the trace-event JSON object for ``tracer`` (finalized or not;
    an unfinalized tracer is finalized first so ring-step children exist)."""
    tracer.finalize()
    t0 = tracer.root.t0
    events: list[dict] = []
    tracks: dict[str, int] = {}

    def tid_for(name: str) -> int:
        phase = name.split("/", 1)[0]
        if phase not in tracks:
            tracks[phase] = len(tracks) + 1
        return tracks[phase]

    def emit(s: Span, tid: Optional[int]) -> None:
        my_tid = tid_for(s.name) if tid is None else tid
        args = {k: _jsonable(v) for k, v in s.attrs.items()}
        if s.status != "ok":
            args["status"] = s.status
            if s.error:
                args["error"] = s.error
        if s.records:
            args["records"] = [r.variant for r in s.records]
        events.append({
            "name": s.name,
            "ph": "X",
            "ts": (s.t0 - t0) * 1e6,
            "dur": (_span_end(s) - s.t0) * 1e6,
            "pid": 1,
            "tid": my_tid,
            "cat": s.name.split("/", 1)[0],
            "args": args,
        })
        for t, name, attrs in s.events:
            events.append({
                "name": name,
                "ph": "i",
                "s": "t",
                "ts": (t - t0) * 1e6,
                "pid": 1,
                "tid": my_tid,
                "cat": "event",
                "args": {k: _jsonable(v) for k, v in attrs.items()},
            })
        for c in s.children:
            emit(c, my_tid)

    for top in tracer.root.children:
        emit(top, None)

    meta = [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": 1,
            "tid": tid,
            "args": {"name": phase},
        }
        for phase, tid in sorted(tracks.items(), key=lambda kv: kv[1])
    ]
    events.sort(key=lambda e: e["ts"])
    out = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs"},
    }
    if registry is not None:
        out["otherData"]["metrics"] = registry.snapshot()
    return out


def write_chrome_trace(path: str, tracer: Tracer,
                       registry: Optional[MetricsRegistry] = None) -> dict:
    """Write :func:`chrome_trace` to ``path``; returns the object."""
    doc = chrome_trace(tracer, registry)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def write_metrics(path: str, registry: MetricsRegistry) -> dict:
    """Write a registry snapshot (JSON, or Prometheus text when ``path``
    ends in ``.prom``/``.txt``); returns the snapshot dict."""
    snap = registry.snapshot()
    if path.endswith((".prom", ".txt")):
        with open(path, "w") as f:
            f.write(registry.to_prometheus())
    else:
        with open(path, "w") as f:
            json.dump(snap, f, indent=1)
            f.write("\n")
    return snap
