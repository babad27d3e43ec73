"""Live-corpus demo: a MutableAPSSIndex under continuous mutation.

Walks the live corpus end to end on a synthetic corpus: build, streamed
appends (delta joins), deletes (tombstones and exact graph repair),
compaction, queries through a version-keyed
:class:`~repro_torch.serving.server.RetrievalServer`, and a WAL reopen
(restore and replay), printing each op's host-clock time and the telemetry
counters. The closing check rebuilds the final corpus from scratch: the
standing graph must be bit-identical to the rebuild's, and the reopened
index's graph to the one before; the script exits non-zero otherwise.

On the CPU (the kernels' plain versions):

    PYTHONPATH=src python -m repro_torch.launch.live --device cpu \\
        --n 256 --m 64 --deltas 16 --rounds 2

Without ``--device`` it runs on the card (K4's masked entry in every dense
delta join).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch.obs import MetricsRegistry, Tracer, export
from repro_torch.planner import telemetry
from repro_torch.serving import MutableAPSSIndex, RetrievalServer


def _tick(label: str, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"  {label:<40} {1e3 * (time.perf_counter() - t0):8.1f} ms")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--deltas", type=int, default=32, help="rows per append batch")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--threshold", type=float, default=0.2)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the"
                         " mutation/serve loop to PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics snapshot to PATH (.prom/.txt ->"
                         " Prometheus text, otherwise JSON)")
    args = ap.parse_args(argv)

    tracer = Tracer() if args.trace_out else None
    registry = MetricsRegistry() if args.metrics_out else None
    with contextlib.ExitStack() as stack:
        if registry is not None:
            stack.enter_context(registry)
        if tracer is not None:
            stack.enter_context(tracer)
        failures = _run(args)
    if tracer is not None:
        export.write_chrome_trace(args.trace_out, tracer, registry)
        print(f"[obs] trace -> {args.trace_out}")
    if registry is not None:
        export.write_metrics(args.metrics_out, registry)
        print(f"[obs] metrics -> {args.metrics_out}")
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def _same_graph(a, b) -> bool:
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1].values, b[1].values)
            and np.array_equal(a[1].indices, b[1].indices)
            and np.array_equal(a[1].counts, b[1].counts))


def _run(args) -> list[str]:
    rng = np.random.default_rng(args.seed)
    D = rng.normal(size=(args.n, args.m)).astype(np.float32)
    kept: list[tuple[int, np.ndarray]] = []
    failures = []
    idx_kw = dict(threshold=args.threshold, k=args.k, block_rows=args.block,
                  device=args.device)

    with tempfile.TemporaryDirectory() as td, telemetry.CommLog() as log:
        wal = os.path.join(td, "live")
        print(f"live corpus: n={args.n} m={args.m} t={args.threshold} "
              f"k={args.k} device={args.device} (WAL at {wal})")
        idx = _tick(f"build ({args.n} rows)",
                    lambda: MutableAPSSIndex(D, directory=wal, **idx_kw))
        kept += [(g, D[g]) for g in range(args.n)]
        srv = RetrievalServer(idx, threshold=args.threshold, k=args.k, max_batch=8)
        Q = rng.normal(size=(8, args.m)).astype(np.float32)

        for r in range(args.rounds):
            new = rng.normal(size=(args.deltas, args.m)).astype(np.float32)
            gids = _tick(f"round {r}: append {args.deltas} (delta join)",
                         lambda: idx.append(new))
            kept += list(zip(gids, new))
            live = [g for g, _ in kept]
            victims = sorted(int(g) for g in rng.choice(live, size=args.deltas // 2,
                                                         replace=False))
            _tick(f"round {r}: delete {len(victims)} (graph repair)",
                  lambda: idx.delete(victims))
            gone = set(victims)
            kept = [(g, row) for g, row in kept if g not in gone]
            res = _tick(f"round {r}: serve 8 queries (cache ver {idx.version})",
                        lambda: srv.serve(list(Q)))
            if not all(x.status == "ok" for x in res):
                failures.append(f"round {r}: a query was not served: "
                                f"{[x.status for x in res]}")

        _tick("compact (tombstone rewrite)", idx.compact)
        before = idx.graph()

        # durability round trip: reopen from the WAL and the snapshots
        reopened = _tick("reopen from WAL (restore + replay)",
                         lambda: MutableAPSSIndex(corpus=None, directory=wal, **idx_kw))
        if not _same_graph(before, reopened.graph()):
            failures.append("the reopened index's graph differs from the one before")

        # the metamorphic invariant, live: fresh rebuild == mutated index
        surv = np.asarray([g for g, _ in kept], np.int64)
        fresh = _tick(f"oracle rebuild ({len(kept)} surviving rows)",
                      lambda: MutableAPSSIndex(np.stack([row for _, row in kept]),
                                               **idx_kw))
        _, og = fresh.graph()
        translated = (surv, og._replace(
            indices=np.where(og.indices >= 0, surv[np.maximum(og.indices, 0)], -1)))
        if _same_graph(before, translated):
            print(f"graph bit-identical to fresh rebuild over {idx.n} live rows "
                  f"(version {idx.version})")
        else:
            failures.append("the mutated graph differs from the fresh rebuild's")
        print(f"counters: {dict(sorted(log.counters.items()))}")
        joins = log.by_variant("serving/delta-join")
        lf = [j.live_fraction for j in joins if j.live_fraction]
        if lf:
            print(f"delta joins: {len(joins)} recorded, mean live-tile fraction "
                  f"{np.mean(lf):.2f}")
    return failures


if __name__ == "__main__":
    sys.exit(main())
