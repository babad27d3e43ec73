"""Serving entry point, retrieval mode: build an APSS index once over a
synthetic sparse corpus, then stream perturbed-row queries through a
retrieval server and report QPS.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieval \\
        --corpus-n 4096 --corpus-m 2048 --requests 64 --batch 8

Scoring runs on the card through the rectangular kernels
(``use_kernel=True``); ``--device cpu`` runs their plain versions. A run in
which any batch was retried or served by a lower tier than the first exits
non-zero after its report: its QPS is not the first tier's. The
reference's ``--mode lm`` and ``--mode auto`` wait for ROADMAP queue 1
items 9 and 5, ``--chaos`` and the trace/metrics exports for item 7.
"""

from __future__ import annotations

import argparse
import contextlib
import time


def run_retrieval(args) -> dict:
    """Retrieval mode: index once, serve the query stream, report QPS."""
    import torch

    from repro_torch.data.sparse import perturbed_queries, sparse_clustered_corpus
    from repro_torch.serving import ContinuousRetrievalServer, RetrievalServer, build_index

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    sp = sparse_clustered_corpus(
        args.corpus_n, args.corpus_m, args.avg_nnz, n_clusters=16, seed=0,
        device=args.device,
    )
    sync()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_index(sp, block_rows=args.block, normalize=False, device=args.device)
    sync()
    t_build = time.perf_counter() - t0
    qs = list(perturbed_queries(sp, args.requests, seed=1))
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms else None

    def make_server():
        kwargs = dict(
            threshold=args.threshold, k=args.k, max_batch=args.batch,
            deadline_s=deadline_s, max_retries=2, backoff_s=0.001,
            use_kernel=torch.device(args.device).type == "cuda",
        )
        if args.server == "continuous":
            return ContinuousRetrievalServer(index, workers=args.workers, **kwargs)
        return RetrievalServer(index, **kwargs)

    # Warm up (kernel builds, allocator) on a throwaway server, then time a
    # fresh one whose cache holds nothing yet.
    with contextlib.closing(make_server()) as warm:
        warm.serve(qs[: args.batch])
    srv = make_server()
    with contextlib.closing(srv):
        t0 = time.perf_counter()
        results = srv.serve(qs)
        dt = time.perf_counter() - t0
    report = dict(
        n=sp.n, m=sp.m, gen_s=t_gen, build_s=t_build, server=args.server,
        queries=len(results), seconds=dt, qps=len(results) / dt, batch=args.batch,
        matches=sum(r.count for r in results),
        ok=sum(r.status == "ok" for r in results), stats=srv.stats._asdict(),
    )
    print(
        f"[serve] corpus n={sp.n} m={sp.m} (gen {t_gen:.1f}s) index build {t_build:.2f}s"
    )
    print(
        f"[serve] {args.server} server: {len(results)} queries in {dt:.3f}s "
        f"({len(results) / dt:.1f} QPS, batch {args.batch}, "
        f"{1e3 * dt / len(results):.2f} ms/query), {report['matches']} matches, "
        f"{report['ok']} exact, stats={srv.stats}"
    )
    if srv.stats.degraded or srv.stats.retries:
        raise SystemExit(f"[serve] scoring was retried or degraded: stats={srv.stats}")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["retrieval"], default="retrieval")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--corpus-n", type=int, default=4096)
    ap.add_argument("--corpus-m", type=int, default=2048)
    ap.add_argument("--avg-nnz", type=float, default=16.0)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--server", choices=["step", "continuous"], default="continuous",
                    help="step-boundary batching or slot-granularity continuous batching")
    ap.add_argument("--workers", type=int, default=2,
                    help="continuous server: concurrent scoring workers")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; late requests are shed, not served")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' scores through the kernels; 'cpu' runs the plain versions")
    return run_retrieval(ap.parse_args(argv))


if __name__ == "__main__":
    main()
