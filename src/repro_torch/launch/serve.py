"""Serving entry point, three modes:

- ``--mode lm``: continuous-batch LM decode (:class:`LMServer`) over the
  transformer of ``--arch`` (any registered LM: qwen3-1.7b, qwen3-8b,
  minicpm3-4b, deepseek-moe-16b, arctic-480b) at its smoke config, GQA
  attention through K9 on the card:

      PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --requests 4

- ``--mode retrieval``: build an APSS index once over a synthetic sparse
  corpus, then stream perturbed-row queries through a retrieval server and
  report QPS. Scoring runs through the rectangular kernels
  (``use_kernel=True``). A run in which any batch was retried or served by
  a lower tier than the first exits non-zero after its report: its QPS is
  not the first tier's.

      PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieval \\
          --corpus-n 4096 --corpus-m 2048 --requests 64 --batch 8

- ``--mode auto``: calibrate the planner on the device (cached under
  ``$REPRO_CALIB_DIR``), plan the self-join of a synthetic sparse corpus
  (``planner.plan_apss``; ``--autotune`` times the top candidates), print
  the ranking, then run the chosen config cold and warm:

      PYTHONPATH=src python -m repro_torch.launch.serve --mode auto \
          --corpus-n 4096 --corpus-m 2048

``--device cpu`` runs the kernels' plain versions (and plans without
them). The live-corpus demo is ``repro_torch.launch.live``.

``--chaos`` (retrieval mode) serves the same traffic through a server with
a fresh seeded ``FaultPlan.chaos`` (``--chaos-seed``): step delays and two
transient errors of the scoring tier that runs on the device
(``serving.kernel`` on a card, ``serving.plain`` on the CPU). The run then
exits non-zero when no injected fault fired or when any ``ok`` answer
differs from one-shot ``query_topk`` on the same normalized queries; the
clean lane's rule (non-zero after any retry or degradation) holds without
it. A kernel fault that is not injected still raises. ``--trace-out PATH``
writes a Chrome/Perfetto trace of the run's spans, ``--metrics-out PATH``
a metrics snapshot (``.prom``/``.txt``: Prometheus text, else JSON), in
every mode:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieval \
        --device cpu --corpus-n 2048 --requests 64 --chaos \
        --trace-out trace.json --metrics-out metrics.json
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np


class LMServer:
    """Minimal batched LM server: a continuous batch of decode slots.

    A request takes a free slot and its prompt is fed token by token through
    decode steps; every step runs :func:`decode_step` over the whole batch.
    As in the reference, a step feeds the stepped slot's token and zeros to
    the other slots, and every slot's cache length advances on every step,
    so a request that joins later sees earlier steps' filler tokens in its
    cache. The cache is the model's (``make_cache``: K/V, or MLA's latent
    rows); an MoE layer routes the ``max_batch`` tokens of a step, so its
    capacity, and which tokens it drops, follow the reference's rule at
    ``T = max_batch``. ``params`` is a ``Transformer`` (from ``interop``, say); without
    it the model is initialised from ``seed`` on ``device``. ``last_logits``
    holds the last step's logits ``(max_batch, V)`` f32.
    """

    def __init__(self, cfg, *, max_batch: int = 8, max_len: int = 256, seed: int = 0,
                 params=None, device="cuda", use_kernel: bool | None = None):
        import torch

        from repro_torch.interop import device_of
        from repro_torch.models.transformer import init_transformer, make_cache

        self.device = device_of(device)
        self.cfg = cfg
        self.params = params if params is not None else init_transformer(
            cfg, generator=torch.Generator(self.device).manual_seed(seed), device=self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.cache = make_cache(cfg, max_batch, max_len, device=self.device)
        self.active = np.zeros(max_batch, bool)
        self.outputs: list = [[] for _ in range(max_batch)]
        self.last_logits = None

    def add_request(self, prompt_tokens) -> int:
        slot = int(np.argmin(self.active))
        assert not self.active[slot], "server full"
        self.active[slot] = True
        self.outputs[slot] = []
        # feed the prompt through decode steps (simple; a production server
        # would run a batched prefill into the cache region)
        for tok in prompt_tokens:
            self.step_token(slot, int(tok))
        return slot

    def step_token(self, slot: int, token: int) -> int:
        from repro_torch.models.transformer import decode_step

        tokens = np.zeros(self.max_batch, np.int32)
        tokens[slot] = token
        self.last_logits, self.cache = decode_step(
            self.params, self.cfg, self.cache, tokens, use_kernel=self.use_kernel
        )
        nxt = int(self.last_logits[slot].argmax())  # the first maximum, as jnp.argmax
        self.outputs[slot].append(nxt)
        return nxt

    def generate(self, slot: int, n: int) -> list:
        tok = self.outputs[slot][-1]
        for _ in range(n):
            tok = self.step_token(slot, tok)
        return self.outputs[slot][-n:]


def run_lm(args) -> dict:
    """LM mode: a few requests through :class:`LMServer` on the smoke config."""
    from repro_torch.configs import get_arch

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit("serve demo supports LM archs")
    cfg = arch.make_smoke_config()
    srv = LMServer(cfg, max_batch=max(2, args.requests), device=args.device)
    rng = np.random.default_rng(0)
    outs = []
    t0 = time.perf_counter()
    for r in range(args.requests):
        slot = srv.add_request(rng.integers(0, cfg.vocab_size, size=4))
        outs.append(srv.generate(slot, args.gen_tokens))
        print(f"[serve] request {r} slot {slot} → {outs[-1]}")
    dt = time.perf_counter() - t0
    total = args.requests * (args.gen_tokens + 4)
    print(f"[serve] {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    return dict(arch=args.arch, tokens=total, seconds=dt, outputs=outs)


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

    on_card = torch.device(args.device).type == "cuda"

    def make_server(chaos: bool = False):
        # Chaos lane: a fresh seeded FaultPlan per server (plans are
        # consumable): step delays and transient errors of the tier that
        # runs on the device exercise the retry and degradation machinery
        # under the traffic the clean lane measures.
        plan = None
        if chaos:
            from repro_torch.robust import FaultPlan

            plan = FaultPlan.chaos(
                args.chaos_seed, steps=max(1, args.requests // args.batch),
                kernel_errors=2, scope="serving",
                error_scope="serving.kernel" if on_card else "serving.plain",
            )
        kwargs = dict(
            threshold=args.threshold, k=args.k, max_batch=args.batch,
            deadline_s=deadline_s, max_retries=2, backoff_s=0.001,
            use_kernel=on_card, fault_plan=plan,
        )
        if args.server == "continuous":
            return ContinuousRetrievalServer(index, workers=args.workers, **kwargs)
        return RetrievalServer(index, **kwargs)

    # Warm up (kernel builds, allocator) on a throwaway server, then time a
    # fresh one whose cache holds nothing yet.
    with contextlib.closing(make_server()) as warm:
        warm.serve(qs[: args.batch])
    srv = make_server(chaos=args.chaos)
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
        + (f" chaos seed={args.chaos_seed}" if args.chaos else "")
    )
    print(
        f"[serve] {args.server} server: {len(results)} queries in {dt:.3f}s "
        f"({len(results) / dt:.1f} QPS, batch {args.batch}, "
        f"{1e3 * dt / len(results):.2f} ms/query), {report['matches']} matches, "
        f"{report['ok']} exact, stats={srv.stats}"
    )
    if args.chaos:
        fired = dict(srv.fault_plan.fired)
        differ = _differ_from_one_shot(index, srv, qs, results)
        report.update(fired=fired, differ=differ)
        print(f"[serve] chaos: injected {fired}; {len(differ)} ok answers differ from "
              f"one-shot query_topk")
        if not fired or differ:
            raise SystemExit(f"[serve] chaos lane failed: fired={fired}, differ={differ}")
    elif srv.stats.degraded or srv.stats.retries:
        raise SystemExit(f"[serve] scoring was retried or degraded: stats={srv.stats}")
    return report


def _differ_from_one_shot(index, srv, qs, results) -> list[int]:
    """Requests whose ``ok`` answer is not the one-shot ``query_topk`` of its
    query, normalized as the server normalizes it (one row of a zero-padded
    ``max_batch`` batch), bit for bit."""
    import torch

    from repro_torch.core.apss import normalize_rows
    from repro_torch.serving import query_topk

    rows = []
    for q in qs:
        Q = np.zeros((srv.max_batch, index.m), np.float32)
        Q[0] = q
        Q = torch.from_numpy(Q).to(index.device)
        rows.append((normalize_rows(Q) if srv.normalize else Q)[0])
    one = query_topk(index, torch.stack(rows), srv.threshold, srv.k, block_q=srv.block_q,
                     use_kernel=srv.use_kernel)
    v, i, c = (x.cpu().numpy() for x in one)
    return [r for r, res in enumerate(results) if res.status == "ok" and not (
        res.count == c[r] and np.array_equal(res.indices, i[r])
        and np.array_equal(res.values, v[r]))]


def run_auto(args) -> dict:
    """Auto mode: calibrate → plan (print it) → run the chosen config."""
    import torch

    from repro_torch.data.sparse import sparse_clustered_corpus
    from repro_torch.planner.calibrate import calibrate, profile_path
    from repro_torch.planner.plan import plan_apss

    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    sp = sparse_clustered_corpus(
        args.corpus_n, args.corpus_m, args.avg_nnz, n_clusters=16, seed=0,
        device=args.device,
    )
    print(f"[auto] corpus n={sp.n} m={sp.m} cap={sp.cap} "
          f"(gen {time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    profile = calibrate(save=True, device=args.device)
    print(
        f"[auto] calibrated {profile.device_kind} in {time.perf_counter() - t0:.1f}s "
        f"(matmul {profile.matmul_gflops:.1f} GF/s, gather "
        f"{profile.gather_gflops:.2f} GF/s, wire "
        f"{profile.collective_gbps:.2f} GB/s) -> {profile_path()}"
    )
    t0 = time.perf_counter()
    plan = plan_apss(sp, args.threshold, args.k, None, profile=profile,
                     autotune=args.autotune, device=args.device)
    print(f"[auto] planned in {time.perf_counter() - t0:.2f}s")
    print(plan.describe())
    t0 = time.perf_counter()
    plan.run()
    sync()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = plan.run()
    sync()
    warm = time.perf_counter() - t0
    n_match = int(res.counts.sum())
    print(
        f"[auto] ran {plan.config.name}: {warm * 1e3:.1f}ms warm "
        f"({cold * 1e3:.0f}ms cold), {n_match} matches; predicted "
        f"{plan.cost.total_s * 1e3:.1f}ms "
        f"({plan.cost.total_s / max(warm, 1e-9):.2f}x of measured)"
    )
    return dict(chosen=plan.config.name, profile=profile, cold_s=cold, warm_s=warm,
                predicted_s=plan.cost.total_s, matches=n_match, plan=plan.as_dict())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "retrieval", "auto"], default="retrieval")
    ap.add_argument("--arch", default="qwen3-1.7b", help="lm mode: the architecture")
    ap.add_argument("--gen-tokens", type=int, default=8, help="lm mode: tokens per request")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (default: 2 in lm mode, 64 in retrieval mode)")
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
                    help="'cuda' runs the kernels; 'cpu' runs their plain versions")
    ap.add_argument("--autotune", action="store_true",
                    help="auto mode: time the top planned candidates and run the fastest")
    ap.add_argument("--chaos", action="store_true",
                    help="retrieval mode: inject seeded faults (step delays + transient"
                         " scoring errors); exit non-zero if none fired or an answer differs")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the run to PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics snapshot to PATH (.prom/.txt -> Prometheus"
                         " text, otherwise JSON)")
    args = ap.parse_args(argv)

    from repro_torch.obs import MetricsRegistry, Tracer, export

    tracer = Tracer() if args.trace_out else None
    registry = MetricsRegistry() if args.metrics_out else None
    with contextlib.ExitStack() as stack:
        # Registry first, so that the tracer's finalize (on its exit) can
        # observe ring-step histograms into it.
        if registry is not None:
            stack.enter_context(registry)
        if tracer is not None:
            stack.enter_context(tracer)
        report = _run_mode(args)
    if tracer is not None:
        export.write_chrome_trace(args.trace_out, tracer, registry)
        print(f"[obs] trace -> {args.trace_out}")
    if registry is not None:
        export.write_metrics(args.metrics_out, registry)
        print(f"[obs] metrics -> {args.metrics_out}")
    return report


def _run_mode(args) -> dict:
    if args.mode == "lm":
        args.requests = 2 if args.requests is None else args.requests
        return run_lm(args)
    if args.mode == "auto":
        return run_auto(args)
    args.requests = 64 if args.requests is None else args.requests
    return run_retrieval(args)


if __name__ == "__main__":
    main()
