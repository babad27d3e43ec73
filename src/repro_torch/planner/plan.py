"""plan_apss: turn variant choice from folklore into a measured decision.

The paper's closing finding — "the performance depends on the dataset,
therefore a variety of parallelizations is useful" — left the *choice*
among the variety to the caller. This module closes that loop:

1. :func:`summarize_corpus` samples the corpus (never densifying a sparse
   one): density, realized row cap, Zipf skew of the posting-list
   histogram, and the live-tile fraction + per-block histogram of the
   paper's pruning bounds at the query threshold. The sample and its
   statistics are computed where the corpus lives; only counts come to
   the host.
2. :func:`candidate_configs` enumerates every valid
   ``(variant, block_rows, use_kernel)`` configuration for the given mesh
   (divisibility and backend constraints applied here, not at dispatch).
   Kernel candidates (K1 dense, K3 sparse) are offered where the run's
   device is CUDA, and nowhere else.
3. :func:`plan_apss` prices each candidate with the closed-form cost
   models (``planner.costmodel``, parameterized by the calibrated
   profile) and returns a ranked :class:`Plan`; with ``autotune=True``
   the best-predicted config of each of the top ``autotune_top``
   (default 3) variant families is additionally timed and the measured
   winner is chosen.

``core.apss.similarity_topk(..., variant="auto")``,
``core.distributed.apss(..., distribution="auto")``,
``serving.build_index(..., plan=...)`` and ``serving.query_topk(...,
plan=...)`` dispatch through here.

Under a mesh every rank plans for itself and must reach the same plan,
else ranks dispatch different variants and wait in each other's
collectives: the sample rows come from ``np.random.default_rng(seed)``
(the same on every rank for the same corpus), the profile is the one
``calibrate(mesh)`` agreed on rank 0, and autotuned times are agreed as
their maximum over the ranks (one all-reduce). A plan runs on the device
of the planned corpus (a ``device=`` passed through wins) and never falls
back to the CPU; autotune lets every error of a timed candidate raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import trace
from repro_torch.planner import calibrate as _calibrate
from repro_torch.planner.costmodel import (
    CalibrationProfile,
    CorpusSummary,
    CostEstimate,
    VariantConfig,
    estimate_cost,
    mesh_sizes,
)


# ---------------------------------------------------------------------------
# Corpus summary — sampled statistics, never densified
# ---------------------------------------------------------------------------


def _fit_zipf(hist: np.ndarray) -> float:
    """Least-squares Zipf exponent of a posting-list (document-frequency)
    histogram: slope of log(freq) vs log(rank) over the populated lists."""
    freq = np.sort(hist[hist > 0])[::-1].astype(np.float64)
    if freq.size < 4 or freq[0] == freq[-1]:
        return 0.0
    rank = np.arange(1, freq.size + 1, dtype=np.float64)
    x, y = np.log(rank), np.log(freq)
    slope = float(np.polyfit(x, y, 1)[0])
    return float(np.clip(-slope, 0.0, 4.0))


def _sample_rows(n: int, sample_rows: int, seed: int) -> np.ndarray:
    if n <= sample_rows:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=sample_rows, replace=False))


def _live_profile(stats, threshold: float) -> tuple[float, tuple[int, ...]]:
    """Self-join live fraction + per-row-block live counts from BlockStats."""
    from repro_torch.core.pruning import live_tile_mask

    mask = live_tile_mask(stats, stats, threshold).cpu().numpy()
    return float(mask.mean()), tuple(int(c) for c in mask.sum(axis=1))


def summarize_corpus(
    corpus,
    threshold: float,
    *,
    sample_rows: int = 2048,
    stats_block: int = 64,
    seed: int = 0,
) -> CorpusSummary:
    """Sampled planner-side statistics (see module doc).

    ``corpus`` is a dense ``(n, m)`` numpy array or tensor, a
    :class:`~repro_torch.core.sparse.SparseCorpus`, or a prebuilt
    :class:`~repro_torch.serving.index.APSSIndex` (whose corpus-side
    :class:`~repro_torch.core.pruning.BlockStats` give the live profile
    exactly, with no sampling pass at all).
    """
    from repro_torch.core.sparse import SparseCorpus
    from repro_torch.serving.index import APSSIndex

    if isinstance(corpus, APSSIndex):
        return _summarize_index(corpus, threshold)
    if isinstance(corpus, SparseCorpus):
        return _summarize_sparse(
            corpus, threshold, sample_rows=sample_rows,
            stats_block=stats_block, seed=seed,
        )
    return _summarize_dense(
        corpus, threshold, sample_rows=sample_rows,
        stats_block=stats_block, seed=seed,
    )


def _posting_hist(idx: torch.Tensor, nnz: torch.Tensor, m: int) -> np.ndarray:
    """Per-dimension count of the stored entries of ``(idx, nnz)`` rows,
    counted on their device; only the ``(m,)`` counts reach the host."""
    valid = torch.arange(idx.shape[1], device=idx.device)[None, :] < nnz[:, None]
    return torch.bincount(idx[valid].long(), minlength=m).cpu().numpy()


def _summarize_sparse(sp, threshold, *, sample_rows, stats_block, seed):
    from repro_torch.core.pruning import sparse_block_stats
    from repro_torch.core.sparse import SparseCorpus, pad_rows_sparse

    nnz = sp.nnz.cpu().numpy()
    n, m = sp.n, sp.m
    sel = _sample_rows(n, sample_rows, seed)
    rows = torch.from_numpy(sel).to(sp.device)
    sub = SparseCorpus(sp.indices[rows], sp.values[rows], sp.nnz[rows], m)
    hist = _posting_hist(sub.indices, sub.nnz, m)
    bs = min(stats_block, max(1, len(sel)))
    sub, _ = pad_rows_sparse(sub, bs)
    live, tiles = _live_profile(sparse_block_stats(sub, bs), threshold)
    return CorpusSummary(
        n=n, m=m, threshold=float(threshold), sparse_input=True,
        density=float(nnz.sum()) / float(n * m), cap=sp.cap,
        avg_nnz=float(nnz.mean()), zipf_alpha=_fit_zipf(hist),
        live_fraction=live, tile_counts=tiles, itemsize=4,
    )


def _summarize_dense(D, threshold, *, sample_rows, stats_block, seed):
    from repro_torch.core.pruning import dense_block_stats

    n, m = D.shape
    sel = _sample_rows(n, sample_rows, seed)
    if isinstance(D, torch.Tensor):
        size = D.element_size()
        S = D[torch.from_numpy(sel).to(D.device)].float()
    else:  # numpy (a memory-mapped corpus reads only the sampled rows)
        size = np.dtype(D.dtype).itemsize
        S = torch.from_numpy(np.asarray(D[sel], np.float32))
    itemsize = size if size in (2, 4) else 4
    nz = S != 0
    nnzs = nz.sum(dim=1).cpu().numpy()
    hist = nz.sum(dim=0).cpu().numpy()
    bs = min(stats_block, max(1, len(sel)))
    Sp = torch.nn.functional.pad(S, (0, 0, 0, (-len(sel)) % bs))
    live, tiles = _live_profile(dense_block_stats(Sp, bs), threshold)
    return CorpusSummary(
        n=n, m=m, threshold=float(threshold), sparse_input=False,
        density=float(nnzs.mean()) / float(m), cap=int(max(1, nnzs.max(initial=1))),
        avg_nnz=float(nnzs.mean()), zipf_alpha=_fit_zipf(hist),
        live_fraction=live, tile_counts=tiles, itemsize=itemsize,
    )


def _valid_shard_rows(index):
    """``(shard, valid rows)`` per shard: the index's first ``n`` rows."""
    row0 = 0
    for shard in index.shards:
        rows = (shard[0] if index.is_sparse else shard).shape[0]
        yield shard, max(0, min(rows, index.n - row0))
        row0 += rows


def _summarize_index(index, threshold) -> CorpusSummary:
    """From the index's exact block stats, with the nonzeros per row and per
    dimension counted on each shard's device; only counts are copied."""
    live, tiles = _live_profile(index.stats, threshold)
    m = index.m
    nnz_parts, hist = [], np.zeros(m, np.int64)
    for shard, take in _valid_shard_rows(index):
        if index.is_sparse:
            idx, _, nnz = shard
            hist += _posting_hist(idx[:take], nnz[:take], m)
            nnz_parts.append(nnz[:take].cpu().numpy())
        else:
            nz = shard[:take, :m] != 0
            hist += nz.sum(dim=0).cpu().numpy()
            nnz_parts.append(nz.sum(dim=1).cpu().numpy())
    nnz = np.concatenate(nnz_parts)
    if index.is_sparse:
        return CorpusSummary(
            n=index.n, m=m, threshold=float(threshold), sparse_input=True,
            density=float(nnz.sum()) / float(index.n * m),
            cap=int(index.shards[0][0].shape[1]), avg_nnz=float(nnz.mean()),
            zipf_alpha=_fit_zipf(hist), live_fraction=live,
            tile_counts=tiles, itemsize=4,
        )
    return CorpusSummary(
        n=index.n, m=m, threshold=float(threshold), sparse_input=False,
        density=float(nnz.mean()) / float(m),
        cap=int(max(1, nnz.max(initial=1))), avg_nnz=float(nnz.mean()),
        zipf_alpha=_fit_zipf(hist), live_fraction=live,
        tile_counts=tiles, itemsize=4,
    )


# ---------------------------------------------------------------------------
# Candidate enumeration (validity constraints live HERE, not at dispatch)
# ---------------------------------------------------------------------------

# Densifying a sparse corpus for a dense variant is capped at this many
# bytes — beyond it the dense representation is not a candidate at all.
MAX_DENSIFY_BYTES = 512 * 1024 * 1024

# A dense input is only offered sparse candidates below this density
# (above it padded CSR stores ~the dense array with extra indices).
SPARSE_REP_MAX_DENSITY = 0.25


def candidate_configs(
    s: CorpusSummary,
    mesh=None,
    k: int = 32,
    *,
    block_rows_choices: Sequence[int] = (128, 256, 512),
    include_kernel: Optional[bool] = None,
    device="cuda",
) -> list[VariantConfig]:
    """Every valid configuration for this corpus/mesh (see module doc).

    ``include_kernel=None`` offers the kernel candidates where ``device``
    (the device the plan will run on; the port's default, ``"cuda"``) is
    CUDA.
    """
    if include_kernel is None:
        include_kernel = torch.device(device).type == "cuda"
    reps: list[bool] = []
    if s.sparse_input or s.density <= SPARSE_REP_MAX_DENSITY:
        reps.append(True)
    if not s.sparse_input or s.n * s.m * 4 <= MAX_DENSIFY_BYTES:
        reps.append(False)

    blocks = [b for b in dict.fromkeys(block_rows_choices) if b <= max(s.n, 1)]
    blocks = blocks or [min(128, s.n)]
    cfgs: list[VariantConfig] = []
    for sparse in reps:
        for b in blocks:
            cfgs.append(VariantConfig("blocked", sparse, b, use_kernel=False))
            if include_kernel:
                cfgs.append(VariantConfig("blocked", sparse, b, use_kernel=True))
    if mesh is None:
        return cfgs

    sizes = mesh_sizes(mesh)
    names = tuple(sizes)
    p = 1
    for v in sizes.values():
        p *= v
    if p <= 1 or s.n % p:
        return cfgs

    for sparse in reps:
        kern = [False] + ([True] if include_kernel and not sparse else [])
        for b in blocks:
            if len(names) == 1:
                for sched in ("allgather", "ring", "halfring"):
                    for uk in kern:
                        cfgs.append(
                            VariantConfig(
                                "horizontal", sparse, b, use_kernel=uk,
                                schedule=sched,
                            )
                        )
            else:
                for uk in kern:
                    cfgs.append(
                        VariantConfig("hierarchical", sparse, b, use_kernel=uk)
                    )
        if len(names) == 1 and s.m % p == 0:
            # both representations shard the dimension axis: dense as
            # column slices, sparse as shard_dims posting slices — m must
            # divide either way
            for b in blocks:
                if s.n % b:
                    continue
                for acc in ("allreduce", "scatter", "compressed", "recursive"):
                    if acc == "scatter" and b % p:
                        continue
                    if acc == "recursive" and p & (p - 1):
                        continue
                    cfgs.append(
                        VariantConfig(
                            "vertical", sparse, b, accumulation=acc,
                        )
                    )
    if len(names) == 2:
        q, r = sizes[names[0]], sizes[names[1]]
        # Both representations split the dimension axis r ways: dense as
        # column cells, sparse as shard_dims posting slices — m must
        # divide either way.
        if s.n % q == 0 and s.m % r == 0:
            n_loc = s.n // q
            for sparse in reps:
                for b in blocks:
                    for acc in ("allreduce", "compressed"):
                        cfgs.append(
                            VariantConfig(
                                "2d", sparse, min(b, n_loc), accumulation=acc,
                            )
                        )
    return list(dict.fromkeys(cfgs))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _index_valid_corpus(index):
    """The index's corpus restricted to its VALID rows/dims (indexes pad
    rows to the block multiple and lane-pad dense feature axes; planning
    and dispatch must see the real ``(n, m)`` — phantom padded rows would
    leak into results and break the n-divisibility gates). A sharded
    index's shards are gathered onto its home device."""
    from repro_torch.core.sparse import SparseCorpus

    home = index.device
    if index.is_sparse:
        parts = [tuple(x[:take].to(home) for x in shard)
                 for shard, take in _valid_shard_rows(index)]
        idx, val, nnz = (torch.cat(f) for f in zip(*parts))
        return SparseCorpus(idx, val, nnz, index.m)
    return torch.cat([shard[:take, :index.m].to(home)
                      for shard, take in _valid_shard_rows(index)])


def _to_representation(corpus, sparse: bool, device):
    """Convert the corpus to the representation a config wants, on the
    corpus's device (a numpy corpus on ``device``); one-off — conversion
    cost is not part of the per-call model."""
    from repro_torch.core.sparse import SparseCorpus, from_dense, to_dense

    if isinstance(corpus, SparseCorpus):
        return corpus if sparse else to_dense(corpus)
    if not sparse:
        return corpus
    dev = corpus.device if isinstance(corpus, torch.Tensor) else device
    return from_dense(corpus, device=dev)


def _run_device(corpus, device) -> torch.device:
    """Where a plan runs: ``device`` if given, else the corpus's device
    (an index's home device), else the port's default, ``"cuda"``."""
    from repro_torch.core.sparse import SparseCorpus
    from repro_torch.interop import device_of
    from repro_torch.serving.index import APSSIndex

    if device is not None:
        return device_of(device)
    if isinstance(corpus, (torch.Tensor, SparseCorpus, APSSIndex)):
        return corpus.device
    return device_of("cuda")


def _dispatch(cfg: VariantConfig, data, threshold: float, k: int, mesh, device):
    """Raw variant dispatch (``data`` already in the config's representation)."""
    from repro_torch.core import distributed
    from repro_torch.core.apss import apss_blocked

    if cfg.kind == "blocked":
        return apss_blocked(
            data, threshold, k, block_rows=cfg.block_rows,
            use_kernel=cfg.use_kernel, device=device,
        )
    if mesh is None:
        raise ValueError(f"config {cfg.name} needs a mesh")
    names = tuple(mesh_sizes(mesh))
    if cfg.kind == "horizontal":
        axis = names[0] if len(names) == 1 else names
        return distributed.apss_horizontal(
            data, threshold, k, mesh, axis, schedule=cfg.schedule,
            block_rows=cfg.block_rows, use_kernel=cfg.use_kernel, device=device,
        )
    if cfg.kind == "hierarchical":
        return distributed.apss_horizontal_hierarchical(
            data, threshold, k, mesh, names, block_rows=cfg.block_rows,
            use_kernel=cfg.use_kernel, device=device,
        )
    if cfg.kind == "vertical":
        return distributed.apss_vertical(
            data, threshold, k, mesh, names[-1],
            accumulation=cfg.accumulation, block_rows=cfg.block_rows,
            device=device,
        )
    if cfg.kind == "2d":
        return distributed.apss_2d(
            data, threshold, k, mesh, names[0], names[1],
            accumulation=cfg.accumulation, block_rows=cfg.block_rows,
            device=device,
        )
    raise ValueError(f"unknown variant kind: {cfg.kind}")


def execute(
    cfg: VariantConfig,
    corpus,
    threshold: float,
    k: int = 32,
    mesh=None,
    *,
    prepared: bool = False,
    device=None,
):
    """Run one configuration: representation conversion + dispatch.

    Dispatch is direct: the reference jits the configs it can trace and
    runs host-staged ones (``_has_host_stage``) eagerly; eager PyTorch
    traces nothing, so that distinction has no reader here and is gone.
    The run is on ``device``, else the corpus's device (see
    :func:`_run_device`).

    ``prepared=True`` declares ``corpus`` already in the config's
    representation: timed callers (autotune, the smoke's ``planner_auto``
    phase) convert once per representation up front, so measurements
    compare the join the cost model prices — not a per-call
    ``to_dense``/``from_dense``.
    """
    dev = _run_device(corpus, device)
    data = corpus if prepared else _to_representation(corpus, cfg.sparse, dev)
    with trace.span("execute", config=cfg.name):
        return _dispatch(cfg, data, float(threshold), k, mesh, dev)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Plan:
    """A ranked execution decision: chosen config + every priced alternative."""

    config: VariantConfig
    cost: CostEstimate
    estimates: list[CostEstimate]
    summary: CorpusSummary
    profile: CalibrationProfile
    threshold: float
    k: int
    mesh: object = None
    corpus: object = dataclasses.field(default=None, repr=False)
    autotuned: bool = False
    device: object = None  # where run() runs: the planned corpus's device

    def run(self, corpus=None, *, device=None):
        """Execute the chosen configuration (on the planned corpus by
        default), on ``device``, else the plan's."""
        data = corpus if corpus is not None else self.corpus
        if data is None:
            raise ValueError("Plan holds no corpus; pass one to run()")
        return execute(
            self.config, data, self.threshold, self.k, self.mesh,
            device=device if device is not None else self.device,
        )

    def result_layout(self) -> tuple[object, bool]:
        """``(axes, scatter)`` of this rank's result, as
        ``core.distributed.gather_matches`` takes them: the axes its rows
        are sharded over (``None``: the whole result on every rank) and
        whether it is the scatter accumulation's stacked slices."""
        cfg = self.config
        if cfg.kind == "blocked" or self.mesh is None:
            return None, False
        names = tuple(mesh_sizes(self.mesh))
        if cfg.kind == "horizontal":
            return (names[0] if len(names) == 1 else names), False
        if cfg.kind == "hierarchical":
            return names, False
        if cfg.kind == "vertical":
            scatter = cfg.accumulation == "scatter"
            return (names[-1] if scatter else None), scatter
        return names[0], False  # 2d: rows over the row axis

    def describe(self, top: int = 8) -> str:
        s = self.summary
        mesh_s = mesh_sizes(self.mesh) if self.mesh is not None else None
        lines = [
            f"Plan: {self.config.name}"
            + (f" on mesh {mesh_s}" if mesh_s else " (single device)")
            + ("  [autotuned]" if self.autotuned else ""),
            f"corpus: n={s.n} m={s.m} density={s.density:.4f} cap={s.cap} "
            f"zipf={s.zipf_alpha:.2f} live_tiles={s.live_fraction:.3f} "
            f"t={s.threshold}",
            f"profile: {self.profile.device_kind} "
            f"matmul={self.profile.matmul_gflops:.1f}GF "
            f"gather={self.profile.gather_gflops:.1f}GF "
            f"wire={self.profile.collective_gbps:.1f}GB/s",
            f"{'rank':>4}  {'config':<42} {'predicted':>10} {'compute':>10} "
            f"{'comm':>10} {'wire':>10}",
        ]
        for i, e in enumerate(self.estimates[:top]):
            meas = (
                f"  measured={e.measured_s * 1e3:.1f}ms"
                if e.measured_s is not None
                else ""
            )
            lines.append(
                f"{i + 1:>4}  {e.config.name:<42} {e.total_s * 1e3:>8.2f}ms "
                f"{e.compute_s * 1e3:>8.2f}ms {e.comm_s * 1e3:>8.2f}ms "
                f"{e.wire_bytes / 1e6:>8.2f}MB{meas}"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            "chosen": self.config.name,
            "autotuned": self.autotuned,
            "summary": self.summary.as_dict(),
            "estimates": [e.as_dict() for e in self.estimates],
        }


def plan_apss(
    corpus,
    threshold: float,
    k: int = 32,
    mesh=None,
    *,
    profile: Optional[CalibrationProfile] = None,
    block_rows_choices: Sequence[int] = (128, 256, 512),
    include_kernel: Optional[bool] = None,
    autotune: bool = False,
    autotune_top: int = 3,
    sample_rows: int = 2048,
    seed: int = 0,
    device=None,
) -> Plan:
    """Rank every valid configuration by modeled cost; return a :class:`Plan`.

    ``corpus`` may be dense, sparse, or a prebuilt ``APSSIndex`` (planned
    from its exact corpus-side stats). ``profile=None`` loads the cached
    calibration for this device kind (deterministic defaults when none has
    been measured — run ``planner.calibrate.calibrate()`` once for real
    numbers). ``device`` is where the plan will run (default: the corpus's
    device, see :func:`_run_device`); ``include_kernel=None`` offers the
    kernels there if it is CUDA. ``autotune=True`` additionally times the
    ``autotune_top`` best-predicted configurations and promotes the
    measured winner; under a mesh every rank times them and the ranks
    agree on the maximum of each time over the ranks. A candidate that
    fails raises (the reference prices it ``inf``): a kernel that does not
    build or launch must not lose the ranking in silence. The planning
    runs in a ``plan`` span (attribute ``autotune``) annotated with the
    ``chosen`` config and the number of ``candidates``.
    """
    with trace.span("plan", autotune=autotune):
        p = _plan_apss_impl(
            corpus, threshold, k, mesh, profile=profile,
            block_rows_choices=block_rows_choices, include_kernel=include_kernel,
            autotune=autotune, autotune_top=autotune_top, sample_rows=sample_rows,
            seed=seed, device=device,
        )
        trace.annotate(chosen=p.config.name, candidates=len(p.estimates))
        return p


def _plan_apss_impl(corpus, threshold, k, mesh, *, profile, block_rows_choices,
                    include_kernel, autotune, autotune_top, sample_rows, seed,
                    device) -> Plan:
    from repro_torch.serving.index import APSSIndex

    dev = _run_device(corpus, device)
    s = summarize_corpus(
        corpus, threshold, sample_rows=sample_rows, seed=seed
    )
    if profile is None:
        profile = _calibrate.get_profile()
    cfgs = candidate_configs(
        s, mesh, k, block_rows_choices=block_rows_choices,
        include_kernel=include_kernel, device=dev,
    )
    if not cfgs:
        raise ValueError("no valid configuration for this corpus/mesh")
    sizes = mesh_sizes(mesh) if mesh is not None else None
    ests = sorted(
        (estimate_cost(c, s, sizes, profile, k) for c in cfgs),
        key=lambda e: e.total_s,
    )
    run_corpus = (
        _index_valid_corpus(corpus) if isinstance(corpus, APSSIndex) else corpus
    )
    autotuned = False
    if autotune and len(ests) > 1:
        # Time the best-predicted config of the top `autotune_top` DISTINCT
        # variant families (block-size ties within a family are modeled
        # identically), each on a pre-converted corpus so the timing
        # covers exactly the join the model priced.
        seen: set = set()
        picked: list[CostEstimate] = []
        for e in ests:
            fam = (e.config.kind, e.config.schedule,
                   e.config.accumulation, e.config.sparse)
            if fam in seen:
                continue
            seen.add(fam)
            picked.append(e)
            if len(picked) >= max(2, autotune_top):
                break
        rep_cache: dict = {}
        times = []
        for e in picked:
            if e.config.sparse not in rep_cache:
                rep_cache[e.config.sparse] = _to_representation(
                    run_corpus, e.config.sparse, dev
                )
            data = rep_cache[e.config.sparse]
            execute(e.config, data, threshold, k, mesh, prepared=True, device=dev)
            _calibrate._sync(dev)  # warm: kernel builds, allocator
            t0 = time.perf_counter()
            execute(e.config, data, threshold, k, mesh, prepared=True, device=dev)
            _calibrate._sync(dev)
            times.append(time.perf_counter() - t0)
        if mesh is not None:
            times = _agree_max(times, mesh, dev)
        for e, t in zip(picked, times):
            e.measured_s = t
        # Measured winner first; unmeasured keep their predicted order.
        ests.sort(
            key=lambda e: (
                (0, e.measured_s) if e.measured_s is not None
                else (1, e.total_s)
            )
        )
        autotuned = True
    return Plan(
        config=ests[0].config, cost=ests[0], estimates=ests, summary=s,
        profile=profile, threshold=float(threshold), k=k, mesh=mesh,
        corpus=run_corpus, autotuned=autotuned, device=dev,
    )


def _agree_max(times: list[float], mesh, dev) -> list[float]:
    """Each time's maximum over the mesh's ranks (one all-reduce)."""
    import torch.distributed as dist

    group = _calibrate.mesh_group(mesh)
    on = dev if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor(times, dtype=torch.float64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.cpu().tolist()
