"""Closed-form cost models for every APSS variant.

DISCO's lesson is that communication volume is the right currency for
distributed similarity; the adaptive-join line's lesson is that the right
partitioning depends on the observed data distribution. This module prices
each candidate ``(variant, block_rows, use_kernel)`` configuration as

- ``wire`` — the per-device collective bytes + hop count of its schedule
  (the SAME formulas ``planner.telemetry`` records at execution time, so
  the wire-volume tests validate the model), converted to seconds with the
  calibrated interconnect bandwidth/latency,
- ``compute`` — modeled matmul/gather FLOPs (density- and live-fraction-aware)
  over the calibrated throughput of the matching primitive (dense matmul vs
  sparse gather-dot; per-device throughput under a mesh), scaled by the
  live-tile **imbalance** of the sampled worklist histogram (the busiest
  device bounds wall time),

combined as ``max(compute, comm)`` for schedules that overlap sends with
compute (ring-family) and ``compute + comm`` for those that cannot
(allgather, the accumulation collectives). All parameters come from a
:class:`CalibrationProfile` — measured once by ``planner.calibrate`` on
this machine's device and cached to JSON keyed by device kind — so the
model is falsifiable: ``chip_smoke.py``'s ``planner_auto`` phase prints
predicted against measured per candidate on the card.

The formulas and the profile's JSON are the reference's, so that under
:func:`default_profile` both packages rank and choose alike. A mesh is read
through :func:`mesh_sizes`, which takes the port's ``DeviceMesh``
(``mesh_dim_names`` and a ``shape`` tuple) or any object with those two
attributes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.planner import telemetry


# ---------------------------------------------------------------------------
# Calibration profile
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CalibrationProfile:
    """Hardware constants the cost models are parameterized by.

    ``matmul_gflops``/``gather_gflops`` are achieved single-device
    throughputs of the two scoring primitives; ``sharded_matmul_gflops`` is
    the per-rank throughput when every rank of a mesh computes at once
    (captures ranks that share a card; with a card per rank it ≈
    ``matmul_gflops``); ``collective_gbps`` is per-rank interconnect
    bandwidth; ``collective_latency_us`` the per-hop latency. The defaults
    are the reference's deterministic constants, not a measurement.
    """

    device_kind: str = "uncalibrated"
    matmul_gflops: float = 40.0
    gather_gflops: float = 2.0
    sharded_matmul_gflops: float = 0.0   # 0 → fall back to matmul_gflops
    sharded_gather_gflops: float = 0.0   # 0 → fall back to gather_gflops
    score_cost_ns: float = 2.0           # per-score extraction (threshold+topk)
    collective_gbps: float = 4.0
    collective_latency_us: float = 50.0
    overhead_us: float = 200.0           # per-call dispatch/launch floor
    # Serving-side (query_topk) terms. Older cached profiles lack these
    # keys; from_json fills the defaults, so calibration files never go
    # stale. serving_overhead_us is the per-CALL fixed cost of the query
    # path (mask eval + host worklist compaction + dispatch); the per-tile
    # terms are priced through the primitive throughputs above.
    serving_overhead_us: float = 150.0
    serving_tile_fixed_ns: float = 1500.0   # per live tile: scan/DMA step cost
    kernel_tile_fixed_ns: float = 400.0     # same, rect kernel path (K4/K6)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        d = json.loads(text)
        fields = dataclasses.fields(cls)
        return cls(**{f.name: d[f.name] for f in fields if f.name in d})

    def throughput(self, *, sparse: bool, distributed: bool) -> float:
        """FLOPs/s of the matching scoring primitive."""
        if sparse:
            g = (self.sharded_gather_gflops or self.gather_gflops) if distributed \
                else self.gather_gflops
        else:
            g = (self.sharded_matmul_gflops or self.matmul_gflops) if distributed \
                else self.matmul_gflops
        return max(g, 1e-3) * 1e9


def default_profile() -> CalibrationProfile:
    """Deterministic fallback constants (no microbenchmark).

    The *ratios* — matmul ≫ gather throughput, bandwidth ≪ arithmetic —
    carry the ranking; absolute seconds are only trustworthy after
    ``planner.calibrate.calibrate()``.
    """
    return CalibrationProfile()


# ---------------------------------------------------------------------------
# Corpus summary (planner-side sampled statistics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CorpusSummary:
    """What the planner knows about a corpus — sampled, never densified.

    ``live_fraction``/``tile_counts`` come from block-stats bounds evaluated
    on a row sample at the query threshold (``plan.summarize_corpus``);
    ``zipf_alpha`` is fitted to the sampled posting-list histogram (the
    paper's "almost irreducible" dimension skew).
    """

    n: int
    m: int
    threshold: float
    sparse_input: bool
    density: float
    cap: int                 # realized max row nnz (== m when truly dense)
    avg_nnz: float
    zipf_alpha: float
    live_fraction: float
    tile_counts: tuple[int, ...] = ()
    itemsize: int = 4

    def imbalance(self, p: int) -> float:
        """max/mean live tiles over ``p`` contiguous row-block groups."""
        tc = self.tile_counts
        if not tc or p <= 1:
            return 1.0
        groups = [0.0] * p
        for i, c in enumerate(tc):
            groups[min(p - 1, i * p // len(tc))] += c
        mean = sum(groups) / p
        if mean <= 0:
            return 1.0
        return max(groups) / mean

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tile_counts"] = list(self.tile_counts)
        return d


# ---------------------------------------------------------------------------
# Variant configurations + cost estimates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    """One candidate execution configuration the planner can rank/dispatch."""

    kind: str  # "blocked" | "horizontal" | "vertical" | "2d" | "hierarchical"
    sparse: bool
    block_rows: int
    use_kernel: bool = False
    schedule: Optional[str] = None       # horizontal: allgather | ring | halfring
    accumulation: Optional[str] = None   # vertical / 2d

    @property
    def name(self) -> str:
        base = self.kind
        if self.schedule:
            base += f"/{self.schedule}"
        if self.accumulation:
            base += f"/{self.accumulation}"
        tags = ["sparse" if self.sparse else "dense", f"b={self.block_rows}"]
        if self.use_kernel:
            tags.append("kernel")
        return f"{base}[{','.join(tags)}]"


@dataclasses.dataclass
class CostEstimate:
    """Modeled cost of one configuration on one corpus/mesh."""

    config: VariantConfig
    wire_bytes: int
    hop_count: int
    flops: float
    compute_s: float
    comm_s: float
    total_s: float
    imbalance: float = 1.0
    measured_s: Optional[float] = None   # filled by autotune / bench_planner

    def as_dict(self) -> dict:
        return {
            "config": self.config.name,
            "wire_bytes": int(self.wire_bytes),
            "hop_count": int(self.hop_count),
            "flops": float(self.flops),
            "compute_s": float(self.compute_s),
            "comm_s": float(self.comm_s),
            "predicted_s": float(self.total_s),
            "imbalance": float(self.imbalance),
            "measured_s": None if self.measured_s is None else float(self.measured_s),
        }


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a mesh, in axis order: the port's
    ``DeviceMesh`` or any object with ``mesh_dim_names`` and a ``shape``
    tuple (the reference reads ``dict(mesh.shape)``)."""
    return {str(a): int(s) for a, s in zip(mesh.mesh_dim_names, tuple(mesh.shape))}


def _capacity(k: int) -> int:
    """The compressed accumulations' candidate-capacity default — the ONE
    definition, shared with every telemetry record site."""
    from repro_torch.core.distributed import default_candidate_capacity

    return default_candidate_capacity(k)


def variant_hops(
    cfg: VariantConfig,
    s: CorpusSummary,
    mesh_sizes: dict[str, int],
    k: int,
) -> tuple[telemetry.CollectiveHop, ...]:
    """The schedule's hop list — same formulas telemetry records at runtime."""
    axes = list(mesh_sizes)
    p = 1
    for v in mesh_sizes.values():
        p *= v
    if cfg.kind == "blocked" or p <= 1:
        return ()
    n_loc = s.n // p
    block_bytes = (
        telemetry.csr_block_bytes(n_loc, s.cap)
        if cfg.sparse
        else telemetry.dense_block_bytes(n_loc, s.m, s.itemsize)
    )
    if cfg.kind == "horizontal":
        return telemetry.horizontal_hops(
            cfg.schedule, p, "+".join(axes), block_bytes,
            telemetry.matches_bytes(n_loc, k),
            payload="csr_block" if cfg.sparse else "dense_block",
        )
    if cfg.kind == "hierarchical":
        return telemetry.hierarchical_hops(
            tuple(mesh_sizes.values()), tuple(axes), block_bytes,
            payload="csr_block" if cfg.sparse else "dense_block",
        )
    if cfg.kind == "vertical":
        return telemetry.vertical_hops(
            cfg.accumulation, axes[-1], p, s.n,
            min(cfg.block_rows, s.n), _capacity(k),
        )
    if cfg.kind == "2d":
        q, r = mesh_sizes[axes[0]], mesh_sizes[axes[1]]
        n_loc = s.n // q
        return telemetry.twod_hops(
            q, r, axes[0], axes[1], n_loc, s.m, s.itemsize,
            min(cfg.block_rows, n_loc), _capacity(k), cfg.accumulation,
            cap_loc=_cell_cap(s, r) if cfg.sparse else None,
        )
    raise ValueError(f"unknown variant kind: {cfg.kind}")


def _cell_cap(s: CorpusSummary, r: int) -> int:
    """Planner-side estimate of the 2-D cell capacity ``cap_loc`` — the
    balanced split ``⌈cap/r⌉``. The realized value (known only after the
    host ``shard_dims`` pre-split) is the max per-slice row count and grows
    toward ``cap`` under posting-list skew; the runtime telemetry record
    carries the exact number, so ``bench_planner`` surfaces any drift as a
    predicted-vs-measured gap rather than silent model error."""
    return max(1, -(-s.cap // r))


def variant_flops(cfg: VariantConfig, s: CorpusSummary, p: int) -> float:
    """Modeled per-device scoring FLOPs of one configuration."""
    depth = s.cap if cfg.sparse else s.m
    rows = s.n // max(1, p)
    full = (
        telemetry.sparse_join_flops(rows, s.n, depth)
        if cfg.sparse
        else telemetry.dense_join_flops(rows, s.n, depth)
    )
    if cfg.kind == "vertical":
        # dimension split: every device sees all rows in an m/p (cap/p) slice
        return full  # rows·n·depth/p == (n/p)·n·depth
    if (
        cfg.kind == "horizontal" and cfg.schedule == "halfring"
        and not cfg.use_kernel and not cfg.sparse
    ):
        # dense plain halfring: each cross tile scored once, read in both
        # orientations (sparse/kernel halfrings re-score the mirror —
        # ring-level compute, halved wire; see core.distributed)
        return full * 0.55
    if cfg.kind == "blocked" and cfg.use_kernel:
        # worklist paths skip dead tiles (K1's tile mask / K3's compaction)
        return full * max(s.live_fraction, 1.0 / max(1, s.n // cfg.block_rows))
    return full


def variant_scores(cfg: VariantConfig, s: CorpusSummary, p: int) -> float:
    """Per-device SCORED ELEMENTS — the extraction (threshold + top-k)
    term's driver. Distinct from FLOPs: the dense plain halfring halves the
    product work but still extracts BOTH orientations of every cross tile,
    so its score count matches the ring's."""
    scored = (s.n // max(1, p)) * s.n
    if cfg.kind == "blocked" and cfg.use_kernel:
        scored *= max(s.live_fraction, 1.0 / max(1, s.n // cfg.block_rows))
    return scored


def estimate_cost(
    cfg: VariantConfig,
    s: CorpusSummary,
    mesh_sizes: Optional[dict[str, int]],
    profile: CalibrationProfile,
    k: int = 32,
) -> CostEstimate:
    """Price one configuration: wire + compute + imbalance → seconds."""
    mesh_sizes = mesh_sizes or {}
    p = 1
    for v in mesh_sizes.values():
        p *= v
    # A blocked config runs ALL rows on one device regardless of any mesh:
    # it must be priced single-device, else it reads p× too cheap and the
    # planner biases against the distributed variants.
    if cfg.kind == "blocked":
        p = 1
    hops = variant_hops(cfg, s, mesh_sizes, k) if p > 1 else ()
    wire = sum(h.total_bytes for h in hops)
    nhops = sum(h.hops for h in hops)
    comm_s = nhops * profile.collective_latency_us * 1e-6 + wire / (
        max(profile.collective_gbps, 1e-3) * 1e9
    )
    flops = variant_flops(cfg, s, p)
    imb = s.imbalance(p) if cfg.sparse else 1.0
    # Two compute terms: scoring FLOPs over the primitive's calibrated
    # throughput, plus the depth-independent per-score extraction cost
    # (threshold + top-k merge) — which dominates for narrow/sparse depths.
    scores = variant_scores(cfg, s, p)
    compute_s = imb * (
        flops / profile.throughput(sparse=cfg.sparse, distributed=p > 1)
        + scores * profile.score_cost_ns * 1e-9
    )
    overlapped = cfg.kind in ("hierarchical", "2d") or (
        cfg.kind == "horizontal" and cfg.schedule in ("ring", "halfring")
    )
    body = max(compute_s, comm_s) if overlapped else compute_s + comm_s
    return CostEstimate(
        config=cfg,
        wire_bytes=wire,
        hop_count=nhops,
        flops=flops,
        compute_s=compute_s,
        comm_s=comm_s,
        total_s=body + profile.overhead_us * 1e-6,
        imbalance=imb,
    )


# ---------------------------------------------------------------------------
# Per-batch serving plans (query_topk(plan="auto"))
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One priced ``query_topk`` execution choice for one batch.

    Unlike the offline :class:`VariantConfig` ranking — which prices whole
    self-join sweeps from SAMPLED corpus summaries — a query plan is priced
    from the index's exact :class:`~repro.core.pruning.BlockStats`: the
    corpus-side bounds are already materialized, so the live-tile estimate
    costs one tiny host pass over ``(mw, max_nnz)`` and involves zero
    sampling. ``block_q`` trades mask granularity (smaller blocks prune
    tighter) against per-tile fixed cost (fewer, fatter tiles amortize
    better); ``use_kernel`` (K4 on a dense index, K6 on a sparse one) is
    offered only where the index lives on a CUDA device.
    """

    batch: int
    block_q: int
    use_kernel: bool
    predicted_us: float
    live_block_fraction: float

    def as_dict(self) -> dict:
        return {
            "batch": int(self.batch),
            "block_q": int(self.block_q),
            "use_kernel": bool(self.use_kernel),
            "predicted_us": float(self.predicted_us),
            "live_block_fraction": float(self.live_block_fraction),
        }


_QUERY_BLOCK_CANDIDATES = (8, 16, 32, 64, 128)


def _corpus_live_fraction(index, threshold: float) -> float:
    """Fraction of corpus blocks that can pass the bounds for a UNIT-NORM
    query block, from the index's exact per-block stats.

    For a normalized query row, the tile bound is ≤ ``mw_c · √max_nnz_c``
    (Cauchy–Schwarz against the corpus block's weight/size maxima — the
    same minsize-style term ``core.pruning`` evaluates), so blocks with
    ``mw · √max_nnz < t`` are dead for EVERY query block and the live
    fraction is query-independent. Queries are normalized on server ingest,
    making this sound in the serving path; for an unnormalized index the
    bound degenerates and we price the conservative 1.0.
    """
    if threshold <= 0 or not getattr(index, "normalized", False):
        return 1.0
    import numpy as np

    mw, max_nnz = index.stats_host()
    ub = np.asarray(mw) * np.sqrt(np.maximum(np.asarray(max_nnz, np.float64), 0))
    return float((ub >= threshold).mean()) if ub.size else 1.0


def plan_query_topk(
    index,
    batch: int,
    threshold: float,
    k: int = 32,
    *,
    profile: Optional[CalibrationProfile] = None,
    allow_kernel: Optional[bool] = None,
) -> QueryPlan:
    """Price the ``(block_q, use_kernel)`` grid for ONE query batch.

    Cost per candidate: fixed serving overhead + per-live-tile fixed cost
    (scan step / kernel grid step) + scoring FLOPs over the calibrated
    primitive throughput, where the live-tile count is
    ``ceil(batch/block_q) · nb · live_fraction`` from the exact corpus
    stats. The batch pads up to ``block_q``, so oversized blocks pay for
    padding rows — which is exactly why small batches pick small blocks.

    ``allow_kernel=None`` offers the kernel where the index's home device is
    CUDA. A sharded sparse index has no kernel path and is priced on the
    plain one (the reference's ``index.mesh``; here ``n_shards > 1``).
    Records a ``serving/plan`` telemetry event when telemetry is enabled.
    """
    if profile is None:
        profile = default_profile()
    if allow_kernel is None:
        allow_kernel = index.device.type == "cuda"
    live_frac = _corpus_live_fraction(index, threshold)
    nb = max(1, index.n_blocks)
    depth = (
        int(index.bdims.shape[1])
        if (index.is_sparse and index.bdims is not None)
        else int(index.m)
    )
    thr = profile.throughput(sparse=index.is_sparse, distributed=False)
    best = None
    for block_q in _QUERY_BLOCK_CANDIDATES:
        grid_q = -(-max(1, batch) // block_q)
        tiles = grid_q * nb * live_frac
        flops = 2.0 * tiles * block_q * index.block_rows * depth
        for use_kernel in ((False, True) if allow_kernel else (False,)):
            if use_kernel and index.is_sparse and index.n_shards > 1:
                continue
            fixed_ns = (
                profile.kernel_tile_fixed_ns
                if use_kernel
                else profile.serving_tile_fixed_ns
            )
            us = (
                profile.serving_overhead_us
                + tiles * fixed_ns * 1e-3
                + flops / thr * 1e6
            )
            cand = QueryPlan(
                batch=int(batch), block_q=block_q, use_kernel=use_kernel,
                predicted_us=us, live_block_fraction=live_frac,
            )
            if best is None or cand.predicted_us < best.predicted_us:
                best = cand
    if telemetry.enabled():
        telemetry.record(telemetry.ApssStats(
            variant="serving/plan",
            n=index.n, m=index.m, block_rows=index.block_rows,
            sparse=index.is_sparse,
            flops=0.0,
            extra={"plan": best.as_dict(), "threshold": float(threshold), "k": int(k)},
        ))
    return best
