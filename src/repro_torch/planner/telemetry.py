"""Telemetry seam: per-call communication/compute accounting for every variant.

Every APSS entry point of the port (``core.apss``, ``core.distributed``,
``serving.query``) records one :class:`ApssStats` per call into the active
:class:`CommLog`: bytes moved per collective hop (ppermute / all_gather /
psum, dense block vs CSR caravan), modeled FLOPs, live-tile fraction after
pruning, and per-block live-tile counts for imbalance accounting. The
``variant`` strings equal the reference's letter for letter
(``"blocked/dense-xla"`` names the port's plain dense path), so readers
keyed on them work on both packages.

Everything is computed from shapes plus worklists the call already holds
on the host, so a record adds no device work and no host sync. Every site
is guarded by :func:`enabled`: with no log active, a record costs one
Python check. PyTorch does not trace, so each call records (the
reference records once per trace). The distributed entry points record on
each rank; each rank's log holds its own records. The same hop formulas
parameterize the planner's cost models (``planner.costmodel``).

Collective byte models (per participating device, standard ring-algorithm
costs):

- ``ppermute``: the payload itself, once per hop.
- ``all_gather`` (tiled): receive ``p-1`` remote shards → ``(p-1) · local``.
- ``psum`` (ring all-reduce): reduce-scatter + all-gather →
  ``2·(p-1)/p · payload``.
- ``psum_scatter``: reduce-scatter half only → ``(p-1)/p · payload``.

The port's collective helpers count the bytes a rank sends
(``core.distributed.WIRE_BYTES``): a ppermute's payload, equal to the
record's ``ppermute`` bytes, and every other collective's input, which the
formulas above scale (``all_gather`` by ``p - 1``, ``psum`` by
``2·(p-1)/p``).

Note: :class:`ApssStats` here is the telemetry record; the
``core.distributed.ApssStats`` is the overflow-exactness counter returned
by the compressed accumulations.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CollectiveHop:
    """One class of collective transfer inside a schedule.

    ``bytes_per_hop`` is the per-device payload of ONE hop; ``hops`` is how
    many sequential hops of this payload the schedule performs.
    """

    op: str          # "ppermute" | "all_gather" | "psum" | "psum_scatter"
    payload: str     # "dense_block" | "csr_block" | "caravan" | "candidates" | ...
    axis: str
    bytes_per_hop: int
    hops: int

    @property
    def total_bytes(self) -> int:
        return self.bytes_per_hop * self.hops


@dataclasses.dataclass
class ApssStats:
    """Per-call accounting record for one APSS/serving invocation.

    ``flops`` is the modeled per-device work (2·rows·cols·depth per
    scored tile); ``tile_counts`` is the live-tile histogram (per row block
    or per device) where a worklist was actually materialized, else None.
    """

    variant: str                 # e.g. "horizontal/ring", "blocked/sparse-kernel"
    n: int
    m: int
    devices: int = 1
    block_rows: int = 0
    sparse: bool = False
    hops: tuple[CollectiveHop, ...] = ()
    flops: float = 0.0
    live_tiles: Optional[int] = None
    total_tiles: Optional[int] = None
    tile_counts: Optional[tuple[int, ...]] = None
    extra: dict = dataclasses.field(default_factory=dict)
    # Per-step wall-time collector (distributed.straggler.StepTicker) wired
    # by the sweep drivers; its CUDA ticks settle when `step_times` is read.
    step_ticker: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    @property
    def wire_bytes(self) -> int:
        return sum(h.total_bytes for h in self.hops)

    @property
    def hop_count(self) -> int:
        return sum(h.hops for h in self.hops)

    def bytes_by_payload(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for h in self.hops:
            out[h.payload] = out.get(h.payload, 0) + h.total_bytes
        return out

    def bytes_by_op(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for h in self.hops:
            out[h.op] = out.get(h.op, 0) + h.total_bytes
        return out

    @property
    def live_fraction(self) -> Optional[float]:
        if self.live_tiles is None or not self.total_tiles:
            return None
        return self.live_tiles / self.total_tiles

    @property
    def imbalance(self) -> Optional[float]:
        """max/mean of the live-tile histogram (1.0 = perfectly balanced)."""
        if not self.tile_counts:
            return None
        mean = sum(self.tile_counts) / len(self.tile_counts)
        if mean == 0:
            return 1.0
        return max(self.tile_counts) / mean

    @property
    def step_times(self) -> Optional[tuple[float, ...]]:
        """Measured per-ring-step wall times (max over the ranks that ticked
        into this ticker), one entry per step, or None for variants without
        a wired ticker. Reads the ticks after ``torch.cuda.synchronize``
        (where there is a card), so every step's device work has ended."""
        if self.step_ticker is None:
            return None
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return self.step_ticker.step_times()


class CommLog:
    """Context manager collecting :class:`ApssStats` from instrumented calls.

    ::

        with CommLog() as log:
            apss_horizontal(D, t, k, mesh, schedule="halfring")
        print(log.last.wire_bytes, log.last.bytes_by_payload())

    Nested logs each receive every record emitted inside them.
    """

    def __init__(self) -> None:
        self.records: list[ApssStats] = []
        # Robustness counters (serving.shed / serving.degraded /
        # serving.retries / sweep.resumed_steps ...) incremented through
        # :func:`incr` by the serving ladder and the resumable sweeps.
        self.counters: collections.Counter = collections.Counter()

    def __enter__(self) -> "CommLog":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        # LIFO pop, asserted: ``remove(self)`` would strip the *first*
        # occurrence, so re-entering the same log nested (legal — each
        # entry just means "receive records") corrupted the stack order.
        if not _STACK or _STACK[-1] is not self:
            raise RuntimeError(
                "CommLog exited out of LIFO order (another log — or another "
                "entry of this log — is still active above it)"
            )
        _STACK.pop()

    @property
    def last(self) -> ApssStats:
        if not self.records:
            raise ValueError("CommLog is empty: no instrumented call ran")
        return self.records[-1]

    @property
    def total_wire_bytes(self) -> int:
        return sum(r.wire_bytes for r in self.records)

    def by_variant(self, variant: str) -> list[ApssStats]:
        return [r for r in self.records if r.variant == variant]


_STACK: list[CommLog] = []

# Observability hooks (the reference's ``obs``; the port's is ROADMAP queue
# 1 item 7): the tracer subscribes to records and the metrics registry to
# counters, so one ``incr`` call feeds both. Hooks keep the dependency
# one-way: ``obs`` imports this module, never the reverse.
_RECORD_HOOKS: list = []
_COUNTER_HOOKS: list = []


def add_record_hook(fn) -> None:
    _RECORD_HOOKS.append(fn)


def remove_record_hook(fn) -> None:
    if fn in _RECORD_HOOKS:
        _RECORD_HOOKS.remove(fn)


def add_counter_hook(fn) -> None:
    _COUNTER_HOOKS.append(fn)


def remove_counter_hook(fn) -> None:
    if fn in _COUNTER_HOOKS:
        _COUNTER_HOOKS.remove(fn)


def enabled() -> bool:
    """True iff at least one CommLog is active (instrumentation guard)."""
    return bool(_STACK)


def active() -> Optional[CommLog]:
    return _STACK[-1] if _STACK else None


def record(stats: ApssStats) -> None:
    """Append ``stats`` to every active log (no-op when none is active);
    call sites guard with :func:`enabled` so that nothing is computed for
    a record nobody reads."""
    for log in _STACK:
        log.records.append(stats)
    for fn in list(_RECORD_HOOKS):
        fn(stats)


def incr(name: str, n: int = 1) -> None:
    """Increment counter ``name`` in every active log (no-op when none).

    The robustness layer's event counters flow through here — the serving
    degradation ladder (``serving.shed`` / ``serving.degraded`` /
    ``serving.retries`` / ``serving.stale``) and the resumable sweeps
    (``sweep.resumed_steps`` / ``sweep.checkpoints``), and the mutable
    index (``serving.appends`` / ``serving.deletes`` /
    ``serving.compactions``, plus recovery events ``mutable.replayed_ops``
    / ``mutable.restore_fallback`` / ``mutable.log_walkback``), where
    their modules are ported. Host-side events.
    """
    for log in _STACK:
        log.counters[name] += n
    for fn in list(_COUNTER_HOOKS):
        fn(name, n)


# ---------------------------------------------------------------------------
# Payload sizes
# ---------------------------------------------------------------------------


def dense_block_bytes(rows: int, m: int, itemsize: int = 4) -> int:
    """Wire bytes of a traveling dense row block (bf16 stays 2 B/elt:
    ``core.distributed._to_wire`` sends it as int16)."""
    return rows * m * itemsize


def csr_block_bytes(rows: int, cap: int) -> int:
    """Wire bytes of a traveling CSR triple: (idx i32 + val f32)·cap + nnz i32."""
    return rows * cap * 8 + rows * 4


def csr_cell_bytes(rows: int, cap: int) -> int:
    """Wire bytes of a traveling 2-D checkerboard CSR cell: (idx i32 + val
    f32)·cap_loc only — the sparse 2-D ring ships no nnz vector (scoring
    sums every slot and padding slots are arithmetically inert)."""
    return rows * cap * 8


def matches_bytes(rows: int, k: int) -> int:
    """Wire bytes of a Matches caravan: values f32 + indices i32 + counts i32."""
    return rows * (8 * k + 4)


# ---------------------------------------------------------------------------
# FLOP models (per device)
# ---------------------------------------------------------------------------


def dense_join_flops(rows: int, cols: int, m: int) -> float:
    """Work of a dense blocked join: one (rows × cols × m) contraction."""
    return 2.0 * rows * cols * m


def sparse_join_flops(rows: int, cols: int, cap: int) -> float:
    """gather_dot work: 2·rows·cols·cap — the true sparse-dot cost."""
    return 2.0 * rows * cols * cap


def delta_join_flops(delta_rows: int, corpus_rows: int, depth: float) -> float:
    """Unpruned work of a mutable-index delta join: the delta must be
    scored against every live row in both directions, but (new × new) is
    covered once — 2·delta·corpus·depth, where ``depth`` is ``mlanes``
    (dense) or the ELL ``cap`` (sparse). The measured ``flops`` on a
    ``serving/delta-join`` record is the post-pruning fraction of this."""
    return 2.0 * delta_rows * corpus_rows * depth


# ---------------------------------------------------------------------------
# Hop formulas per schedule (shared with planner.costmodel)
# ---------------------------------------------------------------------------


def horizontal_hops(
    schedule: str,
    p: int,
    axis: str,
    block_bytes: int,
    caravan_bytes: int,
    payload: str = "dense_block",
) -> tuple[CollectiveHop, ...]:
    """Per-device hop list of the 1-D horizontal schedules.

    - ``allgather``: one tiled all-gather of the row shard → receives
      ``p-1`` remote blocks.
    - ``ring``: ``p-1`` block rotations.
    - ``halfring``: ``p//2`` block rotations (S = Sᵀ) plus the backward-match
      caravan: ``p//2`` in-ring hops + 1 homeward shift.
    """
    if p <= 1:
        return ()
    if schedule == "allgather":
        return (CollectiveHop("all_gather", payload, axis, block_bytes, p - 1),)
    if schedule == "ring":
        return (CollectiveHop("ppermute", payload, axis, block_bytes, p - 1),)
    if schedule == "halfring":
        return (
            CollectiveHop("ppermute", payload, axis, block_bytes, p // 2),
            CollectiveHop("ppermute", "caravan", axis, caravan_bytes, p // 2 + 1),
        )
    raise ValueError(f"unknown horizontal schedule: {schedule}")


def hierarchical_hops(
    sizes: tuple[int, ...],
    axes: tuple[str, ...],
    block_bytes: int,
    payload: str = "dense_block",
) -> tuple[CollectiveHop, ...]:
    """Nested ring: axis ``i`` hops ``(sizes[i]-1) · ∏_{j<i} sizes[j]`` times
    (each inner sweep completes before the next outer hop); the 4-byte owner
    id (one int32) travels with the block."""
    out = []
    outer = 1
    for ax, s in zip(axes, sizes):
        if s > 1:
            out.append(
                CollectiveHop("ppermute", payload, ax, block_bytes + 4, outer * (s - 1))
            )
        outer *= s
    return tuple(out)


def vertical_hops(
    accumulation: str,
    axis: str,
    p: int,
    n: int,
    block_rows: int,
    capacity: int,
    cols: int | None = None,
) -> tuple[CollectiveHop, ...]:
    """Per-device hop list of the vertical accumulations, per full pass.

    ``cols`` is the accumulated score-tile width (defaults to ``n`` — the
    self-join; the 2-D composition passes its local column count).
    """
    if p <= 1:
        return ()
    cols = n if cols is None else cols
    nb = max(1, n // block_rows)
    b = block_rows
    if accumulation == "allreduce":
        per = int(2 * (p - 1) / p * b * cols * 4)
        return (CollectiveHop("psum", "scores", axis, per, nb),)
    if accumulation == "scatter":
        per = int((p - 1) / p * b * cols * 4)
        return (CollectiveHop("psum_scatter", "scores", axis, per, nb),)
    gather_b = (p - 1) * b * capacity * 4
    psum_b = 2 * (p - 1) * b * capacity * 4
    if accumulation == "compressed":
        return (
            CollectiveHop("all_gather", "candidate_ids", axis, gather_b, nb),
            CollectiveHop("psum", "candidate_scores", axis, psum_b, nb),
        )
    if accumulation == "recursive":
        levels = max(1, p.bit_length() - 1)
        perm_b = 3 * b * capacity * 4
        return (
            CollectiveHop("ppermute", "candidates", axis, perm_b, levels * nb),
            CollectiveHop("all_gather", "candidate_ids", axis, gather_b, nb),
            CollectiveHop("psum", "candidate_scores", axis, psum_b, nb),
        )
    raise ValueError(f"unknown vertical accumulation: {accumulation}")


def twod_hops(
    q: int,
    r: int,
    row_axis: str,
    col_axis: str,
    n_loc: int,
    m: int,
    itemsize: int,
    block_rows: int,
    capacity: int,
    accumulation: str,
    cap_loc: int | None = None,
) -> tuple[CollectiveHop, ...]:
    """2-D checkerboard: a row-axis ring of per-cell corpus blocks composed
    with a vertical accumulation of each ``(bs, n_loc)`` partial tile per ring
    step (paper Alg. 7).

    ``cap_loc`` switches the ring payload to the sparse cell: a dense cell is
    ``(n_loc, m/r)`` values, a sparse cell the per-cell CSR pair of width
    ``cap_loc`` (the realized max per-cell row count after ``shard_dims``).
    The inner accumulation hops are representation-agnostic either way — they
    carry candidate ids/scores, never corpus payloads."""
    hops: list[CollectiveHop] = []
    if q > 1:
        if cap_loc is None:
            block = dense_block_bytes(n_loc, m // r, itemsize)
            payload = "dense_block"
        else:
            block = csr_cell_bytes(n_loc, cap_loc)
            payload = "csr_cell"
        hops.append(
            CollectiveHop("ppermute", payload, row_axis, block, q - 1)
        )
    inner = vertical_hops(
        accumulation, col_axis, r, n_loc, block_rows, capacity, cols=n_loc
    )
    # The inner accumulation runs once per ring step (q total).
    hops.extend(
        CollectiveHop(h.op, h.payload, h.axis, h.bytes_per_hop, h.hops * q)
        for h in inner
    )
    return tuple(hops)
