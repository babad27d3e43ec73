"""RetrievalServer: batched query-time APSS over a build-once index.

Requests join a padded query batch at the next ``step()`` boundary; one
:func:`~repro_torch.serving.query.query_topk` call serves the whole batch
(padded to ``max_batch`` rows, one query block), and each request's result
latches into its slot. A small LRU cache keyed on the query vector's hash
answers repeat queries without touching the device.

Degraded-mode contract: under overload or scoring failure the server
prefers a worse answer now over a perfect answer too late:

- **admission control**: past ``max_pending`` queued requests, new submits
  are shed at once (``status="shed"``, empty result);
- **deadlines**: requests whose deadline lapses before their batch is
  scored are shed at the step boundary; in-budget requests of the same
  batch still get exact results;
- **degradation ladder**: each scoring tier (``"kernel"``: K4/K5/K6 on the
  card, then ``"plain"``: the plain PyTorch versions) is retried
  ``max_retries`` times with exponential backoff before the server falls
  to the next; when every tier fails, a stale LRU entry (past ``ttl_s``)
  still answers (``status="stale"``) and only cache misses fail.

The ladder absorbs what load and injected faults cause, not faults of the
code: a :class:`~repro_torch.kernels._build.KernelError` (a kernel that does
not build, load or launch), a ``ValueError`` (a wrapper refusing its
operands) or a ``NotImplementedError`` (a tier the index cannot run, such
as the kernel on a sparse sharded index) would fail every retry alike, and
degrading past it would hide a kernel that can never run behind the plain
tier. It propagates from ``step()``, or, in the continuous server, stops
the workers and re-raises from ``result()``.

Both servers take a sharded index unchanged: each batch goes to the
index's home device and ``query_topk`` runs the per-shard path. A live
:class:`~repro_torch.serving.mutable.MutableAPSSIndex` is served through
its own ``query`` (result ids are its global row ids, stable across
compaction); each mutation bumps its ``version``, which the LRU keys on.

Each event is counted in :class:`ServerStats` and in the active telemetry
logs (``planner.telemetry.incr``: ``serving.requests`` /
``serving.cache_hits`` / ``serving.shed`` / ``serving.degraded`` /
``serving.retries`` / ``serving.stale``), traced at the reference's points
(``obs.trace``: the ``serving/step`` and ``serving/score`` spans and the
``shed`` / ``cache_hit`` / ``admit`` / ``retry`` / ``degrade`` / ``batch``
/ ``merge`` events, the continuous server's ``slot`` / ``exit``), observed
into the active metrics registry (``serving.latency_s``,
``serving.batch_occupancy``), and a tier going down dumps the active flight
recorders (``obs.recorder``, reason ``serving.tier_down``). Each batch's
``query_topk`` records its ``ApssStats``. Adversarial input is rejected at
``submit``: non-numeric dtypes, non-finite values and a wrong dimension
raise ``ValueError``; an all-zero query is served (it normalizes to zero
and matches nothing). ``fault_plan`` is a
:class:`~repro_torch.robust.faults.FaultPlan`, or any object with
``fail_point(scope)`` (raising, scopes ``serving.kernel`` /
``serving.plain``) and ``delay(scope, step=)`` (scope ``serving``).
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.apss import normalize_rows
from repro_torch.interop import _host
from repro_torch.kernels._build import KernelError
from repro_torch.obs import metrics, recorder, trace
from repro_torch.planner import telemetry
from repro_torch.serving.index import APSSIndex
from repro_torch.serving.mutable import MutableAPSSIndex
from repro_torch.serving.query import query_topk

# Faults of the code, not of the load: never retried, never degraded past.
_CODE_FAULTS = (KernelError, ValueError, NotImplementedError)


class RetrievalResult(NamedTuple):
    """One request's top-k neighbours (host numpy, ready to serialize)."""

    values: np.ndarray   # (k,) f32 similarities, -inf padded
    indices: np.ndarray  # (k,) i32 corpus row ids, -1 padded
    count: int           # exact number of corpus rows ≥ threshold (may exceed k)
    cached: bool         # served from the LRU cache
    status: str = "ok"   # "ok" | "shed" | "stale" | "failed"


class ServerStats(NamedTuple):
    requests: int
    steps: int
    cache_hits: int
    shed: int = 0        # admission-control + deadline rejections
    degraded: int = 0    # scoring-tier downgrades (kernel → plain → stale)
    retries: int = 0     # same-tier retry attempts
    stale: int = 0       # answers served from an expired cache entry


class RetrievalServer:
    """Batched online retrieval over a prebuilt :class:`APSSIndex`, whole or
    sharded, or a live :class:`MutableAPSSIndex`.

    Args:
      index: built once by :func:`~repro_torch.serving.index.build_index`,
        whole or in row-block shards, or a live ``MutableAPSSIndex``
        (mutations bump its ``version``, which invalidates every cached
        answer); batches go to its (home) device.
      threshold / k: fixed per server.
      max_batch: padded batch width; requests beyond it wait for the next
        step boundary.
      normalize: L2-normalize incoming queries (cache keys hash the raw
        bytes before normalization).
      cache_size: LRU entries; 0 disables the cache.
      use_kernel: score through the rectangular kernels first (the
        ``"kernel"`` tier), degrading to the ``"plain"`` tier on failure.
      block_q: query block (default ``max(8, max_batch)``: one block).
      deadline_s: default per-request deadline (None: none).
      max_pending: admission budget (None: unbounded).
      max_retries / backoff_s: per-tier retry policy, exponential backoff
        from ``backoff_s``.
      ttl_s: cache freshness horizon; older entries serve only as stale
        answers when every tier is down (None: never stale).
      fault_plan: chaos hooks (see module doc).
    """

    def __init__(
        self,
        index: APSSIndex,
        *,
        threshold: float,
        k: int = 32,
        max_batch: int = 8,
        normalize: bool = True,
        cache_size: int = 256,
        use_kernel: bool = False,
        block_q: Optional[int] = None,
        deadline_s: Optional[float] = None,
        max_pending: Optional[int] = None,
        max_retries: int = 1,
        backoff_s: float = 0.01,
        ttl_s: Optional[float] = None,
        fault_plan=None,
    ):
        self.index = index
        self.threshold = float(threshold)
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.normalize = bool(normalize)
        self.use_kernel = bool(use_kernel)
        self.block_q = int(block_q or max(8, self.max_batch))
        self.cache_size = int(cache_size)
        self.deadline_s = deadline_s
        self.max_pending = max_pending
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.ttl_s = ttl_s
        self.fault_plan = fault_plan
        # entries: (result, born, index version at scoring time)
        self._cache: collections.OrderedDict[
            str, tuple[RetrievalResult, float, int]
        ] = collections.OrderedDict()
        # pending: (rid, query, cache key, absolute deadline | inf, submit time)
        self._pending: collections.deque[
            tuple[int, np.ndarray, str, float, float]
        ] = collections.deque()
        self._results: dict[int, RetrievalResult] = {}
        self._next_id = 0
        self._requests = 0
        self._steps = 0
        self._cache_hits = 0
        self._shed = 0
        self._degraded = 0
        self._retries = 0
        self._stale = 0
        self._ladder_lock = threading.Lock()  # scoring runs outside the server lock

    # -- input contract -----------------------------------------------------

    def _coerce_query(self, query) -> np.ndarray:
        """Validate and coerce one query to finite f32 ``(m,)``: non-numeric
        dtypes and non-finite values are rejected, numeric dtypes cast, and
        all-zero vectors accepted (they normalize to zero, match nothing)."""
        q = np.asarray(query)
        if q.dtype.kind not in "fiub":
            raise ValueError(
                f"query dtype {q.dtype} is not numeric (float/int/bool accepted)"
            )
        q = np.asarray(q, np.float32).reshape(-1)
        if q.shape[0] != self.index.m:
            raise ValueError(f"query dim {q.shape[0]} != index m {self.index.m}")
        if not np.all(np.isfinite(q)):
            raise ValueError("query contains non-finite values (NaN/inf)")
        return q

    def _empty_result(self, status: str) -> RetrievalResult:
        v = np.full((self.k,), -np.inf, np.float32)
        i = np.full((self.k,), -1, np.int32)
        v.setflags(write=False)
        i.setflags(write=False)
        return RetrievalResult(values=v, indices=i, count=0, cached=False, status=status)

    def _shed_request(self, rid: int) -> None:
        self._shed += 1
        telemetry.incr("serving.shed")
        trace.event("shed", rid=rid)
        self._results[rid] = self._empty_result("shed")

    def _admit(self, q: np.ndarray, key: str, deadline_s, **admit_attrs) -> int:
        """Cache hit, shed or enqueue one coerced query; returns its id.
        ``admit_attrs`` go on the ``admit`` trace event beside the id."""
        rid = self._next_id
        self._next_id += 1
        self._requests += 1
        telemetry.incr("serving.requests")
        hit = self._cache_get(key)
        if hit is not None:
            self._cache_hits += 1
            telemetry.incr("serving.cache_hits")
            trace.event("cache_hit", rid=rid)
            if metrics.enabled():
                metrics.observe("serving.latency_s", 0.0)
            self._results[rid] = hit._replace(cached=True)
            return rid
        if self.max_pending is not None and len(self._pending) >= self.max_pending:
            self._shed_request(rid)
            return rid
        trace.event("admit", rid=rid, **admit_attrs)
        budget = deadline_s if deadline_s is not None else self.deadline_s
        now = time.monotonic()
        deadline = now + budget if budget is not None else np.inf
        self._pending.append((rid, q, key, deadline, now))
        return rid

    # -- request lifecycle --------------------------------------------------

    def submit(self, query, *, deadline_s: Optional[float] = None) -> int:
        """Enqueue one query vector ``(m,)``; returns a request id. Cache hits
        latch at once; submits past the admission budget latch ``"shed"``."""
        q = self._coerce_query(query)
        return self._admit(q, self._cache_key(q), deadline_s)

    # -- tiered scoring ------------------------------------------------------

    def _tiers(self) -> list[tuple[str, bool]]:
        return ([("kernel", True)] if self.use_kernel else []) + [("plain", False)]

    def _score_batch(self, Q: torch.Tensor):
        """Run the degradation ladder; returns ``(matches | None, tier)``.

        Each tier gets ``1 + max_retries`` attempts with exponential
        backoff; a tier that stays down degrades to the next, and ``None``
        means every tier failed (the caller falls to stale answers).
        ``_CODE_FAULTS`` propagate at once (module doc).
        """
        for nth, (tier, use_k) in enumerate(self._tiers()):
            delay = self.backoff_s
            for attempt in range(1 + self.max_retries):
                try:
                    if self.fault_plan is not None:
                        self.fault_plan.fail_point(f"serving.{tier}")
                    if isinstance(self.index, MutableAPSSIndex):
                        m = self.index.query(
                            Q, self.threshold, self.k,
                            block_q=self.block_q, use_kernel=use_k,
                        )
                    else:
                        m = query_topk(
                            self.index, Q, self.threshold, self.k,
                            block_q=self.block_q, use_kernel=use_k,
                        )
                    if nth > 0:
                        self._tier_down(tier)
                    return m, tier
                except _CODE_FAULTS:
                    raise
                except Exception:
                    if attempt < self.max_retries:
                        with self._ladder_lock:
                            self._retries += 1
                        telemetry.incr("serving.retries")
                        trace.event("retry", tier=tier, attempt=attempt + 1)
                        time.sleep(delay)
                        delay *= 2
        self._tier_down("stale")
        return None, "stale"

    def _tier_down(self, tier: str) -> None:
        """Count, trace and flight-record the ladder landing on ``tier``."""
        with self._ladder_lock:
            self._degraded += 1
        telemetry.incr("serving.degraded")
        trace.event("degrade", tier=tier)
        recorder.trigger("serving.tier_down", tier=tier)

    def _batch_queries(self, batch) -> torch.Tensor:
        Q = np.zeros((self.max_batch, self.index.m), np.float32)
        for slot, entry in enumerate(batch):
            Q[slot] = entry[1]
        Q = torch.from_numpy(Q).to(self.index.device)
        return normalize_rows(Q) if self.normalize else Q

    def step(self) -> int:
        """Serve up to ``max_batch`` pending requests with one scoring call.

        Returns the number of requests finished this step (scored + shed;
        0 = idle). Past-deadline requests are shed before the batch is
        assembled, so no scoring work goes to answers nobody waits for.
        """
        if not self._pending:
            return 0
        with trace.span("serving/step", step=self._steps):
            return self._step_inner()

    def _step_inner(self) -> int:
        if self.fault_plan is not None:
            self.fault_plan.delay("serving", step=self._steps)  # a slow step
        now = time.monotonic()
        shed_count = 0
        keep: collections.deque = collections.deque()
        while self._pending:
            entry = self._pending.popleft()
            if entry[3] < now:
                self._shed_request(entry[0])
                shed_count += 1
            else:
                keep.append(entry)
        self._pending = keep
        if not self._pending:
            return shed_count
        batch = [
            self._pending.popleft()
            for _ in range(min(self.max_batch, len(self._pending)))
        ]
        trace.event("batch", size=len(batch), queued=len(self._pending))
        if metrics.enabled():
            metrics.observe("serving.batch_occupancy", len(batch) / self.max_batch)
        Q = self._batch_queries(batch)
        with trace.span("serving/score", batch=len(batch)):
            m, tier = self._score_batch(Q)
            trace.annotate(tier=tier)
        self._steps += 1
        self._latch_batch(batch, m, tier)
        return len(batch) + shed_count

    def _latch_batch(self, batch, m, tier: str, seq: Optional[int] = None) -> None:
        """Latch each request's result (or, with ``m`` None, its stale cache
        entry, else ``"failed"``)."""
        if m is None:
            for rid, _, key, _, born in batch:
                stale = self._cache_get(key, stale_ok=True)
                if stale is not None:
                    self._stale += 1
                    telemetry.incr("serving.stale")
                    self._latch(rid, born, stale._replace(cached=True, status="stale"),
                                tier, seq)
                else:
                    self._latch(rid, born, self._empty_result("failed"), tier, seq)
            return
        values, indices, counts = (_host(x) for x in m)
        if seq is None:
            trace.event("merge", batch=len(batch))
        for slot, (rid, _, key, _, born) in enumerate(batch):
            # Frozen per-request copies: the cache and every client hold the
            # same arrays, so an in-place edit by one caller raises instead.
            v = values[slot].copy()
            i = indices[slot].copy()
            v.setflags(write=False)
            i.setflags(write=False)
            res = RetrievalResult(values=v, indices=i, count=int(counts[slot]), cached=False)
            self._latch(rid, born, res, tier, seq)
            self._cache_put(key, res)

    def _latch(self, rid: int, born: float, res: RetrievalResult, tier: str,
               seq: Optional[int]) -> None:
        self._results[rid] = res
        if metrics.enabled():
            metrics.observe("serving.latency_s", time.monotonic() - born)

    def result(self, rid: int) -> RetrievalResult:
        """Pop a finished request's result (steps until it is ready)."""
        while rid not in self._results:
            if not self.step():
                raise KeyError(f"unknown request id {rid}")
        return self._results.pop(rid)

    def serve(self, queries: Sequence) -> list[RetrievalResult]:
        """Submit all, drain in batches, return in order."""
        rids = [self.submit(q) for q in queries]
        while self._pending:
            self.step()
        return [self.result(r) for r in rids]

    def close(self) -> None:
        """Nothing to stop (no workers); lets callers treat both servers alike."""

    # -- LRU cache ----------------------------------------------------------

    def _cache_key(self, q: np.ndarray) -> str:
        h = hashlib.blake2b(q.tobytes(), digest_size=16)
        h.update(np.float32(self.threshold).tobytes())
        h.update(np.int32(self.k).tobytes())
        return h.hexdigest()

    def _index_version(self) -> int:
        """A mutable index bumps ``version`` per mutation; a built one is 0."""
        return int(getattr(self.index, "version", 0))

    def _cache_get(self, key: str, *, stale_ok: bool = False) -> Optional[RetrievalResult]:
        """Fresh hits only by default (in TTL and scored against the current
        index version); ``stale_ok`` ignores both, for the last-resort tier."""
        if self.cache_size <= 0:
            return None
        hit = self._cache.get(key)
        if hit is None:
            return None
        res, born, version = hit
        if not stale_ok:
            if version != self._index_version():
                return None
            if self.ttl_s is not None and time.monotonic() - born > self.ttl_s:
                return None
        self._cache.move_to_end(key)
        return res

    def _cache_put(self, key: str, res: RetrievalResult) -> None:
        if self.cache_size <= 0:
            return
        self._cache[key] = (res, time.monotonic(), self._index_version())
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    @property
    def stats(self) -> ServerStats:
        return ServerStats(
            requests=self._requests, steps=self._steps, cache_hits=self._cache_hits,
            shed=self._shed, degraded=self._degraded, retries=self._retries,
            stale=self._stale,
        )


class ContinuousRetrievalServer(RetrievalServer):
    """Slot-granularity (continuous-batching) retrieval server.

    The step server quantizes latency to ``step()`` boundaries, and one slow
    batch holds every queued request behind it. This subclass keeps the
    request lifecycle (admission, deadlines, version-keyed LRU, the
    degradation ladder) and replaces only the latch: ``workers`` background
    threads pull up to ``max_batch`` requests the moment any are pending,
    so a request's service starts at submit, and with ``workers ≥ 2`` a
    straggling batch delays only its own requests.

    Threading: one lock guards the queue, results, cache and counters;
    scoring runs outside it. Deadline sheds happen at batch assembly, as in
    the step server. ``step()`` is a no-op; use ``result()``/``serve()``,
    and ``close()`` (or the context manager) to stop the workers. A fault of
    the code in any worker stops them all; ``result()`` re-raises it.
    """

    def __init__(self, index: APSSIndex, *, workers: int = 2, **kwargs):
        super().__init__(index, **kwargs)
        self._lock = threading.Lock()
        self._work_ready = threading.Condition(self._lock)
        self._done = threading.Condition(self._lock)
        self._stop = False
        self._error: Optional[BaseException] = None  # a worker's fault, re-raised
        self._batch_seq = 0  # the continuous analogue of the step count
        self._inflight: set[int] = set()  # claimed by a worker, not latched
        self._workers = [
            threading.Thread(target=self._worker_loop, name=f"retrieval-slot-{i}",
                             daemon=True)
            for i in range(max(1, int(workers)))
        ]
        for w in self._workers:
            w.start()

    def close(self) -> None:
        """Stop the workers (idempotent). Pending requests stay queued."""
        with self._lock:
            self._stop = True
            self._work_ready.notify_all()
        for w in self._workers:
            w.join()

    def __enter__(self) -> "ContinuousRetrievalServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, query, *, deadline_s: Optional[float] = None) -> int:
        """Enqueue one query; a worker picks it up at once."""
        q = self._coerce_query(query)
        key = self._cache_key(q)
        with self._lock:
            rid = self._admit(q, key, deadline_s, queued=len(self._pending))
            if rid in self._results:
                self._done.notify_all()
            else:
                self._work_ready.notify()
        return rid

    def step(self) -> int:
        """No-op: workers drain the queue continuously."""
        return 0

    def result(self, rid: int, timeout_s: Optional[float] = None) -> RetrievalResult:
        """Block until ``rid``'s result latches, then pop it."""
        deadline = time.monotonic() + timeout_s if timeout_s is not None else None
        with self._lock:
            while rid not in self._results:
                if self._error is not None:
                    raise self._error
                if rid >= self._next_id or (
                    rid not in self._inflight and all(p[0] != rid for p in self._pending)
                ):
                    raise KeyError(f"unknown request id {rid}")
                if self._stop:
                    raise RuntimeError("server closed while request pending")
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        raise TimeoutError(f"result({rid}) timed out")
                self._done.wait(timeout=wait)
            return self._results.pop(rid)

    def serve(self, queries: Sequence) -> list[RetrievalResult]:
        """Submit all, block until every result latches, return in order."""
        rids = [self.submit(q) for q in queries]
        return [self.result(r) for r in rids]

    def _take_batch(self):
        """Under the lock: shed expired requests, then claim up to
        ``max_batch``. Returns ``(batch, seq)``, or None at shutdown."""
        while True:
            if self._stop:
                return None
            now = time.monotonic()
            while self._pending and self._pending[0][3] < now:
                self._shed_request(self._pending.popleft()[0])
                self._done.notify_all()
            if self._pending:
                batch = [
                    self._pending.popleft()
                    for _ in range(min(self.max_batch, len(self._pending)))
                ]
                self._inflight.update(b[0] for b in batch)
                seq = self._batch_seq
                self._batch_seq += 1
                return batch, seq
            self._work_ready.wait()

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                taken = self._take_batch()
                if taken is None:
                    return
                batch, seq = taken
                trace.event("slot", seq=seq, size=len(batch), queued=len(self._pending))
                if metrics.enabled():
                    metrics.observe("serving.batch_occupancy", len(batch) / self.max_batch)
            # Scoring runs unlocked: a straggling batch must not stop the
            # other workers from draining arrivals.
            if self.fault_plan is not None:
                self.fault_plan.delay("serving", step=seq)
            try:
                m, tier = self._score_batch(self._batch_queries(batch))
            except BaseException as e:
                with self._lock:
                    self._error, self._stop = e, True
                    self._work_ready.notify_all()
                    self._done.notify_all()
                return
            with self._lock:
                self._steps += 1
                self._latch_batch(batch, m, tier, seq)
                self._done.notify_all()

    def _latch(self, rid: int, born: float, res: RetrievalResult, tier: str,
               seq: Optional[int]) -> None:
        self._results[rid] = res
        self._inflight.discard(rid)
        trace.event("exit", rid=rid, seq=seq, status=res.status, tier=tier)
        if metrics.enabled():
            metrics.observe("serving.latency_s", time.monotonic() - born)
