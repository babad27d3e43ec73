"""MutableAPSSIndex: a live corpus with delta similarity joins.

``APSSIndex`` is built once; every corpus change would pay a full rebuild.
This module keeps a standing top-k similarity graph current under an
append/delete log, at a cost proportional to the delta:

- :meth:`MutableAPSSIndex.append` normalizes the delta, packs it after the
  existing rows, recomputes :class:`~repro_torch.core.pruning.BlockStats`
  for the touched window of blocks only, and runs the **delta join** --
  ``(new × existing) ∪ (new × new)`` forward, ``(old × new)`` in reverse --
  over rectangular worklists of live tiles, merging into the graph.
- :meth:`MutableAPSSIndex.delete` sets tombstones (rows are zeroed on the
  device and masked out of every join by a live-row mask honoured beside
  ``live_tile_mask``), repairs exactly the graph rows that referenced a
  deleted neighbour, and compacts when the tombstone fraction crosses a
  threshold.

**Bit-equality contract** (the metamorphic invariant, the reference's
``repro.serving.mutable``): after ANY interleaving of append, delete and
compact, the graph and query results are bit-identical to a fresh index
built from the surviving rows in the same order, on one device. Three
rules make it hold:

1. *Canonical top-k order.* Every merge keeps the order (value desc,
   position asc): worklists are plain ascending ``(i, j)``, packet folds
   select by (value desc, id asc), and host merges use a stable argsort.
   Appends pack at the end and compaction keeps the order, so physical
   order equals gid order among live rows.
2. *Layout-independent score bits.* A pair's score depends only on the two
   rows. Rows are normalized on the host, one numpy row norm each, so the
   stored bits of a row do not depend on the batch it came in. Dense tiles
   run through K4's masked entry on the card, whose every score is
   ⌈m / ``EE_FK``⌉ feature chunks, each one fmaf chain, added in chunk
   order, whatever the tile; on the CPU through its plain version
   (``fused.rect_tile_candidates_plain``, one product per tile), every
   query block zero-padded to ``block_rows`` rows, so every product has one
   shape, ``(block_rows × width) · (width × block_rows)``. Sparse tiles score
   each pair as one loop over the corpus row's own ELL slots in slot order
   (:func:`slot_dot`), never the per-block support compaction, whose
   grouping depends on which rows share a block. Sparse bit-equality also
   needs the same ELL ``cap`` on both sides (pin ``cap=``).
3. *Scoring extra tiles is harmless.* Stats are exact for append windows
   and left stale (upper bounds over a superset) across deletes, sound
   either way; a tile live here but dead in the rebuild is matchless.

**Durability**: with ``directory=``, every mutation is written to a
write-ahead log (one ``CheckpointManager`` step per op, ``keep=0``,
digests included) *before* it is applied, and a state snapshot lands
after. Reopening with ``corpus=None`` restores the newest intact snapshot
and replays the log tail, so a kill between the WAL write and the
snapshot resumes bit-identically. A corrupt log entry walks back exactly
that op (``mutable.log_walkback``). The directory layout, ``meta.json``,
the log entries and the snapshots are the reference's, so a directory
either package wrote, the other reopens.

Device state (the corpus rows or the ELL triple, the block stats) lives on
``device`` (default ``"cuda"``); host state (gids, the live mask, the
graph) is numpy, as in the reference. Capacity doubles and deltas are
bucketed to powers of two, and every state update is an in-place slice
write, so an append that fits the capacity allocates no device state.

Compile observability (``obs.compile``): the live index's hot path is
the group ``"serving.mutable"``, K4's library, which a warmed append,
delete or query neither builds nor loads
(``assert_no_retrace("serving.mutable")``; the no-reallocation check
stands beside it), and ``_join`` offers its call to ``capture_calls`` as
``mutable.dense_inner`` or ``mutable.sparse_inner`` for the audit
(``obs.audit``). Differences from the reference, by design: on the card
``block_rows`` must be 64, 128 or 256, K4's corpus blocks, and query
blocks of 256 rows go to K4 as two of 128.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings

import numpy as np
import torch

from repro_torch.checkpoint import (
    CheckpointCorruptionError,
    CheckpointManager,
    load_checkpoint,
)
from repro_torch.core.matches import Matches
from repro_torch.core.pruning import (
    BlockStats,
    dense_block_stats,
    live_tile_mask,
    sparse_block_stats,
)
from repro_torch.core.sparse import SparseCorpus, dedupe_rows, from_dense, to_dense
from repro_torch.interop import device_of
from repro_torch.kernels.apss_block.fused import (
    _RECT_CHUNK,
    _rect_tile_packets,
    live_masked,
    rect_tile_candidates_kernel,
)
from repro_torch.kernels.apss_block.ops import _pick_bk, compact_rect_worklist, fold_rect_packets
from repro_torch.obs import compile as obs_compile
from repro_torch.obs import trace
from repro_torch.planner import telemetry
from repro_torch.serving.index import APSSIndex, _resolved
from repro_torch.serving.query import _query_mask, query_topk

obs_compile.register_entry_points("serving.mutable", "rect_tile_candidates")

_META = "meta.json"
_K4_BLOCKS = (64, 128, 256)  # K4's corpus blocks (fused.rect_work_split)
_K4_MAX_Q = 128              # K4's largest query block
_SPARSE_CHUNK_BYTES = 1 << 28  # densified query blocks a sparse chunk may hold


def _p2(x: int) -> int:
    """Smallest power of two ≥ x (x ≥ 1)."""
    return 1 << max(0, (int(x) - 1).bit_length())


def _normalize_host(raw: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """L2-normalized rows, each norm one numpy reduction of its own row, so
    a row's bits do not depend on the rows normalized with it."""
    nrm = np.sqrt(np.add.reduce(raw * raw, axis=1))
    return (raw / np.maximum(nrm, np.float32(eps))[:, None]).astype(np.float32)


def _normalize_sparse_host(sp: SparseCorpus, eps: float = 1e-12) -> SparseCorpus:
    """``core.sparse.normalize_sparse`` with each row's norm one numpy
    reduction of its own components (see :func:`_normalize_host`)."""
    _, comp = dedupe_rows(sp.indices, sp.values)
    comp = comp.numpy()
    nrm = np.sqrt(np.add.reduce(comp * comp, axis=1))
    scale = (np.float32(1.0) / np.maximum(nrm, np.float32(eps))).astype(np.float32)
    return SparseCorpus(sp.indices, sp.values * torch.from_numpy(scale)[:, None], sp.nnz, sp.m)


def slot_dot(q: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """Sparse tile scores ``s[b, r, c] = Σ_j q[rows[b, r], idx[b, c, j]] ·
    val[b, c, j]`` for dense query rows ``q (N, m)`` (tile ``b``'s rows
    ``rows (B, R)``) against ELL corpus blocks ``idx``/``val (B, cols,
    cap)``, added 0 + p0 + p1 + ... in slot order, one elementwise product
    and sum per slot: a pair's bits depend on the query row and the corpus
    row's slots alone, on either device."""
    B, R = rows.shape
    cols, cap = idx.shape[1], idx.shape[2]
    r = rows.long()[:, :, None]
    idx = idx.long()
    acc = torch.zeros((B, R, cols), dtype=torch.float32, device=q.device)
    for j in range(cap):
        acc = acc + q[r, idx[:, None, :, j]] * val[:, None, :, j]
    return acc


def _np_merge(gv, gi, pv, pi, k):
    """Host merge of graph rows with packet rows, canonical order.

    Stable argsort on negated values (k best, ties to the earliest concat
    position). Old entries come first in the concat and always reference
    lower positions than a packet's new columns, so the tie-break matches
    the canonical (value desc, position asc).
    """
    av = np.concatenate([gv, pv], axis=1)
    ai = np.concatenate([gi, pi], axis=1)
    sel = np.argsort(-av, axis=1, kind="stable")[:, :k]
    v = np.take_along_axis(av, sel, axis=1)
    i = np.take_along_axis(ai, sel, axis=1)
    return v, np.where(v > -np.inf, i, -1)


def _replay_join(index, Q, wl, col_live, qpos, *, t, k, block_q, block_c):
    """A captured ``MutableAPSSIndex._join`` call run again. ``block_c`` is
    the index's ``block_rows``, named for the audit's work model."""
    del block_c
    return index._join(Q, wl, col_live, qpos, t=t, k=k, block_q=block_q)


def _empty(B: int, k: int) -> Matches:
    return Matches(np.full((B, k), -np.inf, np.float32), np.full((B, k), -1, np.int64),
                   np.zeros(B, np.int32))


class MutableAPSSIndex:
    """Live-corpus APSS index: append/delete log + standing top-k graph.

    Args:
      corpus: optional initial rows -- dense ``(n, m)`` or a
        :class:`SparseCorpus`; applied as the first append. Must be None
        when reopening an existing ``directory`` (the state on disk wins).
      threshold / k: the standing graph's match threshold and capacity,
        fixed for the index's lifetime (recorded in ``meta.json``).
      kind: ``"dense"`` / ``"sparse"``; inferred from the first corpus
        when omitted (SparseCorpus ⇒ sparse).
      block_rows: row-block size (a power of two; on the card 64, 128 or
        256) for stats and tiles.
      cap: pin the sparse ELL width. Bit-equality across instances
        requires equal caps (module doc, rule 2); unpinned caps widen on
        demand.
      compact_threshold: tombstone fraction that triggers auto-compaction
        inside :meth:`delete`.
      directory: WAL + snapshot root (``<dir>/log``, ``<dir>/state``);
        None disables durability.
      keep: snapshots kept (the WAL keeps every entry).
      fault_plan: a :class:`~repro_torch.robust.faults.FaultPlan` -- kill
        seams fire at ``"mutable.append"`` (post-WAL, pre-apply) and
        ``"mutable.commit"`` (post-apply, pre-snapshot).
      device: where the corpus rows and block stats live (default
        ``"cuda"``, which raises without a card).
    """

    def __init__(
        self,
        corpus=None,
        *,
        threshold: float,
        k: int = 32,
        kind: str | None = None,
        block_rows: int = 64,
        cap: int | None = None,
        compact_threshold: float = 0.25,
        directory: str | None = None,
        keep: int = 3,
        fault_plan=None,
        device: str | torch.device | None = None,
    ):
        if block_rows < 1 or block_rows & (block_rows - 1):
            raise ValueError(f"block_rows must be a power of two: {block_rows}")
        self.device = _resolved(device_of("cuda" if device is None else device))
        if self.device.type == "cuda" and block_rows not in _K4_BLOCKS:
            raise ValueError(
                f"block_rows must be one of {_K4_BLOCKS} on the card (K4's corpus "
                f"blocks): {block_rows}"
            )
        self.threshold = float(threshold)
        self.k = int(k)
        self.block_rows = int(block_rows)
        self.compact_threshold = float(compact_threshold)
        self.fault_plan = fault_plan
        self._kind = kind
        self._cap_param = cap
        self._m = None
        self._mlanes = None
        self._cap = cap
        # device state (None until the first append / restore)
        self._C = None
        self._idx = self._val = self._nnz = None
        self._maxw = self._mw = self._mnnz = None
        # host state
        self._ncap = 0
        self._nv = 0
        self._ndead = 0
        self._next_gid = 0
        self._gids = np.zeros(0, np.int64)
        self._live = np.zeros(0, bool)
        self._phys: dict[int, int] = {}
        self._gv = np.zeros((0, self.k), np.float32)
        self._gi = np.zeros((0, self.k), np.int64)
        self._gc = np.zeros(0, np.int64)
        self.version = 0
        self._op_seq = 0
        self._replaying = False
        self._view = None
        self._view_version = -1
        # durability
        self._dir = directory
        self._log_mgr = self._state_mgr = None
        if directory is not None:
            self._log_dir = os.path.join(directory, "log")
            self._state_dir = os.path.join(directory, "state")
            self._log_mgr = CheckpointManager(self._log_dir, keep=0)
            self._state_mgr = CheckpointManager(self._state_dir, keep=keep)
            self._check_meta()
        has_state = self._log_mgr is not None and (
            self._log_mgr.all_steps() or self._state_mgr.all_steps()
        )
        if has_state:
            if corpus is not None:
                raise ValueError(
                    f"directory {directory} already holds index state; "
                    "pass corpus=None to resume"
                )
            self._restore_and_replay()
        elif corpus is not None:
            self.append(corpus)

    # -- properties ---------------------------------------------------------

    @property
    def m(self) -> int | None:
        return self._m

    @property
    def kind(self) -> str | None:
        return self._kind

    @property
    def is_sparse(self) -> bool:
        return self._kind == "sparse"

    @property
    def n(self) -> int:
        """Live row count."""
        return self._nv - self._ndead

    def __repr__(self) -> str:
        return (
            f"MutableAPSSIndex(kind={self._kind}, live={self.n}, "
            f"dead={self._ndead}, version={self.version}, device={self.device})"
        )

    # -- meta / durability helpers ------------------------------------------

    def _meta_dict(self) -> dict:
        return {
            "kind": self._kind, "m": self._m, "k": self.k,
            "threshold": self.threshold, "block_rows": self.block_rows,
            "cap": self._cap_param,
            "compact_threshold": self.compact_threshold,
        }

    def _check_meta(self) -> None:
        path = os.path.join(self._dir, _META)
        if not os.path.exists(path):
            return
        with open(path) as f:
            meta = json.load(f)
        for key in ("k", "threshold", "block_rows", "compact_threshold"):
            if meta[key] != getattr(self, key):
                raise ValueError(
                    f"meta mismatch for {key}: directory has {meta[key]}, "
                    f"constructor got {getattr(self, key)}"
                )
        if self._kind is not None and meta["kind"] != self._kind:
            raise ValueError(
                f"meta mismatch for kind: directory has {meta['kind']}, "
                f"constructor got {self._kind}"
            )
        self._kind = meta["kind"]
        self._m = meta["m"]
        self._cap_param = meta["cap"]
        if self._cap is None:
            self._cap = meta["cap"]

    def _write_meta(self) -> None:
        if self._dir is None:
            return
        path = os.path.join(self._dir, _META)
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump(self._meta_dict(), f)

    def _log(self, entry: dict, seq: int) -> None:
        if self._log_mgr is not None and not self._replaying:
            self._log_mgr.save(entry, seq)

    def _kill(self, seq: int, scope: str) -> None:
        if self.fault_plan is not None and not self._replaying:
            self.fault_plan.kill_point(seq, scope)

    def _state_dict(self) -> dict:
        d = {
            "gids": self._gids, "live": self._live,
            "gv": self._gv, "gi": self._gi, "gc": self._gc,
            "maxw": self._maxw, "mw": self._mw, "mnnz": self._mnnz,
            "meta_ints": np.array(
                [self._nv, self._next_gid, self._op_seq, self.version,
                 self._ndead], np.int64,
            ),
        }
        if self.is_sparse:
            d.update(sidx=self._idx, sval=self._val, snnz=self._nnz)
        else:
            d["C"] = self._C
        return d

    def _load_state(self, d: dict) -> None:
        def dev(name, dtype):
            return torch.from_numpy(np.ascontiguousarray(d[name], dtype)).to(self.device)

        self._gids = np.asarray(d["gids"], np.int64)
        self._live = np.asarray(d["live"], bool)
        self._gv = np.asarray(d["gv"], np.float32)
        self._gi = np.asarray(d["gi"], np.int64)
        self._gc = np.asarray(d["gc"], np.int64)
        self._maxw = dev("maxw", np.float32)
        self._mw = dev("mw", np.float32)
        self._mnnz = dev("mnnz", np.int32)
        nv, ng, seq, ver, nd = (int(x) for x in d["meta_ints"])
        self._nv, self._next_gid, self._op_seq = nv, ng, seq
        self.version, self._ndead = ver, nd
        if self.is_sparse:
            self._idx = dev("sidx", np.int32)
            self._val = dev("sval", np.float32)
            self._nnz = dev("snnz", np.int32)
            self._ncap = self._idx.shape[0]
            self._cap = self._idx.shape[1]
        else:
            self._C = dev("C", np.float32)
            self._ncap = self._C.shape[0]
            self._mlanes = self._C.shape[1]
        self._phys = {
            int(g): int(p)
            for p, g in enumerate(self._gids)
            if g >= 0 and self._live[p]
        }

    def _snapshot(self) -> None:
        if self._state_mgr is not None:
            self._state_mgr.save(self._state_dict(), self._op_seq)

    def _restore_and_replay(self) -> None:
        with trace.span("mutable/replay"):
            self._restore_and_replay_inner()

    def _restore_and_replay_inner(self) -> None:
        latest = self._state_mgr.latest_step()
        state, step = self._state_mgr.restore(fallback=True)
        if state is not None:
            self._load_state(state)
            if step != latest:
                telemetry.incr("mutable.restore_fallback")
        replayed = 0
        for seq in sorted(self._log_mgr.all_steps()):
            if seq <= self._op_seq:
                continue
            if seq != self._op_seq + 1:
                break  # a hole in the log: stop at the contiguous prefix
            try:
                entry = load_checkpoint(self._log_dir, seq)
            except CheckpointCorruptionError as e:
                warnings.warn(
                    f"mutation log entry {seq} corrupt ({e}); "
                    "walking back this op",
                    stacklevel=2,
                )
                telemetry.incr("mutable.log_walkback")
                break
            op = int(np.asarray(entry["op"]))
            self._replaying = True
            try:
                if op == 1:
                    self._apply_append(np.asarray(entry["rows"], np.float32))
                elif op == 2:
                    self._apply_delete(np.asarray(entry["ids"], np.int64))
                elif op == 3:
                    self._compact()
                else:  # pragma: no cover - defensive
                    raise ValueError(f"unknown log op {op}")
            finally:
                self._replaying = False
            self._op_seq = seq
            replayed += 1
        if replayed:
            telemetry.incr("mutable.replayed_ops", replayed)
        # Drop log entries past the applied prefix (the walked-back op and
        # anything after): future ops must be able to reuse those steps,
        # since CheckpointManager.save skips existing step directories.
        for s in self._log_mgr.all_steps():
            if s > self._op_seq:
                shutil.rmtree(
                    os.path.join(self._log_dir, f"step_{s:010d}"),
                    ignore_errors=True,
                )
        if replayed:
            self._snapshot()

    # -- layout / capacity --------------------------------------------------

    def _coerce_rows(self, rows) -> np.ndarray:
        """Any accepted delta → raw (pre-normalization) dense f32 host array.

        The WAL stores exactly this canonical payload, so replay applies
        the same bytes the original call did.
        """
        if isinstance(rows, SparseCorpus):
            if self._kind is None:
                self._kind = "sparse"
            raw = to_dense(rows).cpu().numpy()
        elif isinstance(rows, torch.Tensor):
            raw = rows.detach().float().cpu().numpy()
        else:
            raw = np.asarray(rows, np.float32)
        if raw.ndim != 2:
            raise ValueError(f"rows must be 2-D, got shape {raw.shape}")
        if not np.all(np.isfinite(raw)):
            raise ValueError("rows contain non-finite values (NaN/inf)")
        if self._kind is None:
            self._kind = "dense"
        if self._m is None:
            self._m = int(raw.shape[1])
            self._write_meta()
        if raw.shape[1] != self._m:
            raise ValueError(f"rows dim {raw.shape[1]} != index m {self._m}")
        return raw

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _init_arrays(self) -> None:
        if self._ncap:
            return
        self._ncap = self.block_rows
        nb = self._ncap // self.block_rows
        if self.is_sparse:
            cap = self._cap or 1
            self._cap = cap
            self._idx = self._zeros((self._ncap, cap), torch.int32)
            self._val = self._zeros((self._ncap, cap), torch.float32)
            self._nnz = self._zeros((self._ncap,), torch.int32)
            width = self._m
        else:
            self._mlanes = self._m + (-self._m) % _pick_bk(self._m, 512)
            self._C = self._zeros((self._ncap, self._mlanes), torch.float32)
            width = self._mlanes
        self._maxw = self._zeros((nb, width), torch.float32)
        self._mw = self._zeros((nb,), torch.float32)
        self._mnnz = self._zeros((nb,), torch.int32)
        self._grow_host(self._ncap)

    def _grow_host(self, ncap: int) -> None:
        old = self._gids.shape[0]
        if ncap <= old:
            return
        pad = ncap - old
        self._gids = np.concatenate([self._gids, np.full(pad, -1, np.int64)])
        self._live = np.concatenate([self._live, np.zeros(pad, bool)])
        self._gv = np.concatenate(
            [self._gv, np.full((pad, self.k), -np.inf, np.float32)]
        )
        self._gi = np.concatenate(
            [self._gi, np.full((pad, self.k), -1, np.int64)]
        )
        self._gc = np.concatenate([self._gc, np.zeros(pad, np.int64)])

    def _grown(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """``x`` with ``rows`` rows, the new ones zero (a new allocation)."""
        out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        out[: x.shape[0]] = x
        return out

    def _ensure_capacity(self, need: int) -> None:
        """Grow every capacity array to a power-of-two row count ≥ need (the
        only place device state is reallocated, besides widening the ELL)."""
        if need <= self._ncap:
            return
        ncap = self._ncap
        while ncap < need:
            ncap *= 2
        nb = ncap // self.block_rows
        if self.is_sparse:
            self._idx = self._grown(self._idx, ncap)
            self._val = self._grown(self._val, ncap)
            self._nnz = self._grown(self._nnz, ncap)
        else:
            self._C = self._grown(self._C, ncap)
        self._maxw = self._grown(self._maxw, nb)
        self._mw = self._grown(self._mw, nb)
        self._mnnz = self._grown(self._mnnz, nb)
        self._grow_host(ncap)
        self._ncap = ncap

    def _widen_cap(self, need: int) -> None:
        """Widen the ELL layout with inert zero slots (sparse only).

        Widening adds slots to :func:`slot_dot`'s loop, so bit-equality
        across different realized caps is NOT guaranteed -- pin ``cap=``
        when bit-stability matters.
        """
        if need <= self._cap:
            return
        pad = need - self._cap
        self._idx = torch.nn.functional.pad(self._idx, (0, pad))
        self._val = torch.nn.functional.pad(self._val, (0, pad))
        self._cap = need

    def _stats(self) -> BlockStats:
        return BlockStats(self._maxw, self._mw, self._mnnz)

    def _set_stats(self, st: BlockStats, b0: int) -> None:
        """Write block stats ``st`` in place from block ``b0`` on."""
        nb = st.mw.shape[0]
        self._maxw[b0:b0 + nb] = st.maxw
        self._mw[b0:b0 + nb] = st.mw
        self._mnnz[b0:b0 + nb] = st.max_nnz

    def _gid_of(self, pi: np.ndarray) -> np.ndarray:
        """Physical column ids (−1 empty) → global ids."""
        return np.where(pi >= 0, self._gids[np.maximum(pi, 0)], -1)

    def _col_any(self) -> np.ndarray:
        return self._live.reshape(-1, self.block_rows).any(axis=1)

    # -- tile scoring --------------------------------------------------------

    def _join(self, Q: torch.Tensor | None, wl: np.ndarray, col_live: np.ndarray,
              qpos: np.ndarray, *, t: float, k: int, block_q: int):
        """Fold of the packets of host worklist ``wl (2, T)`` of (``block_q``-row
        query block of ``Q``, corpus block) tiles, masked by ``col_live``
        (corpus rows) and ``qpos`` (own corpus position per row of ``Q``, −1
        none). ``Q`` None (sparse only) is the corpus itself, densified per
        tile. Returns host ``(values, physical ids, counts)`` per row of
        ``Q``. The call is offered to ``obs.compile.capture_calls``; a
        replay (:func:`_replay_join`) runs against the index as it is then."""
        obs_compile.offer_capture(
            "mutable.sparse_inner" if self.is_sparse else "mutable.dense_inner", _replay_join,
            self, Q, wl, col_live, qpos, t=t, k=k, block_q=block_q, block_c=self.block_rows,
        )
        cl = torch.from_numpy(col_live).to(self.device)
        qp = torch.from_numpy(qpos.astype(np.int32)).to(self.device)
        n_rows = self._ncap if Q is None else Q.shape[0]
        if self.is_sparse:
            fv, fi, fc = self._sparse_packets(Q, wl, cl, qp, t=t, k=k, block_q=block_q)
        elif Q.device.type == "cpu":
            # The plain K4's bits for a pair depend on its product's shape:
            # score every tile at one, each query block zero-padded to
            # block_rows rows, and keep the packets of its own rows.
            br, grid = self.block_rows, Q.shape[0] // block_q
            Qx = torch.nn.functional.pad(Q.view(grid, block_q, -1), (0, 0, 0, br - block_q))
            qx = torch.nn.functional.pad(qp.view(grid, block_q), (0, br - block_q), value=-1)
            fv, fi, fc = (x[:, :block_q] for x in rect_tile_candidates_kernel(
                Qx.reshape(grid * br, -1), self._C, torch.from_numpy(wl), t, k, block_q=br,
                block_c=br, nc_valid=self._ncap, col_live=cl, qpos=qx.reshape(-1),
            ))
        else:
            f = max(1, block_q // _K4_MAX_Q)
            if f > 1:  # K4 takes query blocks of up to 128 rows: halve them
                block_q //= f
                wl = np.stack([(wl[0][:, None] * f + np.arange(f)).ravel(),
                               np.repeat(wl[1], f)]).astype(np.int32)
            fv, fi, fc = rect_tile_candidates_kernel(
                Q, self._C, torch.from_numpy(wl), t, k, block_q=block_q,
                block_c=self.block_rows, nc_valid=self._ncap, col_live=cl, qpos=qp,
            )
        v, i, c = fold_rect_packets(wl, np.ones(wl.shape[1], bool), fv, fi, fc[..., 0],
                                    grid_q=n_rows // block_q, block_q=block_q, k=k)
        return v.cpu().numpy(), i.cpu().numpy(), c.cpu().numpy()

    def _sparse_packets(self, Q, wl, col_live, qpos, *, t, k, block_q):
        """The sparse scorers: dense query blocks of ``Q`` (None: corpus
        blocks densified per tile) against raw ELL corpus blocks by
        :func:`slot_dot`, masked, then packets, a chunk of tiles at a time."""
        br, cap, m = self.block_rows, self._cap, self._m
        ib_, vb_ = self._idx.view(-1, br, cap), self._val.view(-1, br, cap)
        step = _RECT_CHUNK
        if Q is None:  # the densified blocks of a chunk stay under the budget
            step = max(1, min(step, _SPARSE_CHUNK_BYTES // (4 * br * m)))
        ij = torch.from_numpy(wl).to(self.device, torch.long)
        span = torch.arange(block_q, device=self.device)
        outs = []
        for a in range(0, ij.shape[1], step):
            i, j = ij[0, a:a + step], ij[1, a:a + step]
            if Q is None:
                q = self._zeros((i.shape[0] * br, m), torch.float32)
                q.scatter_add_(1, ib_[i].reshape(-1, cap).long(), vb_[i].reshape(-1, cap))
                rows = torch.arange(q.shape[0], device=self.device).view(-1, br)
            else:
                q, rows = Q, i[:, None] * block_q + span
            s = live_masked(slot_dot(q, rows, ib_[j], vb_[j]), i, j, col_live, qpos,
                            block_q=block_q, block_c=br)
            outs.append(_rect_tile_packets(s, j, threshold=t, k=k, block_q=block_q,
                                           block_c=br, nc_valid=self._ncap))
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def _mask(self, Qp: torch.Tensor, *, t: float, block_q: int,
              use_minsize: bool = True) -> np.ndarray:
        """Host live mask of ``Qp``'s query blocks against the live corpus blocks."""
        mask = _query_mask(Qp, self._stats(), threshold=t, block_q=block_q,
                           use_minsize=use_minsize, normalized=True)[0]
        return mask.cpu().numpy() & self._col_any()[None, :]

    # -- public mutations ---------------------------------------------------

    def append(self, rows) -> list[int]:
        """Append a batch of rows; returns their new global ids.

        WAL-first: the raw delta is logged, then applied (normalize → pack
        → window stats → delta join into the graph), then snapshotted.
        An empty delta is a no-op (no log entry, no version bump).
        """
        raw = self._coerce_rows(rows)
        if raw.shape[0] == 0:
            return []
        with trace.span("mutable/append", rows=int(raw.shape[0])):
            seq = self._op_seq + 1
            self._log({"op": np.int64(1), "rows": raw}, seq)
            self._kill(seq, "mutable.append")
            gids = self._apply_append(raw)
            self._op_seq = seq
            self._kill(seq, "mutable.commit")
            self._snapshot()
            telemetry.incr("serving.appends")
            return gids

    def delete(self, ids) -> int:
        """Tombstone rows by global id; repairs the graph exactly.

        Raises ``KeyError`` for unknown/dead ids (before logging anything).
        Returns the number of rows deleted. Auto-compacts when the dead
        fraction reaches ``compact_threshold``.
        """
        ids = np.asarray(list(ids), np.int64).reshape(-1)
        if len(set(ids.tolist())) != ids.shape[0]:
            raise ValueError("duplicate ids in delete batch")
        for g in ids:
            if int(g) not in self._phys:
                raise KeyError(f"unknown or already-deleted id {int(g)}")
        if ids.shape[0] == 0:
            return 0
        with trace.span("mutable/delete", rows=int(ids.shape[0])):
            seq = self._op_seq + 1
            self._log({"op": np.int64(2), "ids": ids}, seq)
            self._kill(seq, "mutable.append")
            self._apply_delete(ids)
            self._op_seq = seq
            self._kill(seq, "mutable.commit")
            self._snapshot()
            telemetry.incr("serving.deletes")
            return int(ids.shape[0])

    def compact(self) -> None:
        """Rewrite live rows contiguously (order preserved) and rebuild
        stats; logged as its own op so resume replays it."""
        with trace.span("mutable/compact"):
            seq = self._op_seq + 1
            self._log({"op": np.int64(3)}, seq)
            self._kill(seq, "mutable.append")
            self._compact()
            self._op_seq = seq
            self._kill(seq, "mutable.commit")
            self._snapshot()

    # -- mutation internals -------------------------------------------------

    def _apply_append(self, raw: np.ndarray) -> list[int]:
        self._coerce_rows(raw)  # replay path: sets kind/m/meta
        self._init_arrays()
        rb = raw.shape[0]
        rbp = _p2(max(8, rb))
        br = self.block_rows
        nv0 = self._nv
        self._ensure_capacity(nv0 + rbp)
        nb = self._ncap // br
        # window of blocks whose stats the delta can touch (+2, not +1:
        # a sub-block delta can still straddle a block boundary)
        wb = min(nb, rbp // br + 2)
        w0 = max(0, min(nv0 // br, nb - wb)) * br
        rows = slice(w0, w0 + wb * br)

        if self.is_sparse:
            sp = from_dense(raw, device="cpu")
            self._widen_cap(sp.cap)
            if sp.cap < self._cap:
                pad = (0, self._cap - sp.cap)
                sp = SparseCorpus(torch.nn.functional.pad(sp.indices, pad),
                                  torch.nn.functional.pad(sp.values, pad), sp.nnz, self._m)
            spn = _normalize_sparse_host(sp).to(self.device)
            self._idx[nv0:nv0 + rb] = spn.indices
            self._val[nv0:nv0 + rb] = spn.values
            self._nnz[nv0:nv0 + rb] = spn.nnz
            self._set_stats(sparse_block_stats(SparseCorpus(
                self._idx[rows], self._val[rows], self._nnz[rows], self._m), br), w0 // br)
            Qp = torch.nn.functional.pad(to_dense(spn), (0, 0, 0, rbp - rb))
            depth = self._cap
        else:
            self._C[nv0:nv0 + rb, : self._m] = torch.from_numpy(
                _normalize_host(raw)).to(self.device)
            self._set_stats(dense_block_stats(self._C[rows], br), w0 // br)
            Qp = self._C[nv0:nv0 + rbp]
            depth = self._mlanes

        gids = list(range(self._next_gid, self._next_gid + rb))
        self._gids[nv0:nv0 + rb] = gids
        self._live[nv0:nv0 + rb] = True
        for g, p in zip(gids, range(nv0, nv0 + rb)):
            self._phys[g] = p
        self._next_gid += rb
        self._nv = nv0 + rb
        self.version += 1

        # ---- forward join: new rows × all live rows (incl. new) ----
        t = self.threshold
        bqf = min(rbp, br)
        mask = self._mask(Qp, t=t, block_q=bqf)
        qpos_f = np.full(rbp, -1, np.int32)
        qpos_f[:rb] = nv0 + np.arange(rb)
        wlf = compact_rect_worklist(mask)
        tf = 0
        if wlf is not None:
            tf = wlf.shape[1]
            pv, pi, pc = self._join(Qp, wlf, self._live, qpos_f, t=t, k=self.k, block_q=bqf)
            pv, pi, pc = pv[:rb], pi[:rb], pc[:rb]
        else:
            pv = np.full((rb, self.k), -np.inf, np.float32)
            pi = np.full((rb, self.k), -1, np.int32)
            pc = np.zeros(rb, np.int32)
        self._gv[nv0:self._nv] = pv
        self._gi[nv0:self._nv] = self._gid_of(pi)
        self._gc[nv0:self._nv] = pc

        # ---- reverse join: live OLD rows × new rows ----
        tr = 0
        if nv0 > 0:
            old_live = self._live.copy()
            old_live[nv0:] = False
            if old_live.any():
                st = self._stats()
                mask_s = live_tile_mask(st, st, t, use_minsize=True,
                                        normalized=True).cpu().numpy()
                row_any_old = old_live.reshape(nb, br).any(axis=1)
                col_new = np.zeros(nb, bool)
                col_new[nv0 // br:(self._nv - 1) // br + 1] = True
                wlr = compact_rect_worklist(
                    mask_s & row_any_old[:, None] & col_new[None, :]
                )
                if wlr is not None:
                    tr = wlr.shape[1]
                    col_live_rev = np.zeros(self._ncap, bool)
                    col_live_rev[nv0:self._nv] = True
                    rv, ri, rc = self._join(
                        self._C, wlr, col_live_rev, np.arange(self._ncap), t=t, k=self.k,
                        block_q=br,
                    )
                    # merge ONLY into live old rows: new × new is already
                    # covered by the forward join (no double count)
                    rows_old = np.nonzero(old_live)[0]
                    v, i = _np_merge(self._gv[rows_old], self._gi[rows_old], rv[rows_old],
                                     self._gid_of(ri[rows_old]), self.k)
                    self._gv[rows_old] = v
                    self._gi[rows_old] = i
                    self._gc[rows_old] += rc[rows_old]

        if telemetry.enabled():
            total = mask.size + (nb * nb if nv0 > 0 else 0)
            telemetry.record(telemetry.ApssStats(
                variant="serving/delta-join",
                n=self.n, m=self._m, block_rows=br, sparse=self.is_sparse,
                flops=2.0 * (tf * bqf + tr * br) * br * depth,
                live_tiles=tf + tr, total_tiles=total,
                extra={
                    "delta": rb,
                    "live_fraction_rows": self.n / max(1, self._nv),
                    "model_flops": telemetry.delta_join_flops(
                        rb, self.n, depth
                    ),
                },
            ))
        return gids

    def _apply_delete(self, ids: np.ndarray) -> None:
        phys = np.array([self._phys[int(g)] for g in ids], np.int64)
        dead_set = {int(g) for g in ids}
        # A deleted row whose exact count exceeds k has neighbours missing
        # from its buffer: the affected set is unknowable, so rescore
        # every surviving row (exactness beats delta cost here).
        full_rescore = bool(np.any(self._gc[phys] > self.k))
        if full_rescore:
            affected = [
                int(g) for g in self._phys if int(g) not in dead_set
            ]
        else:
            neigh: set[int] = set()
            for p in phys:
                neigh.update(
                    int(g) for g in self._gi[p] if g >= 0
                )
            affected = [
                g for g in neigh
                if g not in dead_set and g in self._phys
            ]
        # tombstone + zero device rows (zeroed rows keep stale stats sound:
        # stats stay upper bounds over a superset)
        self._live[phys] = False
        self._gids[phys] = -1
        for g in ids:
            del self._phys[int(g)]
        self._ndead += int(phys.shape[0])
        pt = torch.from_numpy(phys).to(self.device)
        for x in ((self._idx, self._val, self._nnz) if self.is_sparse else (self._C,)):
            x[pt] = 0
        self._gv[phys] = -np.inf
        self._gi[phys] = -1
        self._gc[phys] = 0
        self.version += 1

        if affected:
            aff_phys = np.sort(
                np.array([self._phys[g] for g in affected], np.int64)
            )
            na = aff_phys.shape[0]
            abp = _p2(max(8, na))
            idxp = np.zeros(abp, np.int64)
            idxp[:na] = aff_phys
            qpos = np.full(abp, -1, np.int32)
            qpos[:na] = aff_phys
            take = torch.from_numpy(idxp).to(self.device)
            if self.is_sparse:
                Qa = self._zeros((abp, self._m), torch.float32)
                Qa.scatter_add_(1, self._idx[take].long(), self._val[take])
            else:
                Qa = self._C[take]
            bqa = min(abp, self.block_rows)
            wl = compact_rect_worklist(self._mask(Qa, t=self.threshold, block_q=bqa))
            if wl is not None:
                nv_, ni, nc = self._join(Qa, wl, self._live, qpos, t=self.threshold,
                                         k=self.k, block_q=bqa)
                nv_, ni, nc = nv_[:na], self._gid_of(ni[:na]), nc[:na]
            else:
                nv_ = np.full((na, self.k), -np.inf, np.float32)
                ni = np.full((na, self.k), -1, np.int64)
                nc = np.zeros(na, np.int64)
            # REPLACE the affected rows: a fresh canonical rescore equals
            # what a from-scratch rebuild would compute for them
            self._gv[aff_phys] = nv_
            self._gi[aff_phys] = ni
            self._gc[aff_phys] = nc

        if self._nv and self._ndead / self._nv >= self.compact_threshold:
            self._compact()

    def _compact(self) -> None:
        """Pack live rows contiguously in physical order (gid order) and
        rebuild exact stats, in place. No rescoring: row contents, gids and
        the graph are all preserved -- only physical positions change, and
        order preservation keeps the canonical tie-break intact."""
        self._init_arrays()
        order = np.nonzero(self._live)[0]
        nl = order.shape[0]
        ncap, br = self._ncap, self.block_rows
        src = torch.from_numpy(order).to(self.device)
        for x in ((self._idx, self._val, self._nnz) if self.is_sparse else (self._C,)):
            x[:nl] = x[src]
            x[nl:] = 0
        if self.is_sparse:
            st = sparse_block_stats(SparseCorpus(self._idx, self._val, self._nnz, self._m), br)
        else:
            st = dense_block_stats(self._C, br)
        self._set_stats(st, 0)
        gids = np.full(ncap, -1, np.int64)
        gids[:nl] = self._gids[order]
        live = np.zeros(ncap, bool)
        live[:nl] = True
        gv = np.full((ncap, self.k), -np.inf, np.float32)
        gi = np.full((ncap, self.k), -1, np.int64)
        gc = np.zeros(ncap, np.int64)
        gv[:nl] = self._gv[order]
        gi[:nl] = self._gi[order]
        gc[:nl] = self._gc[order]
        self._gids, self._live = gids, live
        self._gv, self._gi, self._gc = gv, gi, gc
        self._phys = {int(g): p for p, g in enumerate(gids[:nl])}
        self._nv, self._ndead = nl, 0
        self.version += 1
        telemetry.incr("serving.compactions")

    # -- queries ------------------------------------------------------------

    def graph(self) -> tuple[np.ndarray, Matches]:
        """The standing similarity graph over live rows.

        Returns ``(gids, Matches)``: live global ids in physical (== gid)
        order, and per-row top-k matches whose indices are GLOBAL ids
        (int64, −1 padded) with exact counts, all host numpy.
        """
        order = np.nonzero(self._live)[0]
        return self._gids[order].copy(), Matches(
            self._gv[order].copy(), self._gi[order].copy(), self._gc[order].copy())

    def as_index(self) -> APSSIndex:
        """A read-only :class:`APSSIndex` view for the kernel query path
        (dense only; zero-copy -- dead rows are already zeroed)."""
        if self.is_sparse:
            raise NotImplementedError(
                "sparse kernel path needs the per-block support compaction, "
                "which is not layout-stable under mutation; use the plain path"
            )
        if self._view is None or self._view_version != self.version:
            self._view = APSSIndex(
                self._C, self._stats(), None, None,
                n=self._nv, m=self._m, block_rows=self.block_rows,
                kind="dense", normalized=True,
            )
            self._view_version = self.version
        return self._view

    def query(
        self,
        Q,
        threshold: float | None = None,
        k: int | None = None,
        *,
        block_q: int | None = None,
        use_kernel: bool = False,
        use_minsize: bool = True,
    ) -> Matches:
        """Top-k live neighbours for a dense query batch ``(B, m)``, scored
        as given (the server normalizes).

        Returns host Matches whose indices are GLOBAL ids (int64). The
        default path scores through K4's masked entry (dense; its plain
        version on a CPU index) or :func:`slot_dot` (sparse) and masks dead
        rows explicitly, sound at any threshold; ``use_kernel`` serves
        through :meth:`as_index` and ``query_topk``'s unmasked K4, where dead
        rows are merely zero vectors, so it requires ``threshold > 0``.
        """
        t = self.threshold if threshold is None else float(threshold)
        kk = self.k if k is None else int(k)
        if isinstance(Q, SparseCorpus):
            Q = to_dense(Q)
        if isinstance(Q, torch.Tensor):
            Q = Q.detach().cpu().numpy()
        Q = np.asarray(Q, np.float32)
        if Q.ndim != 2 or (self._m is not None and Q.shape[1] != self._m):
            raise ValueError(f"Q must be (B, {self._m}); got {Q.shape}")
        B = Q.shape[0]
        if self.n == 0 or B == 0:
            return _empty(B, kk)
        if use_kernel:
            if t <= 0:
                raise ValueError(
                    "use_kernel requires threshold > 0: the kernel view "
                    "cannot mask tombstoned (zeroed) rows, which match "
                    "everything at t <= 0"
                )
            m = query_topk(
                self.as_index(), torch.from_numpy(Q).to(self.device), t, kk,
                block_q=block_q or 128, use_kernel=True, use_minsize=use_minsize,
            )
            return Matches(m.values.cpu().numpy(), self._gid_of(m.indices.cpu().numpy()),
                           m.counts.cpu().numpy())
        br = self.block_rows
        Bp = _p2(max(8, B))
        bq = max(8, min(Bp, _p2(block_q) if block_q else br, br))
        width = self._m if self.is_sparse else self._mlanes
        Qp = self._zeros((Bp, width), torch.float32)
        Qp[:B, : self._m] = torch.from_numpy(Q).to(self.device)
        wl = compact_rect_worklist(self._mask(Qp, t=t, block_q=bq, use_minsize=use_minsize))
        if wl is None:
            return _empty(B, kk)
        v, i, c = self._join(Qp, wl, self._live, np.full(Bp, -1, np.int32), t=t, k=kk,
                             block_q=bq)
        return Matches(v[:B], self._gid_of(i[:B]), c[:B])
