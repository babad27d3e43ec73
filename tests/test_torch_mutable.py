"""The port's live corpus (``repro_torch.serving.mutable``) on the CPU.

Three kinds of checks, at the reference tests' sizes (``M = 24``,
``T = 0.15``, ``K = 8``, ``CAP = 16``):

- **Metamorphic, port against port**: after any interleaving of append,
  delete and compact, the port's mutated index is bit-identical to a fresh
  port index over the surviving rows, graph and queries (the reference's
  ``tests/test_mutable_index.py`` cases, seeds 1-3, dense and sparse).
- **Port against the JAX package**: the same op sequence through
  ``repro.serving.MutableAPSSIndex`` and the port gives the same gids and
  counts, the same match sets and values within ``VAL_TOL`` = 1e-5 (the
  two normalize and sum in other orders; every float64 score of the data
  is first asserted more than 1e-5 from t, so no pair can cross it), the
  port's rows ordered by (value desc, gid asc); the same for ``query``
  with and without ``use_kernel`` (the reference's kernel lane in Pallas
  interpret mode) and for the ``serving/delta-join`` telemetry records.
- **K4's masked entry, durability and the server**: the plain version of
  the masked entry against the unmasked one and against the reference's
  ``_mut_dense_inner``; WAL kill points, walk-back, meta guards and
  directories reopened across the two packages; the version-keyed LRU, the
  stale tier, and a ``KernelError`` that is not degraded past.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.planner import telemetry as rtelemetry  # noqa: E402
from repro.robust.faults import Fault as RFault  # noqa: E402
from repro.robust.faults import FaultPlan as RFaultPlan  # noqa: E402
from repro.serving import MutableAPSSIndex as RefIndex  # noqa: E402
from repro_torch.core.apss import apss_reference  # noqa: E402
from repro_torch.core.sparse import from_dense, to_dense  # noqa: E402
from repro_torch.kernels._build import KernelError  # noqa: E402
from repro_torch.kernels.apss_block import fused  # noqa: E402
from repro_torch.kernels.apss_block.ops import fold_rect_packets  # noqa: E402
from repro_torch.planner import telemetry  # noqa: E402
from repro_torch.robust import Fault, FaultPlan, SweepKilled  # noqa: E402
from repro_torch.serving import MutableAPSSIndex, RetrievalServer  # noqa: E402
from repro_torch.serving import mutable as tmutable  # noqa: E402
from repro_torch.serving import query as tquery  # noqa: E402

T = 0.15
K = 8
M = 24
CAP = 16  # pinned ELL width: sparse bit-equality requires equal caps
GAP = 1e-5
VAL_TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _rows(rng, n, sparse=False):
    """Raw (pre-normalization) rows; sparse-ish rows zero most entries."""
    D = rng.normal(size=(n, M)).astype(np.float32)
    if sparse:
        mask = rng.random((n, M)) < 0.25
        mask[np.arange(n), rng.integers(0, M, n)] = True  # every row keeps one
        D = np.where(mask, D, 0.0).astype(np.float32)
    return D


def _idx(corpus=None, **kw):
    kw.setdefault("threshold", T)
    kw.setdefault("k", K)
    return MutableAPSSIndex(corpus, device="cpu", **kw)


def _fresh(model, kind):
    """The oracle: a fresh port index over the surviving rows in gid order."""
    gids = np.asarray([g for g, _ in model], np.int64)
    D = np.stack([r for _, r in model]) if model else None
    return _idx(D, kind=kind, cap=CAP), gids


def _translate(indices, surv):
    """Oracle physical gids (0..n-1) → the mutated index's global ids."""
    return np.where(indices >= 0, surv[np.maximum(indices, 0)], -1)


def _assert_state_equal(mi, model, queries):
    """Graph AND query results bit-equal between mutated index and oracle."""
    oracle, surv = _fresh(model, mi.kind or "dense")
    gids, g = mi.graph()
    assert np.array_equal(gids, surv)
    if model:
        _, og = oracle.graph()
        assert np.array_equal(g.values, og.values)
        assert np.array_equal(g.indices, _translate(og.indices, surv))
        assert np.array_equal(g.counts, og.counts)
    r, ro = mi.query(queries), oracle.query(queries)
    assert np.array_equal(r.values, ro.values)
    if model:
        assert np.array_equal(r.indices, _translate(ro.indices, surv))
    assert np.array_equal(r.counts, ro.counts)


def _random_ops(mi, rng, sparse, steps, after):
    """The reference's random interleaving of append/delete/compact/query;
    ``after(model)`` runs after every step."""
    model = []
    for _ in range(steps):
        live = [g for g, _ in model]
        op = rng.choice(["append", "delete", "compact", "query"])
        if op == "append" or not live:
            raw = _rows(rng, int(rng.integers(1, 9)), sparse=sparse)
            model += list(zip(mi.append(raw), raw))
        elif op == "delete":
            n_del = int(rng.integers(1, min(4, len(live)) + 1))
            victims = sorted(int(g) for g in rng.choice(live, size=n_del, replace=False))
            mi.delete(victims)
            model = [(g, r) for g, r in model if g not in set(victims)]
        elif op == "compact":
            mi.compact()
        after(model)
    return model


# -- metamorphic: port against port ------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_append_then_delete_then_compact_bit_equal(kind):
    rng = np.random.default_rng(0)
    D = _rows(rng, 48, sparse=kind == "sparse")
    Q = _rows(rng, 5, sparse=kind == "sparse")
    mi = _idx(D[:32], kind=kind, cap=CAP)
    model = [(g, D[g]) for g in range(32)]
    _assert_state_equal(mi, model, Q)
    mi.append(D[32:])
    model += [(g, D[g]) for g in range(32, 48)]
    _assert_state_equal(mi, model, Q)
    mi.delete([3, 9, 40])
    model = [(g, r) for g, r in model if g not in (3, 9, 40)]
    _assert_state_equal(mi, model, Q)
    mi.compact()
    _assert_state_equal(mi, model, Q)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_metamorphic_random_sequences(kind, seed):
    """Random interleaved append/delete/query/compact, oracle-checked after
    every step: the headline metamorphic property, fixed-seed."""
    rng = np.random.default_rng(seed)
    sparse = kind == "sparse"
    Q = _rows(rng, 4, sparse=sparse)
    mi = _idx(kind=kind, cap=CAP)
    _random_ops(mi, rng, sparse, 14, lambda model: _assert_state_equal(mi, model, Q))


@pytest.mark.parametrize("block_rows", [8, 16, 256])
def test_metamorphic_at_other_block_sizes(block_rows):
    """Other row blocks on the CPU (the card takes 64, 128 and 256): query
    blocks smaller and larger than K4's 128-row limit (the card cuts the
    latter in two), every tile scored by the plain version with its query
    block padded to block_rows rows."""
    rng = np.random.default_rng(21)
    D = _rows(rng, 300)
    Q = _rows(rng, 5)
    kw = dict(block_rows=block_rows, kind="dense")
    mi = _idx(D[:200], **kw)
    mi.append(D[200:])
    mi.delete([5, 150, 260])
    keep = [g for g in range(300) if g not in (5, 150, 260)]
    oracle = _idx(D[keep], **kw)
    surv = np.asarray(keep)
    _, g = mi.graph()
    _, og = oracle.graph()
    assert np.array_equal(g.values, og.values)
    assert np.array_equal(g.indices, _translate(og.indices, surv))
    assert np.array_equal(g.counts, og.counts)
    r, ro = mi.query(Q), oracle.query(Q)
    assert np.array_equal(r.values, ro.values)
    assert np.array_equal(r.indices, _translate(ro.indices, surv))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_sparse_input_path_matches_dense_payload(kind):
    """Appending a SparseCorpus equals appending its dense form (the WAL
    canonicalizes to raw dense either way)."""
    rng = np.random.default_rng(4)
    D = _rows(rng, 24, sparse=True)
    sp = from_dense(D, device="cpu")
    a = _idx(kind=kind, cap=CAP)
    a.append(sp)
    b = _idx(D, kind=kind, cap=CAP)
    ga, gb = a.graph()[1], b.graph()[1]
    assert np.array_equal(ga.values, gb.values)
    assert np.array_equal(ga.indices, gb.indices)
    assert tuple(to_dense(sp).shape) == D.shape


def test_graph_values_match_brute_force_reference():
    """Anchor against the port's O(n²) oracle: the standing graph is the
    all-pairs result (counts exact, values within 1e-5)."""
    rng = np.random.default_rng(5)
    D = _rows(rng, 40)
    mi = _idx(D[:24])
    mi.append(D[24:])
    Dn = D / np.linalg.norm(D, axis=1, keepdims=True)
    ref = apss_reference(Dn, T, K, device="cpu")
    _, g = mi.graph()
    assert np.array_equal(g.counts, ref.counts.numpy())
    finite = g.values > -np.inf
    assert np.array_equal(finite, ref.values.numpy() > -np.inf)
    assert np.allclose(g.values[finite], ref.values.numpy()[finite], atol=VAL_TOL)


def test_duplicate_rows_tie_break_is_canonical():
    """Exact duplicate rows force score ties; the (value desc, position
    asc) order must make mutated == rebuilt bit for bit."""
    rng = np.random.default_rng(6)
    base = _rows(rng, 12)
    dup = np.concatenate([base, base[:5]])
    mi = _idx(base)
    mi.append(base[:5])
    model = [(g, dup[g]) for g in range(17)]
    mi.delete([2])  # deleting one twin re-ranks its duplicate's row
    model = [(g, r) for g, r in model if g != 2]
    _assert_state_equal(mi, model, base[:3])
    mi.compact()
    _assert_state_equal(mi, model, base[:3])


def test_empty_delta_and_empty_delete_are_noops():
    rng = np.random.default_rng(7)
    mi = _idx(_rows(rng, 16))
    v = mi.version
    assert mi.append(np.zeros((0, M), np.float32)) == []
    assert mi.delete([]) == 0
    assert mi.version == v


def test_delete_everything_then_revive():
    rng = np.random.default_rng(8)
    D = _rows(rng, 16)
    mi = _idx(D)
    mi.delete(list(range(16)))
    assert mi.n == 0
    r = mi.query(D[:3])
    assert np.all(r.indices == -1) and np.all(r.counts == 0)
    gids = mi.append(D[:8])
    assert gids == list(range(16, 24))  # gids are never reused
    _assert_state_equal(mi, list(zip(gids, D[:8])), D[:3])


def test_delete_of_an_overflowing_row_rescores_everything():
    """A deleted row whose count exceeds k has neighbours missing from its
    buffer: every survivor is rescored, and the graph stays exact."""
    rng = np.random.default_rng(22)
    base = _rows(rng, 1)
    D = base + 0.05 * rng.normal(size=(20, M)).astype(np.float32)  # one tight cluster
    mi = _idx(D)
    assert mi.graph()[1].counts[0] > K
    mi.delete([0])
    _assert_state_equal(mi, [(g, D[g]) for g in range(1, 20)], D[:2])


def test_auto_compact_on_tombstone_fraction():
    rng = np.random.default_rng(9)
    D = _rows(rng, 32)
    mi = _idx(D, compact_threshold=0.25)
    with telemetry.CommLog() as log:
        mi.delete(list(range(8)))  # 8/32 = exactly the threshold
    assert log.counters["serving.compactions"] == 1
    assert mi._ndead == 0
    _assert_state_equal(mi, [(g, D[g]) for g in range(8, 32)], D[:3])


def test_input_validation():
    rng = np.random.default_rng(10)
    mi = _idx(_rows(rng, 16))
    with pytest.raises(ValueError, match="non-finite"):
        mi.append(np.full((2, M), np.nan, np.float32))
    with pytest.raises(ValueError, match="!= index m"):
        mi.append(np.ones((2, M + 1), np.float32))
    with pytest.raises(KeyError, match="unknown"):
        mi.delete([99])
    with pytest.raises(ValueError, match="duplicate"):
        mi.delete([1, 1])
    with pytest.raises(ValueError, match="power of two"):
        _idx(block_rows=48)


def test_entry_point_defaults_to_the_card():
    """No ``device``: the index is for the card, and without one it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        MutableAPSSIndex(threshold=T)


# -- kernel lane ---------------------------------------------------------------


def test_kernel_lane_matches_oracle_kernel():
    """The dense kernel path serves through the zero-copy APSSIndex view
    (``query_topk``'s K4, its plain version here): bit-equal to the
    oracle's kernel path and to the masked default path."""
    rng = np.random.default_rng(11)
    D = _rows(rng, 96)
    mi = _idx(D[:64], block_rows=64)
    mi.append(D[64:])
    mi.delete([0, 70])
    keep = [i for i in range(96) if i not in (0, 70)]
    oracle = _idx(D[keep], block_rows=64)
    surv = np.asarray(keep, np.int64)
    Q = _rows(rng, 5)
    r = mi.query(Q, use_kernel=True)
    ro = oracle.query(Q, use_kernel=True)
    assert np.array_equal(r.values, ro.values)
    assert np.array_equal(r.indices, _translate(ro.indices, surv))
    rx = mi.query(Q)  # and the kernel lane agrees with the default lane
    assert np.array_equal(r.values, rx.values)
    assert np.array_equal(r.indices, rx.indices)


def test_kernel_lane_guards():
    rng = np.random.default_rng(12)
    mi = _idx(_rows(rng, 16))
    with pytest.raises(ValueError, match="threshold > 0"):
        # tombstoned rows are zero vectors in the kernel view
        mi.query(_rows(rng, 2), threshold=0.0, use_kernel=True)
    ms = _idx(_rows(rng, 16, sparse=True), kind="sparse")
    with pytest.raises(NotImplementedError, match="layout-stable"):
        ms.query(_rows(rng, 2), use_kernel=True)


def test_dense_delta_joins_go_through_k4s_masked_entry(monkeypatch):
    """Every dense join (forward, reverse, repair, query) calls the K4
    wrapper with both masks; a KernelError there propagates (no plain
    fallback)."""
    calls = []
    real = tmutable.rect_tile_candidates_kernel

    def spy(*a, **kw):
        calls.append((kw["col_live"] is not None, kw["qpos"] is not None))
        return real(*a, **kw)

    monkeypatch.setattr(tmutable, "rect_tile_candidates_kernel", spy)
    rng = np.random.default_rng(23)
    D = _rows(rng, 80)
    mi = _idx(D[:64])
    mi.append(D[64:])
    mi.delete([1])
    mi.query(D[:2])
    assert len(calls) >= 4 and all(a and b for a, b in calls)

    def broken(*a, **kw):
        raise KernelError("apss_rect_tile_candidates_f32_f32 launch failed")

    monkeypatch.setattr(tmutable, "rect_tile_candidates_kernel", broken)
    with pytest.raises(KernelError):
        mi.append(D[:4])


# -- no reallocation (the port's counterpart of the reference's
#    test_no_retrace_on_repeated_same_shape_appends) -----------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_no_reallocation_on_repeated_same_bucket_appends(kind):
    """Eager PyTorch does not trace, so the reference's no-retrace contract
    becomes this one: appends within the capacity write in place, and
    every device tensor of the state keeps its storage."""
    rng = np.random.default_rng(13)
    sparse = kind == "sparse"
    mi = _idx(_rows(rng, 16, sparse), block_rows=64, kind=kind, cap=CAP)
    names = ("_idx", "_val", "_nnz") if sparse else ("_C",)
    names += ("_maxw", "_mw", "_mnnz")
    Q = _rows(rng, 4, sparse)
    mi.append(_rows(rng, 8, sparse))
    mi.query(Q)
    ncap = mi._ncap
    ptrs = {n: getattr(mi, n).data_ptr() for n in names}
    for _ in range(2):  # rows 24 → 32 → 40, all within the 64-row capacity
        mi.append(_rows(rng, 8, sparse))
        mi.query(Q)
    mi.delete([int(mi.graph()[0][0])])
    mi.compact()
    assert mi._ncap == ncap
    assert {n: getattr(mi, n).data_ptr() for n in names} == ptrs


# -- port against the JAX package ---------------------------------------------


def _unit64(rows):
    rows = np.asarray(rows, np.float64)
    return rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)


def _assert_clear(model, Q):
    """No float64 score among the survivors (and of the queries against
    them) within GAP of t, so both packages keep the same pairs."""
    if not model:
        return
    X = _unit64([r for _, r in model])
    S = X @ X.T
    np.fill_diagonal(S, np.inf)
    Sq = np.asarray(Q, np.float64) @ X.T
    gap = min(float(np.abs(S - T).min()), float(np.abs(Sq - T).min()))
    assert gap > GAP, f"a score lies {gap:.2e} from t: pick another seed"


def _assert_agree(got, ref):
    """Port Matches against reference Matches (global ids on both): counts
    exact, match sets equal, values by id within VAL_TOL, and the port's
    rows ordered by (value desc, gid asc)."""
    gv, gi, gc = (np.asarray(x) for x in got)
    rv, ri, rc = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(gc, rc)
    go, ro = np.argsort(gi, axis=1, kind="stable"), np.argsort(ri, axis=1, kind="stable")
    np.testing.assert_array_equal(np.take_along_axis(gi, go, 1), np.take_along_axis(ri, ro, 1))
    np.testing.assert_allclose(np.take_along_axis(gv, go, 1), np.take_along_axis(rv, ro, 1),
                               atol=VAL_TOL)
    real = gi >= 0
    assert not (~real[:, :-1] & real[:, 1:]).any()
    a, b = gv[:, :-1], gv[:, 1:]
    ok = (a > b) | ((a == b) & (gi[:, :-1] < gi[:, 1:]))
    assert (ok | ~(real[:, :-1] & real[:, 1:])).all()


def _assert_same_as_reference(mi, ri, model, Q, *, kernel=False):
    _assert_clear(model, Q)
    (pg, pm), (rg, rm) = mi.graph(), ri.graph()
    np.testing.assert_array_equal(pg, np.asarray(rg))
    _assert_agree(pm, rm)
    _assert_agree(mi.query(Q), ri.query(Q))
    if kernel:
        _assert_agree(mi.query(Q, use_kernel=True), ri.query(Q, use_kernel=True))


class _Both:
    """One op sequence through the port and the reference."""

    def __init__(self, **kw):
        self.port = _idx(**kw)
        self.ref = RefIndex(threshold=T, k=K, **kw)

    def append(self, raw):
        a, b = self.port.append(raw), self.ref.append(raw)
        assert a == b
        return a

    def delete(self, ids):
        assert self.port.delete(ids) == self.ref.delete(ids)

    def compact(self):
        self.port.compact()
        self.ref.compact()


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_sequences_agree_with_reference(kind, seed):
    rng = np.random.default_rng(seed)
    sparse = kind == "sparse"
    Q = _unit64(_rows(rng, 4, sparse=sparse)).astype(np.float32)
    both = _Both(kind=kind, cap=CAP)
    _random_ops(both, rng, sparse, 14, lambda model: _assert_same_as_reference(
        both.port, both.ref, model, Q))


def test_kernel_lane_agrees_with_reference_interpret():
    """``query(use_kernel=True)``: the port's K4 (plain version here)
    against the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(27)  # no float64 score within GAP of t
    D = _rows(rng, 200)
    both = _Both(block_rows=64)
    both.append(D[:150])
    both.append(D[150:])
    both.delete([0, 70, 160])
    model = [(g, D[g]) for g in range(200) if g not in (0, 70, 160)]
    Q = _unit64(_rows(rng, 6)).astype(np.float32)
    _assert_same_as_reference(both.port, both.ref, model, Q, kernel=True)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_delta_join_records_equal_reference(kind):
    rng = np.random.default_rng(16)
    D = _rows(rng, 96, sparse=kind == "sparse")
    with telemetry.CommLog() as plog, rtelemetry.CommLog() as rlog:
        both = _Both(kind=kind, cap=CAP)
        both.append(D[:64])
        both.append(D[64:])
        both.delete([0])
        both.compact()
    for name in ("serving.appends", "serving.deletes", "serving.compactions"):
        assert plog.counters[name] == rlog.counters[name] > 0
    prec, rrec = plog.by_variant("serving/delta-join"), rlog.by_variant("serving/delta-join")
    assert len(prec) == len(rrec) == 2
    for p, r in zip(prec, rrec):
        assert (p.n, p.m, p.block_rows, p.sparse) == (r.n, r.m, r.block_rows, r.sparse)
        assert (p.flops, p.live_tiles, p.total_tiles) == (r.flops, r.live_tiles, r.total_tiles)
        assert p.extra == r.extra
    depth = CAP if kind == "sparse" else both.port._mlanes
    assert prec[1].extra["model_flops"] == telemetry.delta_join_flops(32, 96, depth)


# -- K4's masked entry: plain version --------------------------------------------


def _masked_inputs(seed, *, nq=24, nc=256, bq=8, bc=64):
    rng = np.random.default_rng(seed)
    C = _unit64(rng.normal(size=(nc, 128))).astype(np.float32)
    C[200:] = 0  # capacity rows past the live ones
    Q = np.zeros((nq, 128), np.float32)
    Q[:20] = C[40:60]  # query rows that are corpus rows (own positions)
    col_live = np.ones(nc, bool)
    col_live[[3, 41, 77, 130]] = False
    col_live[200:] = False
    qpos = np.full(nq, -1, np.int32)
    qpos[:20] = np.arange(40, 60)
    qi, cj = np.meshgrid(np.arange(nq // bq), np.arange(nc // bc), indexing="ij")
    wl = np.stack([qi.ravel(), cj.ravel()]).astype(np.int32)
    return Q, C, col_live, qpos, wl


def test_masked_plain_without_masks_equals_unmasked_bit_for_bit():
    Q, C, _, _, wl = _masked_inputs(31)
    kw = dict(block_q=8, block_c=64, nc_valid=200)
    Qt, Ct, ij = torch.from_numpy(Q), torch.from_numpy(C), torch.from_numpy(wl)
    plain = fused.rect_tile_candidates_plain(Qt, Ct, ij, 0.2, 8, **kw)
    ones = torch.ones(C.shape[0], dtype=torch.bool)
    none = torch.full((Q.shape[0],), -1, dtype=torch.int32)
    masked = fused.rect_tile_candidates_plain(Qt, Ct, ij, 0.2, 8, col_live=ones, qpos=none,
                                              **kw)
    wrapped = fused.rect_tile_candidates_kernel(Qt, Ct, ij, 0.2, 8, col_live=ones, qpos=none,
                                                **kw)
    for a, b, c in zip(plain, masked, wrapped):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(plain[2].sum()) > 0


@pytest.mark.parametrize("t", [0.2, -0.1])
def test_masked_plain_equals_reference_mut_dense_inner(t):
    """With masks, the fold of the masked entry's plain version equals the
    reference's ``_mut_dense_inner`` on the same worklist; at t ≤ 0 the
    dead and own columns still never match."""
    from repro.serving.mutable import _mut_dense_inner

    Q, C, col_live, qpos, wl = _masked_inputs(32)
    S = _unit64(Q) @ _unit64(C).T
    assert float(np.abs(S - t).min()) > GAP
    bq, bc, k = 8, 64, 8
    grid_q = Q.shape[0] // bq
    fv, fi, fc = fused.rect_tile_candidates_plain(
        torch.from_numpy(Q), torch.from_numpy(C), torch.from_numpy(wl), t, k,
        block_q=bq, block_c=bc, nc_valid=C.shape[0], col_live=torch.from_numpy(col_live),
        qpos=torch.from_numpy(qpos))
    got = fold_rect_packets(wl, np.ones(wl.shape[1], bool), fv, fi, fc[..., 0],
                            grid_q=grid_q, block_q=bq, k=k)
    ref = _mut_dense_inner(jnp.asarray(Q), jnp.asarray(C), jnp.asarray(col_live),
                           jnp.asarray(qpos), jnp.asarray(wl),
                           jnp.ones(wl.shape[1], bool), threshold=t, k=k, block_q=bq,
                           block_c=bc, grid_q=grid_q)
    _assert_agree([x.numpy() for x in got], [np.asarray(x) for x in ref])
    ids = got[1].numpy()
    assert not np.isin(ids, [3, 41, 77, 130]).any()
    assert not (ids[:20] == np.arange(40, 60)[:, None]).any()


# -- durability ------------------------------------------------------------------


def _graph_equal(a, b):
    assert np.array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert np.array_equal(x, y)


def test_reopen_restores_bit_identical_state(tmp_path):
    rng = np.random.default_rng(14)
    D = _rows(rng, 48)
    d = str(tmp_path / "idx")
    mi = _idx(D[:32], directory=d)
    mi.append(D[32:])
    mi.delete([1, 33])
    re = _idx(corpus=None, directory=d)
    _graph_equal(mi.graph(), re.graph())
    Q = _rows(rng, 3)
    ra, rb = mi.query(Q), re.query(Q)
    assert np.array_equal(ra.values, rb.values)
    assert np.array_equal(ra.indices, rb.indices)


def test_reopen_guards(tmp_path):
    rng = np.random.default_rng(15)
    d = str(tmp_path / "idx")
    _idx(_rows(rng, 16), directory=d)
    with pytest.raises(ValueError, match="corpus=None to resume"):
        _idx(_rows(rng, 8), directory=d)
    with pytest.raises(ValueError, match="meta mismatch"):
        _idx(corpus=None, threshold=0.9, directory=d)
    with pytest.raises(ValueError, match="meta mismatch for kind"):
        _idx(corpus=None, kind="sparse", directory=d)


@pytest.mark.parametrize("scope", ["mutable.append", "mutable.commit"])
@pytest.mark.parametrize("op", ["append", "delete", "compact"])
def test_kill_then_reopen_is_bit_identical(tmp_path, scope, op):
    """A kill after the WAL write (before apply, or before the snapshot)
    and a reopen replay the op: the reopened index equals one that never
    died."""
    rng = np.random.default_rng(24)
    D = _rows(rng, 56)
    d = str(tmp_path / "idx")
    plan = FaultPlan([Fault("kill", scope=scope, step=3)])
    mi = _idx(D[:32], directory=d, fault_plan=plan)
    mi.append(D[32:48])
    ops = {"append": lambda x: x.append(D[48:]), "delete": lambda x: x.delete([2, 40]),
           "compact": lambda x: x.compact()}
    with pytest.raises(SweepKilled):
        ops[op](mi)
    assert plan.fired[f"kill:{scope}"] == 1
    with telemetry.CommLog() as log:
        re = _idx(corpus=None, directory=d)
    assert log.counters["mutable.replayed_ops"] == 1
    alive = _idx(D[:32])
    alive.append(D[32:48])
    ops[op](alive)
    _graph_equal(re.graph(), alive.graph())
    assert re.version == alive.version


def test_corrupt_log_entry_walks_back_that_op(tmp_path):
    rng = np.random.default_rng(25)
    D = _rows(rng, 48)
    d = str(tmp_path / "idx")
    plan = FaultPlan([Fault("kill", scope="mutable.append", step=2)])
    mi = _idx(D[:32], directory=d, fault_plan=plan)
    with pytest.raises(SweepKilled):
        mi.append(D[32:])
    FaultPlan(seed=1).corrupt_file(os.path.join(d, "log", "step_0000000002", "rows.npy"))
    with telemetry.CommLog() as log, pytest.warns(UserWarning, match="walking back"):
        re = _idx(corpus=None, directory=d)
    assert log.counters["mutable.log_walkback"] == 1
    _graph_equal(re.graph(), _idx(D[:32]).graph())
    assert re.append(D[32:]) == list(range(32, 48))  # the walked-back step is reusable
    _graph_equal(re.graph(), _idx(D).graph())


def test_snapshot_fallback_replays_the_gap(tmp_path):
    """A corrupt newest snapshot falls back one kept snapshot and replays
    the op gap from the WAL."""
    rng = np.random.default_rng(28)
    D = _rows(rng, 64)
    d = str(tmp_path / "idx")
    mi = _idx(D[:48], directory=d)
    mi.append(D[48:])
    FaultPlan(seed=2).corrupt_file(os.path.join(d, "state", "step_0000000002", "C.npy"))
    with telemetry.CommLog() as log, pytest.warns(UserWarning, match="falling back"):
        re = _idx(corpus=None, directory=d)
    assert log.counters["mutable.restore_fallback"] == 1
    assert log.counters["mutable.replayed_ops"] == 1
    _graph_equal(re.graph(), mi.graph())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directory_reopens_in_the_other_package(tmp_path, writer):
    """A directory either package wrote, the other reopens: its snapshot
    as written, and a log tail (an op killed after its WAL write) replayed
    with the reader's own arithmetic. The reopened index agrees with the
    writer's package run without the kill: counts exact, graphs to f32
    rounding."""
    rng = np.random.default_rng(26)
    D = _rows(rng, 64)
    d = str(tmp_path / "idx")

    def make(pkg, corpus=None, **kw):
        if pkg == "port":
            return _idx(corpus, **kw)
        return RefIndex(corpus, threshold=T, k=K, **kw)

    plan = (FaultPlan([Fault("kill", scope="mutable.append", step=3)]) if writer == "port"
            else RFaultPlan([RFault("kill", scope="mutable.append", step=3)]))
    w = make(writer, D[:40], directory=d, fault_plan=plan)
    w.delete([4, 17])
    with pytest.raises(Exception, match="injected kill"):
        w.append(D[40:])
    reader_pkg = "port" if writer == "reference" else "reference"
    reader = make(reader_pkg, directory=d)
    twin = make(writer, D[:40])  # the writer's package, never killed
    twin.delete([4, 17])
    twin.append(D[40:])
    assert reader.version == twin.version == 3
    port, ref = (reader, twin) if reader_pkg == "port" else (twin, reader)
    model = [(g, D[g]) for g in range(64) if g not in (4, 17)]
    _assert_same_as_reference(port, ref, model, _unit64(_rows(rng, 4)).astype(np.float32))


# -- server ------------------------------------------------------------------------


def test_server_cache_invalidates_on_mutation():
    """The LRU is keyed by (query digest, index version): a post-append
    query never returns a pre-append answer."""
    rng = np.random.default_rng(17)
    D = _rows(rng, 80)
    mi = _idx(D[:64])
    srv = RetrievalServer(mi, threshold=T, k=K, max_batch=4)
    q = D[0] / np.linalg.norm(D[0])
    r1 = srv.serve([q])[0]
    assert srv.serve([q])[0].cached  # same version: cache hit
    mi.append(D[64:])
    r3 = srv.serve([q])[0]
    assert not r3.cached  # version bumped: invisible to fresh gets
    assert r3.count >= r1.count
    r4 = srv.serve([q])[0]  # re-cached at the new version
    assert r4.cached and np.array_equal(r4.values, r3.values)
    mi.delete([int(mi.graph()[0][-1])])
    assert not srv.serve([q])[0].cached  # deletes invalidate too
    want = mi.query((q / np.linalg.norm(q))[None])
    got = srv.serve([q])[0]
    assert np.array_equal(got.values, want.values[0])
    assert np.array_equal(got.indices, want.indices[0])


def test_server_stale_tier_may_serve_pre_mutation():
    """The only sanctioned path to a pre-mutation answer: every scoring
    tier down, the explicit stale tier, status 'stale'."""
    rng = np.random.default_rng(18)
    D = _rows(rng, 80)
    mi = _idx(D[:64])
    srv = RetrievalServer(mi, threshold=T, k=K, max_batch=4, max_retries=0)
    q = D[0] / np.linalg.norm(D[0])
    warm = srv.serve([q])[0]
    mi.append(D[64:])
    srv.fault_plan = FaultPlan([Fault("error", scope="serving.plain", times=9)])
    rs = srv.serve([q])[0]
    assert rs.status == "stale" and rs.cached
    assert np.array_equal(rs.values, warm.values)
    assert srv.stats.stale == 1


def test_kernel_error_on_a_live_index_is_not_degraded_past(monkeypatch):
    """A KernelError on the kernel tier of a live index propagates from the
    server: the ladder never falls to the plain tier past a kernel fault."""
    rng = np.random.default_rng(19)
    D = _rows(rng, 64)
    mi = _idx(D)

    def broken(*a, **kw):
        raise KernelError("apss_rect_tile_candidates_f32_f32 launch failed")

    monkeypatch.setattr(tquery, "rect_tile_candidates_kernel", broken)
    srv = RetrievalServer(mi, threshold=T, k=K, max_batch=4, use_kernel=True)
    with pytest.raises(KernelError):
        srv.serve([D[0]])
    assert srv.stats.degraded == srv.stats.retries == 0


# -- the demo ----------------------------------------------------------------------


def test_live_demo_exits_zero(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.live", "--device", "cpu", "--n", "256",
         "--m", "64", "--deltas", "16", "--rounds", "2",
         "--metrics-out", str(tmp_path / "m.prom")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "graph bit-identical to fresh rebuild" in out.stdout
    assert "repro_serving_appends_total" in (tmp_path / "m.prom").read_text()
