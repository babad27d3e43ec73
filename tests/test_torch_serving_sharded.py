"""The port's sharded serving (an index split into row-block shards, K4 or
gather-dot per shard at global ids), ``checkerboard_live_mask`` and
``distributed/straggler.py``, against the JAX package on the CPU.

The port's shards lie on ``devices=["cpu"] * p``; the reference's index is
sharded over a ``(p,)`` mesh of the test session's virtual CPU devices.
Tolerances, as in ``_torch_parity``: no float64 score within 1e-5 of t;
counts and match sets exactly equal, values within 1e-6. On exact value
ties the JAX fold orders by worklist position and the port by id, so the
port is held to JAX by set, counts and sorted values, and for order to the
oracle ``extract_matches(Q·Cᵀ, t, k, exclude_self=False)``. A dense
sharded index scores each tile by the same product as the unsharded one,
so their results are held equal bit for bit. The checkerboard mask and the
index's shard layout must be equal; ``StepTimer`` must evict the same
ranks with the same EMAs.
"""

import contextlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_dist import jax_mesh  # noqa: E402
from _torch_parity import VAL_TOL, assert_clear_of_threshold, assert_same_matches, host  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.core.apss import normalize_rows as jnormalize  # noqa: E402
from repro.data.sparse import sparse_clustered_corpus  # noqa: E402
from repro.distributed import straggler as jstraggler  # noqa: E402
from repro.serving import index as jindex  # noqa: E402
from repro.serving import query as jquery  # noqa: E402
from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.core.matches import extract_matches  # noqa: E402
from repro_torch.core.precision import dot_f32  # noqa: E402
from repro_torch.distributed import StepTimer, StragglerReport  # noqa: E402
from repro_torch.distributed.straggler import StepTicker  # noqa: E402
from repro_torch.interop import sparse_corpus_from_numpy, sparse_corpus_to_numpy  # noqa: E402
from repro_torch.kernels.apss_block import fused  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousRetrievalServer,
    RetrievalServer,
    build_index,
    index_nbytes,
    query_topk,
)
from repro_torch.serving import query as tquery  # noqa: E402

T, K = 0.3, 8


def _corpus_queries(n, m, density, nq, seed):
    rng = np.random.default_rng(seed)
    C = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    C *= rng.random((n, m)) < density
    Q = np.abs(rng.standard_normal((nq, m))).astype(np.float32)
    Q *= rng.random((nq, m)) < density
    return np.asarray(jnormalize(jnp.asarray(C))), np.asarray(jnormalize(jnp.asarray(Q)))


@pytest.fixture(scope="module")
def case():
    """The reference test's corpus: 220 rows (no multiple of p · 16), 9
    queries, clear of t."""
    C, Q = _corpus_queries(220, 96, 0.12, 9, seed=11)
    assert_clear_of_threshold(Q, C, T)
    return C, Q


def _oracle(Q, C, t=T, k=K):
    return extract_matches(dot_f32(torch.from_numpy(Q), torch.from_numpy(C)), t, k,
                           exclude_self=False)


def _index(C, kind, block_rows, p=None):
    corpus = C if kind == "dense" else tsparse.from_dense(C, device="cpu")
    devices = None if p is None else ["cpu"] * p
    return build_index(corpus, block_rows=block_rows, normalize=False, device="cpu",
                       devices=devices)


def _jindex(C, kind, block_rows, p):
    corpus = C if kind == "dense" else jsparse.from_dense(jnp.asarray(C))
    return jindex.build_index(corpus, block_rows=block_rows, normalize=False,
                              mesh=jax_mesh((p,), ("data",)))


def _query(*args, **kw):
    """``query_topk`` and the tiles it added to ``query.TILES``."""
    tquery.TILES.update(total=0, live=0, scored=0)
    return query_topk(*args, **kw), dict(tquery.TILES)


def _assert_identical(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# -- the index ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("p", [8, 3, 1])
def test_sharded_index_layout_matches_jax(case, kind, p):
    """Shard count, blocks per shard, block ranges, padding, block stats and
    bytes equal the reference's; each shard sits on its device and the
    last shard carries the padding rows."""
    C, _ = case
    got, ref = _index(C, kind, 16, p), _jindex(C, kind, 16, p)
    assert (got.n_shards, got.nb_local, got.n_padded, got.n_blocks, got.n) == (
        ref.n_shards, ref.nb_local, ref.n_padded, ref.n_blocks, ref.n)
    assert got.n_padded % (p * 16) == 0
    assert [got.shard_block_range(s) for s in range(p)] == [
        ref.shard_block_range(s) for s in range(p)]
    for g, r in zip(got.stats, ref.stats):
        np.testing.assert_allclose(host(g), np.asarray(r), rtol=0, atol=VAL_TOL)
    if p > 1 or kind == "dense":  # one sparse shard is the unsharded index, with bx
        assert index_nbytes(got) == jindex.index_nbytes(ref)
    rows = got.nb_local * 16
    for s in range(p):
        assert got.shard_device(s).type == "cpu"
        shard = got.shards[s] if kind == "sparse" else (got.shards[s],)
        whole = ref.corpus if kind == "sparse" else (ref.corpus,)
        for g, r in zip(shard, whole):
            np.testing.assert_array_equal(host(g), np.asarray(r)[s * rows:(s + 1) * rows])
    if p > 1:
        assert got.bdims is None and got.bx is None and "shards=" in repr(got)
        with pytest.raises(ValueError, match="sharded"):
            got.corpus  # noqa: B018


def test_sharded_dense_index_normalizes_shard_by_shard_as_jax():
    C, _ = _corpus_queries(100, 70, 0.2, 1, seed=15)
    got = build_index(C * 3.0, block_rows=16, device="cpu", devices=["cpu"] * 3)
    ref = jindex.build_index(C * 3.0, block_rows=16, mesh=jax_mesh((3,), ("data",)))
    np.testing.assert_allclose(torch.cat(got.shards).numpy(), np.asarray(ref.corpus),
                               atol=VAL_TOL)


def test_build_index_placement_is_checked(case):
    C, _ = case
    with pytest.raises(ValueError, match="home device"):
        build_index(C, device="meta", devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="at least one"):
        build_index(C, devices=[])
    one = build_index(C, block_rows=16, devices=["cpu"])
    assert one.n_shards == 1 and one.device.type == "cpu"


# -- the query path -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("p", [8, 3, 1])
def test_sharded_partial_merge_matches_jax_and_unsharded(case, kind, p):
    """Per-shard partials merged on the home device equal the reference's
    sharded query, the port's unsharded query and the oracle: global ids,
    the last shard's padding rows never matching, the padding block
    pruned."""
    C, Q = case
    index = _index(C, kind, 16, p)
    got, tiles = _query(index, Q, T, K)
    ref = jquery.query_topk(_jindex(C, kind, 16, p), jnp.asarray(Q), T, K)
    flat, flat_tiles = _query(_index(C, kind, 16), Q, T, K)
    assert got.values.shape == (9, K) and got.values.device.type == "cpu"
    assert_same_matches(got, _oracle(Q, C))
    assert_same_matches(got, ref, order=False)
    if kind == "dense":
        _assert_identical(got, flat)
    else:
        assert_same_matches(got, flat)
    assert tiles["live"] == tiles["scored"] == flat_tiles["live"]
    assert tiles["total"] == index.n_blocks


def test_sharded_kernel_path_matches_jax_pallas_interpret():
    """``use_kernel`` on a dense sharded index: the reference's K4 in Pallas
    interpret mode through its 3-row worklists, the port's K4 wrapper (its
    plain version on the CPU), each against the oracle and the plain path."""
    C, Q = _corpus_queries(256, 96, 0.12, 8, seed=13)
    assert_clear_of_threshold(Q, C, T)
    jidx = jindex.build_index(C, block_rows=32, normalize=False,
                              mesh=jax_mesh((8,), ("data",)))
    ref = jquery.query_topk(jidx, jnp.asarray(Q), T, K, use_kernel=True)
    index = _index(C, "dense", 32, 8)
    before = fused.LAUNCHES["rect_tile_candidates"]
    got = query_topk(index, Q, T, K, use_kernel=True)
    assert fused.LAUNCHES["rect_tile_candidates"] == before  # no card: plain version
    assert_same_matches(got, _oracle(Q, C))
    assert_same_matches(got, ref, order=False)
    _assert_identical(got, query_topk(index, Q, T, K))


@pytest.mark.parametrize("kind,kw", [
    ("dense", dict(early_exit=True)),
    ("sparse", dict(early_exit=True)),
    ("sparse", dict(use_kernel=True)),
], ids=["dense_early_exit", "sparse_early_exit", "sparse_kernel"])
def test_sharded_refusals_match_jax(case, kind, kw):
    C, Q = case
    with pytest.raises(NotImplementedError) as want:
        jquery.query_topk(_jindex(C, kind, 16, 4), jnp.asarray(Q), T, K, **kw)
    with pytest.raises(NotImplementedError) as got:
        query_topk(_index(C, kind, 16, 4), Q, T, K, **kw)
    assert str(got.value) == str(want.value)


def test_sharded_query_empty_results(case):
    """All-zero queries prune every tile (empty worklists on every shard);
    t = 1.5 scores live tiles and matches nothing."""
    C, Q = case
    index = _index(C, "dense", 16, 4)
    got, tiles = _query(index, np.zeros_like(Q), T, K)
    assert tiles["live"] == 0 and tiles["total"] == index.n_blocks
    high, high_tiles = _query(index, Q, 1.5, K)
    assert high_tiles["live"] > 0
    for m in (got, high):
        assert m.values.shape == (9, K) and int(m.counts.sum()) == 0
        assert bool((m.indices == -1).all()) and bool(torch.isinf(m.values).all())


# -- servers ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("server", ["step", "continuous"])
def test_servers_on_sharded_index_equal_one_shot_and_jax(case, kind, server):
    C, Q = case
    index = _index(C, kind, 16, 4)
    kw = dict(threshold=T, k=K, max_batch=4, normalize=False, block_q=8, cache_size=0,
              use_kernel=kind == "dense")
    srv = (ContinuousRetrievalServer(index, workers=2, **kw) if server == "continuous"
           else RetrievalServer(index, **kw))
    with contextlib.closing(srv):
        results = srv.serve([Q[i] for i in range(9)])
    assert all(r.status == "ok" for r in results)
    assert srv.stats.retries == srv.stats.degraded == 0
    one = query_topk(index, Q, T, K, block_q=8)
    ref = jquery.query_topk(_jindex(C, kind, 16, 4), jnp.asarray(Q), T, K, block_q=8)
    jv, ji, jc = (np.asarray(x) for x in ref)
    for i, res in enumerate(results):
        assert res.count == int(one.counts[i]) == int(jc[i])
        np.testing.assert_array_equal(res.indices, one.indices[i].numpy())
        np.testing.assert_array_equal(res.values, one.values[i].numpy())
        assert set(res.indices[res.indices >= 0]) == set(ji[i][ji[i] >= 0])
        np.testing.assert_allclose(np.sort(res.values), np.sort(jv[i]), atol=VAL_TOL)


@pytest.mark.parametrize("server", ["step", "continuous"])
def test_kernel_server_on_sparse_shards_raises_at_first_batch(case, server):
    """The kernel tier cannot run on sparse shards: the server raises at its
    first batch instead of retrying and degrading to the plain tier."""
    C, Q = case
    index = _index(C, "sparse", 16, 4)
    kw = dict(threshold=T, k=K, cache_size=0, use_kernel=True, max_retries=2,
              backoff_s=0.001)
    srv = (ContinuousRetrievalServer(index, workers=2, **kw) if server == "continuous"
           else RetrievalServer(index, **kw))
    with contextlib.closing(srv), pytest.raises(NotImplementedError, match="dense shards"):
        srv.result(srv.submit(Q[0]))
    assert srv.stats.retries == srv.stats.degraded == 0


# -- checkerboard_live_mask ---------------------------------------------------


def test_checkerboard_live_mask_equals_jax_and_is_sound():
    """The OR of the per-cell masks at t/r equals the reference's exactly,
    keeps every tile holding a match of the dense S and prunes some."""
    jsp = sparse_clustered_corpus(128, 2048, 8.0, n_clusters=8, seed=7)
    sp = sparse_corpus_from_numpy(*sparse_corpus_to_numpy(jsp), device="cpu")
    t, bs, r = 0.4, 16, 4
    ref = np.asarray(jpruning.checkerboard_live_mask(jsparse.dim_slices(jsp, r), t, bs))
    cells = tsparse.dim_slices(sp, r)
    assert len(cells) == r and all(c.m == 2048 // r for c in cells)
    live = tpruning.checkerboard_live_mask(cells, t, bs)
    assert live.dtype == torch.bool
    np.testing.assert_array_equal(live.numpy(), ref)
    D = tsparse.to_dense(sp).double().numpy()
    S = D @ D.T
    np.fill_diagonal(S, 0.0)
    nb = 128 // bs
    has_match = S.reshape(nb, bs, nb, bs).max(axis=(1, 3)) >= t
    assert not (has_match & ~live.numpy()).any()
    assert (~live.numpy()).any()


# -- distributed/straggler.py -------------------------------------------------


@pytest.mark.parametrize("slow,per_rank,want", [
    (0.25, 5, [5]),  # tests/test_substrates.py's ledger
    (1.0, 4, [5]),   # tests/test_robust.py's ledger (rank 5 at 10x)
    (0.1, 4, []),    # no straggler
])
def test_step_timer_evicts_as_jax(slow, per_rank, want):
    got, ref = StepTimer(tolerance=1.5), jstraggler.StepTimer(tolerance=1.5)
    for rank in range(8):
        for _ in range(per_rank):
            step = slow if rank == 5 else 0.1
            got.record(rank, step)
            ref.record(rank, step)
    g, r = got.report(), ref.report()
    assert isinstance(g, StragglerReport)
    assert g.evict == r.evict == want
    assert g.rank_ema == r.rank_ema and g.median_ema == r.median_ema
    assert str(g) == str(r)


def test_step_timer_start_stop_and_empty_report():
    timer = StepTimer()
    assert timer.report().evict == [] and timer.report().median_ema == 0.0
    with pytest.raises(RuntimeError, match="start"):
        timer.stop()
    timer.start()
    dt = timer.stop(rank=3)
    assert dt >= 0 and list(timer.history[3]) == [dt] and timer.rank_ema[3] == dt


def test_step_ticker_on_cpu_stamps_each_tick_at_once():
    ticker = StepTicker("cpu")
    for step in range(3):
        for rank in range(4):
            before = time.perf_counter()
            ticker.emit(step, rank, torch.tensor(step))
            assert before <= ticker.ticks[-1][2] <= time.perf_counter()
        time.sleep(0.002)
    log = ticker.tick_log()
    assert sorted((r, s) for r, s, _ in log) == [(r, s) for r in range(4) for s in range(3)]
    assert ticker.n_steps == 3
    times = ticker.step_times()
    assert len(times) == 3 and all(dt > 0 for dt in times)
    assert sum(times) == pytest.approx(max(t for _, _, t in log) - ticker.created)
    timer = ticker.to_step_timer(tolerance=1.5)
    assert sorted(timer.rank_ema) == [0, 1, 2, 3]
    assert all(len(timer.history[r]) == 2 for r in range(4))
