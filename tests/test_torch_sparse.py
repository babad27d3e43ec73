"""Parity of the port's sparse self-join (``repro_torch.core.sparse``, the
sparse half of ``core.pruning``, ``data.sparse`` and
``kernels.apss_block.sparse``) with the JAX package, on the CPU.

The same numpy inputs go through both packages. Tolerances, as in
``_torch_parity``: no float64 score within 1e-5 of t; counts and match sets
exactly equal, values within 1e-6, order equal under (value desc, id asc)
except where the JAX packet fold orders exact ties by worklist position
(compared by set there). Integer layouts (indices, nnz, supports, masks)
must be equal. f32 arrays that both packages compute with the same
operations in another order are held to ``RTOL`` = 1e-6 (a few f32 ulps:
row norms) and, where a prefix sum feeds them (duplicate run sums and the
bounds built on them), to ``ATOL`` = 1e-6 as well, since the difference of
two prefix sums of unit-scale values carries their absolute rounding.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (  # noqa: E402
    VAL_TOL,
    assert_clear_of_threshold,
    assert_same_matches,
    host,
)
from repro.core import apss as japss  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.data import sparse as jdata  # noqa: E402
from repro.kernels.apss_block import sparse as jks  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import apss as tapss  # noqa: E402
from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.data import sparse as tdata  # noqa: E402
from repro_torch.kernels.apss_block import fused  # noqa: E402
from repro_torch.kernels.apss_block import sparse as tks  # noqa: E402

T, K = 0.3, 16
RTOL = 1e-6
ATOL = 1e-6


def _dense(n, m, dens, seed, empty_rows=()):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < dens
    for r in empty_rows:
        D[r] = 0
    return D / np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)


def _random_csr(seed, n, m, cap):
    """Raw CSR with duplicate coordinates (which sum) and empty rows."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, cap + 1, size=n).astype(np.int32)
    nnz[rng.random(n) < 0.2] = 0
    idx = rng.integers(0, m, size=(n, cap)).astype(np.int32)
    idx[:, 1] = idx[:, 0]  # duplicates in every row with two or more entries
    val = (rng.random((n, cap)) * 0.8).astype(np.float32)
    live = np.arange(cap)[None, :] < nnz[:, None]
    return np.where(live, idx, 0), np.where(live, val, 0.0).astype(np.float32), nnz, m


def _both(idx, val, nnz, m):
    """One CSR corpus in each package."""
    j = jsparse.SparseCorpus(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(nnz), m)
    return j, interop.sparse_corpus_from_numpy(idx, val, nnz, m, "cpu")


def _assert_same_corpus(got, ref, *, values_exact=True):
    gi, gv, gn, gm = interop.sparse_corpus_to_numpy(got)
    ri, rv, rn, rm = interop.sparse_corpus_to_numpy(ref)
    assert gm == rm and gi.shape == ri.shape
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gn, rn)
    if values_exact:
        np.testing.assert_array_equal(gv, rv)
    else:
        np.testing.assert_allclose(gv, rv, rtol=RTOL, atol=0)


# -- representation -----------------------------------------------------------


def test_from_dense_to_dense_roundtrip_with_empty_rows():
    D = _dense(40, 70, 0.1, seed=1, empty_rows=(0, 17, 39))
    ref = jsparse.from_dense(D)
    got = tsparse.from_dense(D, device="cpu")
    _assert_same_corpus(got, ref)
    assert got.indices.dtype == torch.int32 and got.nnz.dtype == torch.int32
    assert got.shape == ref.shape and got.cap == ref.cap
    np.testing.assert_array_equal(host(tsparse.to_dense(got)), D)
    wide = tsparse.from_dense(D, cap=ref.cap + 3, device="cpu")
    _assert_same_corpus(wide, jsparse.from_dense(D, cap=ref.cap + 3))
    with pytest.raises(ValueError, match="truncate"):
        tsparse.from_dense(D, cap=ref.cap - 1, device="cpu")
    assert tsparse.density(got) == jsparse.density(ref)


def test_duplicates_sum_in_to_dense_and_dedupe_rows():
    j, t = _both(*_random_csr(3, 30, 12, 6))
    np.testing.assert_allclose(
        host(tsparse.to_dense(t)), np.asarray(jsparse.to_dense(j)), rtol=RTOL, atol=0
    )
    ji, jv = jsparse.dedupe_rows(j.indices, j.values)
    ti, tv = tsparse.dedupe_rows(t.indices, t.values)
    np.testing.assert_array_equal(host(ti), np.asarray(ji))
    np.testing.assert_allclose(host(tv), np.asarray(jv), rtol=RTOL, atol=ATOL)
    # Every distinct coordinate keeps its sum: densifying either gives D.
    D = host(tsparse.to_dense(t))
    deduped = tsparse.SparseCorpus(ti, tv, t.nnz, t.m)
    np.testing.assert_allclose(host(tsparse.to_dense(deduped)), D, atol=1e-7)


def test_normalize_pad_densify_and_gather_dot_parity():
    j, t = _both(*_random_csr(4, 37, 50, 7))
    _assert_same_corpus(
        tsparse.normalize_sparse(t), jsparse.normalize_sparse(j), values_exact=False
    )
    tp, n = tsparse.pad_rows_sparse(t, 16)
    jp, n2 = jsparse.pad_rows_sparse(j, 16)
    assert n == n2 == 37 and tp.n == 48
    _assert_same_corpus(tp, jp)
    qd_t = tsparse.densify_rows(tp, 16, 16)
    qd_j = jsparse.densify_rows(jp, 16, 16)
    np.testing.assert_allclose(host(qd_t), np.asarray(qd_j), rtol=RTOL, atol=1e-7)
    s_t = tsparse.gather_dot(qd_t, tp.indices[:32], tp.values[:32], chunk=4)
    s_j = jsparse.gather_dot(qd_j, jp.indices[:32], jp.values[:32], chunk=4)
    np.testing.assert_allclose(host(s_t), np.asarray(s_j), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("sparse_zipfian_corpus", dict(n=120, m=900, avg_nnz=14.0, seed=3)),
        ("sparse_zipfian_corpus", dict(n=60, m=64, avg_nnz=5.0, zipf_alpha=0.8, seed=9)),
        ("sparse_clustered_corpus", dict(n=128, m=512, avg_nnz=8.0, n_clusters=4, seed=1)),
        ("sparse_clustered_corpus",
         dict(n=96, m=520, avg_nnz=6.0, n_clusters=8, seed=2, overlap_dims=8)),
    ],
)
def test_sparse_generators_same_draws(name, kwargs):
    ref = getattr(jdata, name)(**kwargs)
    got = getattr(tdata, name)(**kwargs, device="cpu")
    _assert_same_corpus(got, ref, values_exact=False)
    np.testing.assert_allclose(  # unit rows
        np.linalg.norm(host(tsparse.to_dense(got)), axis=1), 1.0, rtol=1e-6
    )


def test_sparse_corpus_interop_roundtrip():
    j = jdata.sparse_zipfian_corpus(50, 300, 9.0, seed=5)
    t = interop.sparse_corpus_from_numpy(*interop.sparse_corpus_to_numpy(j), "cpu")
    _assert_same_corpus(t, j)
    assert repr(t) == repr(j)
    moved = t.to("cpu")
    assert moved.values.dtype == torch.float32 and moved.m == 300


# -- pruning --------------------------------------------------------------------


@pytest.mark.parametrize("use_minsize", [True, False])
def test_sparse_block_stats_and_prune_mask_parity(use_minsize):
    j = jdata.sparse_clustered_corpus(128, 512, 8.0, n_clusters=4, seed=6)
    t = interop.sparse_corpus_from_numpy(*interop.sparse_corpus_to_numpy(j), "cpu")
    js, ts = jpruning.sparse_block_stats(j, 32), tpruning.sparse_block_stats(t, 32)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(host(b), np.asarray(a), rtol=RTOL, atol=ATOL)
    assert ts.max_nnz.dtype == torch.int32
    kw = dict(use_minsize=use_minsize, return_ub=True)
    jm, jub = jpruning.sparse_block_prune_mask(j, j, 0.4, 32, **kw)
    tm, tub = tpruning.sparse_block_prune_mask(t, t, 0.4, 32, **kw)
    np.testing.assert_array_equal(host(tm), np.asarray(jm))
    np.testing.assert_allclose(host(tub), np.asarray(jub), rtol=RTOL, atol=ATOL)
    assert 0 < int(np.asarray(jm).sum()) < jm.size
    jsup, tsup = jpruning.sparse_block_support(j, 32), tpruning.sparse_block_support(t, 32)
    np.testing.assert_array_equal(host(tsup), np.asarray(jsup))
    np.testing.assert_array_equal(
        host(tpruning.sparse_candidate_mask(tsup, tsup)),
        np.asarray(jpruning.sparse_candidate_mask(jsup, jsup)),
    )
    # A rectangular pair (two corpora, two block sizes) takes its own stats.
    np.testing.assert_array_equal(
        host(tpruning.sparse_block_prune_mask(t, tsparse.pad_rows_sparse(t, 64)[0],
                                              0.4, 32, 64)),
        np.asarray(jpruning.sparse_block_prune_mask(j, jsparse.pad_rows_sparse(j, 64)[0],
                                                    0.4, 32, 64)),
    )


def test_duplicate_concentration_is_not_pruned():
    """Row 0 stores dim 3 as two 0.5 slots (effective weight 1.0); a per-slot
    max of 0.5 would prune the cross-block tile at t=0.8 and drop the match."""
    idx = np.zeros((32, 2), np.int32)
    val = np.zeros((32, 2), np.float32)
    idx[0] = [3, 3]
    val[0] = [0.5, 0.5]
    idx[16] = [3, 0]
    val[16] = [1.0, 0.0]
    nnz = np.array([2] + [0] * 15 + [1] + [0] * 15, np.int32)
    j, t = _both(idx, val, nnz, 8)
    mask = host(tpruning.sparse_block_prune_mask(t, t, 0.8, 16))
    np.testing.assert_array_equal(
        mask, np.asarray(jpruning.sparse_block_prune_mask(j, j, 0.8, 16))
    )
    assert mask[0, 1] and mask[1, 0]
    ref = japss.apss_reference(jsparse.to_dense(j), 0.8, 4)
    assert int(np.asarray(ref.counts).sum()) == 2
    for got in (
        tks.apss_sparse_compacted(t, 0.8, 4, block_m=16, lane_pad=8, device="cpu"),
        tapss.apss_blocked(t, 0.8, 4, block_rows=16, use_kernel=False, device="cpu"),
    ):
        assert_same_matches(got, ref)


# -- the host support compaction and the tile gather ---------------------------


def test_block_support_gather_byte_identical_and_gather_block():
    j, t = _both(*_random_csr(7, 64, 40, 6))
    jb, jx = jks.block_support_gather(j, 16, pad_to=8)
    tb, tx = tks.block_support_gather(t, 16, pad_to=8)
    assert tb.dtype == jb.dtype and tx.dtype == jx.dtype
    assert tb.tobytes() == jb.tobytes() and tx.tobytes() == jx.tobytes()
    idxb = t.indices.reshape(4, 16, -1)
    valb = t.values.reshape(4, 16, -1)
    for bi, bj in ((0, 0), (0, 3), (2, 1)):  # misses, duplicates, padding slots
        want = jks._gather_block(
            jnp.asarray(jb[bi]), j.indices.reshape(4, 16, -1)[bj],
            j.values.reshape(4, 16, -1)[bj],
        )
        got = tks._gather_block(torch.from_numpy(tb[bi]), idxb[bj], valb[bj])
        np.testing.assert_allclose(host(got), np.asarray(want), rtol=RTOL, atol=1e-7)
    ij = torch.tensor([[0, 0, 2], [0, 3, 1]])
    yg = tks.gather_tiles(torch.from_numpy(tb), idxb, valb, ij, chunk=2)
    for a, (bi, bj) in enumerate(ij.T.tolist()):
        np.testing.assert_array_equal(
            host(yg[a]),
            host(tks._gather_block(torch.from_numpy(tb[bi]), idxb[bj], valb[bj])),
        )


# -- joins -----------------------------------------------------------------------


def test_sparse_similarity_topk_with_offsets():
    Q = _dense(24, 64, 0.2, seed=10)
    C = _dense(40, 64, 0.2, seed=11)
    assert_clear_of_threshold(Q, C, T)
    kw = dict(block_rows=16, row_offset=7, col_offset=100, exclude_self=True)
    ref = jsparse.sparse_similarity_topk(
        jsparse.from_dense(Q), jsparse.from_dense(C), T, K, **kw
    )
    got = tapss.similarity_topk(
        tsparse.from_dense(Q, device="cpu"), tsparse.from_dense(C, device="cpu"),
        T, K, device="cpu", **kw,
    )
    assert_same_matches(got, ref)
    assert int(np.asarray(ref.counts).sum()) > 0


def test_sparse_similarity_topk_rejects_what_the_reference_rejects():
    sp = tsparse.from_dense(_dense(16, 32, 0.3, seed=13), device="cpu")
    D = _dense(16, 32, 0.3, seed=13)
    for call, what in (
        (lambda: tapss.similarity_topk(sp, D, T, K, device="cpu"), "same representation"),
        (lambda: tapss.similarity_topk(sp, sp, T, K, use_kernel=True, device="cpu"),
         "self-join only"),
        (lambda: tapss.similarity_topk(sp, sp, T, K, col_valid=torch.ones(16, dtype=bool),
                                       device="cpu"), "col validity"),
        (lambda: tsparse.sparse_similarity_topk(
            sp, tsparse.SparseCorpus(sp.indices, sp.values, sp.nnz, 33), T, K),
         "dimension mismatch"),
    ):
        with pytest.raises(ValueError, match=what):
            call()
    with pytest.raises(TypeError, match="dense corpus"):
        tapss.apss_reference(sp, T, K, device="cpu")


@functools.lru_cache(maxsize=None)
def _zipf_reference(dens):
    """The JAX corpus and its ``apss_reference`` at one density (built once)."""
    kw = dict(n=96, m=2048, avg_nnz=max(2, dens * 2048), seed=7)
    j = jdata.sparse_zipfian_corpus(**kw)
    D = np.asarray(jsparse.to_dense(j))
    assert_clear_of_threshold(D, D, T, exclude_self=True)
    return kw, japss.apss_reference(jnp.asarray(D), T, K)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dens", [0.001, 0.01, 0.1])
def test_apss_blocked_sparse_across_densities(dens, use_kernel):
    kw, ref = _zipf_reference(dens)
    t = tdata.sparse_zipfian_corpus(**kw, device="cpu")
    got = tapss.apss_blocked(t, T, K, block_rows=32, use_kernel=use_kernel, device="cpu")
    assert_same_matches(got, ref)


@pytest.mark.parametrize("n", [33, 100])  # non-tile-multiple shapes, empty rows
def test_apss_sparse_compacted_ragged(n):
    D = _dense(n, 80, 0.15, seed=n, empty_rows=(0, n - 1))
    assert_clear_of_threshold(D, D, T, exclude_self=True)
    ref = japss.apss_reference(jnp.asarray(D), T, K)
    sp = tsparse.from_dense(D, device="cpu")
    assert_same_matches(
        tks.apss_sparse_compacted(sp, T, K, block_m=16, lane_pad=8, device="cpu"), ref
    )
    assert_same_matches(
        tapss.apss_blocked(sp, T, K, block_rows=16, use_kernel=True, device="cpu"), ref
    )


def test_negative_threshold_keeps_zero_similarity_pairs():
    D = np.zeros((40, 16), np.float32)
    D[:20, 0] = 1.0  # rows 0..19 use dim 0 only,
    D[20:, 8] = 1.0  # rows 20..39 dim 8 only: zero similarity across blocks
    sp = tsparse.from_dense(D, device="cpu")
    t = -0.5
    assert host(tpruning.sparse_block_prune_mask(
        tsparse.pad_rows_sparse(sp, 16)[0], tsparse.pad_rows_sparse(sp, 16)[0], t, 16
    )).all()
    ref = japss.apss_reference(jnp.asarray(D), t, 64)
    assert (np.asarray(ref.counts) == 39).all()  # every real pair, no padding row
    for got in (
        tks.apss_sparse_compacted(sp, t, 64, block_m=16, lane_pad=8, device="cpu"),
        tapss.apss_blocked(sp, t, 64, block_rows=16, use_kernel=False, device="cpu"),
    ):
        assert_same_matches(got, ref)


def test_all_pruned_and_k_above_n():
    D = _dense(32, 64, 0.1, seed=9)
    sp = tsparse.from_dense(D, device="cpu")
    got = tks.apss_sparse_compacted(sp, 1.5, K, block_m=16, lane_pad=8, device="cpu")
    assert int(got.counts.sum()) == 0 and bool((got.indices == -1).all())
    assert_clear_of_threshold(D, D, 0.1, exclude_self=True)
    ref = japss.apss_reference(jnp.asarray(D), 0.1, 48)
    assert_same_matches(
        tapss.apss_blocked(sp, 0.1, 48, block_rows=16, use_kernel=True, device="cpu"), ref
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adversarial_csr_self_join(seed):
    j, t = _both(*_random_csr(seed, 20 + 7 * seed, 40, 6))
    D = np.asarray(jsparse.to_dense(j))
    assert_clear_of_threshold(D, D, 0.3, exclude_self=True)
    ref = japss.apss_reference(jsparse.to_dense(j), 0.3, 32)
    assert_same_matches(
        tks.apss_sparse_compacted(t, 0.3, 32, block_m=16, lane_pad=8, device="cpu"), ref
    )
    assert_same_matches(
        tsparse.sparse_similarity_topk(t, t, 0.3, 32, block_rows=16, exclude_self=True),
        ref,
    )


def test_apss_blocked_sparse_prune_stats():
    kw = dict(n=64, m=512, avg_nnz=8, n_clusters=8, seed=12)
    j = jdata.sparse_clustered_corpus(**kw)
    t = tdata.sparse_clustered_corpus(**kw, device="cpu")
    ref = japss.apss_reference(jsparse.to_dense(j), 0.4, K)
    # The kernel path accounts at its own tile (block_rows clamped to 128..256).
    for use_kernel, bs in ((True, 128), (False, 16)):
        got, stats = tapss.apss_blocked(t, 0.4, K, block_rows=16, use_kernel=use_kernel,
                                        with_prune_stats=True, device="cpu")
        jp = jsparse.pad_rows_sparse(j, bs)[0]
        jstats = jpruning.prune_stats(jpruning.sparse_block_prune_mask(jp, jp, 0.4, bs))
        for a, b in zip(jstats, stats):
            np.testing.assert_allclose(host(b), np.asarray(a))
        assert_same_matches(got, ref)
    assert 0 < int(stats.live_blocks) < int(stats.total_blocks)
    _, jstats = japss.apss_blocked(j, 0.4, K, block_rows=16, with_prune_stats=True)
    assert int(jstats.live_blocks) == int(stats.live_blocks)


# -- K3: the plain version against the JAX scan and the Pallas kernel ----------


def test_apss_sparse_compacted_matches_jax_scan():
    kw = dict(n=96, m=512, avg_nnz=8, n_clusters=8, seed=8)
    j = jdata.sparse_clustered_corpus(**kw)
    t = tdata.sparse_clustered_corpus(**kw, device="cpu")
    D = np.asarray(jsparse.to_dense(j))
    assert_clear_of_threshold(D, D, 0.4, exclude_self=True)
    ref = jks.apss_sparse_compacted(j, 0.4, K, block_m=16, lane_pad=8)
    got = tks.apss_sparse_compacted(t, 0.4, K, block_m=16, lane_pad=8, device="cpu")
    assert_same_matches(got, ref, order=False)  # the JAX fold orders ties by tile
    assert_same_matches(got, japss.apss_reference(jsparse.to_dense(j), 0.4, K))


@pytest.fixture(scope="module")
def k3_case():
    kw = dict(n=96, m=384, avg_nnz=10, n_clusters=2, seed=21)
    j = jdata.sparse_clustered_corpus(**kw)
    t = tdata.sparse_clustered_corpus(**kw, device="cpu")
    jp, tp = jsparse.pad_rows_sparse(j, 32)[0], tsparse.pad_rows_sparse(t, 32)[0]
    mask, ub = jpruning.sparse_block_prune_mask(jp, jp, 0.35, 32, return_ub=True)
    from repro.kernels.apss_block.ops import compact_worklist

    wl = compact_worklist(mask, ub)
    bdims, bx = jks.block_support_gather(jp, 32, pad_to=32)
    yg = np.stack([
        np.asarray(jks._gather_block(
            jnp.asarray(bdims[a]), jp.indices.reshape(3, 32, -1)[b],
            jp.values.reshape(3, 32, -1)[b],
        ))
        for a, b in wl.T
    ])
    ref = jks.sparse_tile_candidates_pallas(
        jnp.asarray(bx), jnp.asarray(yg), jnp.asarray(wl), 0.35, K,
        block_m=32, n_valid=96, interpret=True,
    )
    return j, t, tp, wl, bdims, bx, yg, ref


def test_plain_k3_matches_pallas_interpret(k3_case):
    j, t, tp, wl, bdims, bx, yg, ref = k3_case
    D = np.asarray(jsparse.to_dense(j))
    assert_clear_of_threshold(D, D, 0.35, exclude_self=True)
    assert (wl[0] == wl[1]).any() and (wl[0] != wl[1]).any()  # diagonal + mirrors
    tyg = tks.gather_tiles(
        torch.from_numpy(bdims), tp.indices.reshape(3, 32, -1),
        tp.values.reshape(3, 32, -1), torch.from_numpy(wl),
    )
    np.testing.assert_allclose(host(tyg), yg, rtol=RTOL, atol=1e-7)
    before = dict(fused.LAUNCHES)
    got = tks.sparse_tile_candidates_kernel(
        torch.from_numpy(bx), tyg, torch.from_numpy(wl), 0.35, K, n_valid=96
    )
    assert fused.LAUNCHES == before  # a plain version launches nothing
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = host(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, r, atol=VAL_TOL, rtol=0)
        else:
            np.testing.assert_array_equal(g, r)
    assert int(np.asarray(ref[2]).sum()) > 0


def test_apss_sparse_compacted_matches_jax_kernel_interpret(k3_case):
    j, t, *_ = k3_case
    ref = jks.apss_sparse_compacted(j, 0.35, K, block_m=32, lane_pad=32,
                                    use_kernel=True, interpret=True)
    got = tks.apss_sparse_compacted(t, 0.35, K, block_m=32, lane_pad=32, device="cpu")
    assert_same_matches(got, ref, order=False)
    assert_same_matches(got, japss.apss_reference(jsparse.to_dense(j), 0.35, K))


@pytest.mark.parametrize("T,block_m,per_tile", [(378, 256, 4), (5, 128, 1), (3, 64, 1), (2, 192, 4)])
def test_k3_work_items_cover_each_tile_once(T, block_m, per_tile):
    """K3's scoring launch: parts of up to 128 x 128 scores, numbered as the
    kernel numbers its blocks (t, then row part, then column part), that
    cover every score of every worklist tile exactly once."""
    items = tks.sparse_work_items(T, block_m)
    assert items.dtype == np.int32 and items.shape == (T * per_tile, 3)
    parts = -(-block_m // tks.K3_ITEM)
    n = np.arange(len(items))
    np.testing.assert_array_equal(items[:, 0], n // parts**2)
    np.testing.assert_array_equal(items[:, 1], (n % parts**2) // parts * tks.K3_ITEM)
    np.testing.assert_array_equal(items[:, 2], n % parts * tks.K3_ITEM)
    if T <= 5:
        cover = np.zeros((T, block_m, block_m), np.int32)
        for t, r0, c0 in items.tolist():
            cover[t, r0:r0 + tks.K3_ITEM, c0:c0 + tks.K3_ITEM] += 1
        assert (cover == 1).all()
    with pytest.raises(ValueError, match="no work items"):
        tks.sparse_work_items(0, block_m)
