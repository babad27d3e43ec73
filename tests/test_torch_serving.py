"""Parity of the port's query-time serving (``repro_torch.serving`` index and
query path, ``perturbed_queries``, the rect worklist and fold, and the plain
versions of K4, K5 and K6) with the JAX package, on the CPU.

The same numpy inputs go through both packages. Tolerances, as in
``_torch_parity``: no float64 score within 1e-5 of t; counts and match sets
exactly equal, values within 1e-6 (``VAL_TOL``). On exact value ties the JAX
fold orders by worklist position and the port by id, so the port is held to
JAX by set, counts and sorted values, and for order to the oracle
``extract_matches(Q·Cᵀ, t, k, exclude_self=False)``. Integer layouts
(worklists, supports, packet ids and counts) must be equal.

K5 stands against the JAX early-exit scan (``_rect_dense_ee_inner``) and the
non-early-exit path: the JAX K5 does not run under this jax version
(``pl.load`` is gone, ``fused.py:553``). The port's skip test is strict
(k-th > bound) where the reference skips at k-th ≥ bound; skipped-tile
counts are equal except where a bound ties a k-th value exactly, which the
tie probe builds on purpose.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (  # noqa: E402
    VAL_TOL,
    assert_clear_of_threshold,
    assert_same_matches,
    host,
    triple,
)
from repro.core import sparse as jsparse  # noqa: E402
from repro.core.apss import normalize_rows as jnormalize  # noqa: E402
from repro.data import sparse as jdata  # noqa: E402
from repro.kernels.apss_block import fused as jfused  # noqa: E402
from repro.kernels.apss_block import ops as jops  # noqa: E402
from repro.kernels.apss_block import sparse as jks  # noqa: E402
from repro.obs.metrics import MetricsRegistry  # noqa: E402
from repro.serving import index as jindex  # noqa: E402
from repro.serving import query as jquery  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.matches import extract_matches  # noqa: E402
from repro_torch.core.precision import dot_f32  # noqa: E402
from repro_torch.core.sparse import from_dense, to_dense  # noqa: E402
from repro_torch.data import sparse as tdata  # noqa: E402
from repro_torch.kernels.apss_block import fused, ops  # noqa: E402
from repro_torch.kernels.apss_block import sparse as tks  # noqa: E402
from repro_torch.serving import build_index, index_nbytes, query_topk  # noqa: E402
from repro_torch.serving import query as tquery  # noqa: E402

NEG_LARGE = fused.NEG_LARGE


def _query_tiles(*args, **kw):
    """``query_topk`` and the tiles it added to ``query.TILES``."""
    tquery.TILES.update(total=0, live=0, scored=0)
    return query_topk(*args, **kw), dict(tquery.TILES)


def _corpus_queries(n, m, density, nq, seed):
    rng = np.random.default_rng(seed)
    C = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    C *= rng.random((n, m)) < density
    Q = np.abs(rng.standard_normal((nq, m))).astype(np.float32)
    Q *= rng.random((nq, m)) < density
    return np.asarray(jnormalize(jnp.asarray(C))), np.asarray(jnormalize(jnp.asarray(Q)))


def _oracle(Q, C, t, k):
    return extract_matches(dot_f32(torch.from_numpy(Q), torch.from_numpy(C)), t, k,
                           exclude_self=False)


def _index(C, kind, block_rows, **kw):
    corpus = C if kind == "dense" else from_dense(C, device="cpu")
    return build_index(corpus, block_rows=block_rows, normalize=False, device="cpu", **kw)


def _jindex(C, kind, block_rows, **kw):
    corpus = C if kind == "dense" else jsparse.from_dense(jnp.asarray(C))
    return jindex.build_index(corpus, block_rows=block_rows, normalize=False, **kw)


def _assert_packets_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = host(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, r, atol=VAL_TOL, rtol=0)
        else:
            np.testing.assert_array_equal(g, r)


def _assert_ee_exact(ref, got, k):
    """Early exit: values and ids identical to the full scan, counts
    saturated at k."""
    np.testing.assert_array_equal(host(got.values), host(ref.values))
    np.testing.assert_array_equal(host(got.indices), host(ref.indices))
    np.testing.assert_array_equal(host(got.counts), np.minimum(host(ref.counts), k))


# -- traffic model, worklist, fold -------------------------------------------


@pytest.mark.parametrize("nq,start", [(24, None), (16, 5), (200, 0)])
def test_perturbed_queries_same_stream(nq, start):
    kw = dict(n=120, m=512, avg_nnz=9.0, n_clusters=4, seed=3)
    j = jdata.sparse_clustered_corpus(**kw)
    t = tdata.sparse_clustered_corpus(**kw, device="cpu")
    ref = jdata.perturbed_queries(j, nq, start=start, seed=7)
    got = tdata.perturbed_queries(t, nq, start=start, seed=7)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == ref.shape == (nq, 512)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=VAL_TOL)


@pytest.mark.parametrize("with_ub", [False, True])
def test_compact_rect_worklist_exact(with_ub):
    rng = np.random.default_rng(4)
    mask = rng.random((3, 7)) < 0.6
    ub = np.round(rng.random((3, 7)), 1).astype(np.float32)  # ties on purpose
    args = (mask, ub) if with_ub else (mask,)
    ref = jops.compact_rect_worklist(*args)
    got = ops.compact_rect_worklist(*(torch.from_numpy(a) for a in args))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert ops.compact_rect_worklist(np.zeros((2, 3), bool)) is None


@pytest.mark.parametrize("n_pad", [0, 3])
def test_fold_rect_packets_neutralises_padding(n_pad):
    rng = np.random.default_rng(5)
    grid_q, bq, k, T = 3, 4, 5, 7
    ij = np.stack([rng.integers(0, grid_q, T), np.arange(T)]).astype(np.int32)
    ids = rng.permutation(T * 50)[: T * bq * k].reshape(T, bq, k).astype(np.int32)
    vals = rng.random((T, bq, k)).astype(np.float32)
    empty = rng.random((T, bq, k)) < 0.3
    fv = np.where(empty, NEG_LARGE, -np.sort(-vals, axis=2)).astype(np.float32)
    fi = np.where(empty, -1, ids).astype(np.int32)
    fc = rng.integers(0, 9, (T, bq)).astype(np.int32)
    # padding entries alias tile (0, 0) and carry a real-looking packet
    ij = np.concatenate([ij, np.zeros((2, n_pad), np.int32)], axis=1)
    fv = np.concatenate([fv, np.repeat(fv[:1], n_pad, 0)])
    fi = np.concatenate([fi, np.repeat(fi[:1], n_pad, 0)])
    fc = np.concatenate([fc, np.repeat(fc[:1], n_pad, 0)])
    tvalid = np.arange(T + n_pad) < T
    kw = dict(grid_q=grid_q, block_q=bq, k=k)
    ref = jops.fold_rect_packets(jnp.asarray(ij), jnp.asarray(tvalid), jnp.asarray(fv),
                                 jnp.asarray(fi), jnp.asarray(fc), **kw)
    got = ops.fold_rect_packets(torch.from_numpy(ij), torch.from_numpy(tvalid),
                                torch.from_numpy(fv), torch.from_numpy(fi),
                                torch.from_numpy(fc), **kw)
    for g, r in zip(got, ref):  # distinct values: order is equal too
        np.testing.assert_array_equal(host(g), np.asarray(r))
    np.testing.assert_array_equal(
        host(got[2]), np.bincount(np.repeat(ij[0, :T], bq) * bq
                                  + np.tile(np.arange(bq), T), fc[:T].reshape(-1),
                                  minlength=grid_q * bq))


# -- plain versions of K4, K5, K6 against the reference kernels ---------------


@pytest.fixture(scope="module")
def rect_case():
    C, Q = _corpus_queries(300, 200, 0.1, 40, seed=11)
    Cp = np.pad(C, ((0, 84), (0, 56)))  # 384 rows, width 256
    Qp = np.pad(Q, ((0, 24), (0, 56)))  # 64 rows
    assert_clear_of_threshold(Q, C, 0.3)
    return C, Q, Cp, Qp


@pytest.mark.parametrize("block_q,block_c,rows", [(8, 64, 2), (16, 128, 3), (64, 128, 2)])
def test_plain_k4_matches_pallas_interpret(rect_case, block_q, block_c, rows):
    C, Q, Cp, Qp = rect_case
    gq, gc = 64 // block_q, 384 // block_c
    qi, cj = np.meshgrid(np.arange(gq), np.arange(gc), indexing="ij")
    ij = np.stack([qi.ravel(), cj.ravel()]).astype(np.int32)[:, ::2]
    if rows == 3:  # the last row carries the (here: shifted) global block id
        ij = np.concatenate([ij, ij[1:2] + 1])
    kw = dict(block_q=block_q, block_c=block_c, nc_valid=300 + (block_c if rows == 3 else 0))
    ref = jfused.rect_tile_candidates_pallas(
        jnp.asarray(Qp), jnp.asarray(Cp), jnp.asarray(ij), 0.3, 8, block_k=256,
        interpret=True, **kw,
    )
    before = dict(fused.LAUNCHES)
    got = fused.rect_tile_candidates_kernel(
        torch.from_numpy(Qp), torch.from_numpy(Cp), torch.from_numpy(ij), 0.3, 8, **kw
    )
    assert fused.LAUNCHES == before  # a plain version launches nothing
    _assert_packets_equal(got, ref)
    assert int(np.asarray(ref[2]).sum()) > 0


def test_plain_k6_and_query_gather_match_pallas_interpret():
    C, Q = _corpus_queries(250, 300, 0.05, 12, seed=12)
    assert_clear_of_threshold(Q, C, 0.2)
    jidx = _jindex(C, "sparse", 64)
    bq = 16
    Qp = np.pad(Q, ((0, 4), (0, 0)))
    ij = np.array([[0, 0, 0, 0], [3, 0, 2, 1]], np.int32)
    Qb = jnp.pad(jnp.asarray(Qp), ((0, 0), (0, 1))).reshape(1, bq, -1)
    qg = np.stack([np.asarray(jnp.take(Qb[a], jidx.bdims[b], axis=1)) for a, b in ij.T])
    got_qg = tks.gather_query_tiles(torch.from_numpy(Qp), torch.from_numpy(
        np.array(jidx.bdims)), torch.from_numpy(ij), bq)
    np.testing.assert_array_equal(host(got_qg), qg)
    kw = dict(block_q=bq, block_c=64, nc_valid=250)
    ref = jks.rect_sparse_tile_candidates_pallas(
        jnp.asarray(qg), jidx.bx, jnp.asarray(ij), 0.2, 8, interpret=True, **kw)
    got = tks.rect_sparse_tile_candidates_kernel(
        got_qg, torch.from_numpy(np.array(jidx.bx)), torch.from_numpy(ij), 0.2, 8,
        nc_valid=250)
    _assert_packets_equal(got, ref)
    assert int(np.asarray(ref[2]).sum()) > 0


def _k5_inputs(index, Q, t, block_q):
    """Padded queries, the ub-ordered worklist and its bounds, as
    ``query_topk`` builds them."""
    from repro_torch.serving.query import _query_mask, _queries

    Qt = _queries(index, Q)
    Qp = torch.nn.functional.pad(Qt, (0, 0, 0, (-Qt.shape[0]) % block_q))
    mask, ub = _query_mask(Qp, index.stats, threshold=t, block_q=block_q,
                           use_minsize=True, normalized=True)
    wl = ops.compact_rect_worklist(mask, ub)
    return Qp, wl, torch.from_numpy(ub.numpy()[wl[0], wl[1]])


def _overlap_case():
    sp = tdata.sparse_clustered_corpus(2048, 1024, 16.0, n_clusters=16, seed=2,
                                       overlap_dims=8, device="cpu")
    jsp = jdata.sparse_clustered_corpus(2048, 1024, 16.0, n_clusters=16, seed=2,
                                        overlap_dims=8)
    return sp, jsp, tdata.perturbed_queries(sp, 64, seed=3)


def test_plain_k5_equals_k4_fold_and_jax_early_exit_scan():
    sp, jsp, Q = _overlap_case()
    C = host(to_dense(sp))
    index = build_index(C, block_rows=64, normalize=False, device="cpu")
    t, k, bq = 0.01, 8, 64
    Qp, wl, ubw = _k5_inputs(index, Q, t, bq)
    T = wl.shape[1]
    ij = torch.from_numpy(wl)
    kw = dict(block_q=bq, block_c=64, nc_valid=2048)
    fv, fi, fc, sk = fused.rect_tile_candidates_early_exit_kernel(
        Qp, index.corpus, ij, ubw, t, k, nq_valid=64, **kw)
    pv, pi, pc = fused.rect_tile_candidates_kernel(Qp, index.corpus, ij, t, k, **kw)
    scored = ~sk[:, 0].bool()
    assert 0 < int(scored.sum()) < T
    for a, b in ((fv, pv), (fi, pi), (fc, pc)):  # scored tiles: K4's packets
        assert torch.equal(a[scored], b[scored])
    assert (fv[~scored] == NEG_LARGE).all() and (fi[~scored] == -1).all()
    assert (fc[~scored] == 0).all()
    fold = dict(grid_q=1, block_q=bq, k=k)
    ones = torch.ones(T, dtype=torch.bool)
    ee = ops.fold_rect_packets(ij, ones, fv, fi, fc[..., 0], **fold)
    full = ops.fold_rect_packets(ij, ones, pv, pi, pc[..., 0], **fold)
    assert torch.equal(ee[0], full[0]) and torch.equal(ee[1], full[1])
    assert torch.equal(ee[2].clamp_max(k), full[2].clamp_max(k))
    # the JAX early-exit scan on the same inputs skips the same tiles
    jout = jquery._rect_dense_ee_inner(
        jnp.asarray(host(Qp)), jnp.asarray(host(index.corpus)), jnp.asarray(wl),
        jnp.ones(T, bool), jnp.asarray(host(ubw)), jnp.int32(64), threshold=t, k=k,
        grid_q=1, **kw)
    assert int(jout[3]) == int(scored.sum())
    np.testing.assert_array_equal(np.asarray(jout[2]), host(ee[2].clamp_max(k)))
    np.testing.assert_array_equal(np.sort(np.asarray(jout[1]), 1), np.sort(host(ee[1]), 1))


def test_plain_k5_skips_padding_entries_and_padded_rows():
    C, Q = _corpus_queries(128, 64, 0.2, 3, seed=13)
    index = build_index(C, block_rows=64, normalize=False, device="cpu")
    Qp, wl, ubw = _k5_inputs(index, Q, 0.1, 8)
    T = wl.shape[1]
    ij = torch.from_numpy(np.concatenate([wl, np.zeros((2, 2), np.int32)], 1))
    ub = torch.cat([ubw, torch.full((2,), NEG_LARGE)])
    kw = dict(block_q=8, block_c=64, nc_valid=128)
    fv, fi, fc, sk = fused.rect_tile_candidates_early_exit_kernel(
        Qp, index.corpus, ij, ub, 0.1, 4, nq_valid=3, **kw)
    assert sk[T:].tolist() == [[1], [1]] and (fi[T:] == -1).all()
    # five padded rows of the block never fill, yet they do not pin it: with
    # no valid rows at all, every real tile is skipped too
    _, _, _, sk0 = fused.rect_tile_candidates_early_exit_kernel(
        Qp, index.corpus, ij, ub, 0.1, 4, nq_valid=0, **kw)
    assert bool(sk0.all())


@pytest.mark.parametrize(
    "m,block_q,block_c,capacity,strip_rows",
    [
        (136704, 64, 256, 264, 64),          # radikal's serving batch (134 chunks)
        (2048, 64, 64, 264, 16),             # the early-exit overlap cell (2 chunks)
        (int(2.5 * fused.EE_FK), 8, 256, 132, 16),  # a ragged last chunk, 8-row block
        (64, 128, 128, 396, 16),             # one short chunk
        (3 * fused.EE_FK, 40, 64, 2, 64),    # a strip taller than the block
        (3 * fused.EE_FK, 40, 64, 4, 32),    # shorter strips, to give every block an item
    ],
)
def test_k5_work_split_covers_every_chunk_and_strip_once(m, block_q, block_c, capacity,
                                                         strip_rows):
    """K5's work items: each (feature chunk, query strip, corpus strip) once,
    the chunks of the summation order K4 shares, every score of the tile in
    exactly one item per chunk, and a grid no larger than the card holds."""
    split = fused.ee_work_split(m, block_q, block_c, capacity)
    assert split.n_chunks == -(-m // fused.EE_FK)
    assert split.strip_rows == strip_rows
    items = split.items
    assert items.dtype == np.int32 and items.shape[1] == 3
    assert len({tuple(r) for r in items.tolist()}) == len(items)
    cover = np.zeros((split.n_chunks, block_q, block_c), np.int32)
    for f, r0, c0 in items.tolist():
        assert 0 <= f < split.n_chunks and r0 % strip_rows == 0 and c0 % 64 == 0
        cover[f, r0:r0 + strip_rows, c0:c0 + 64] += 1
    assert (cover == 1).all()
    work = max(len(items), -(-block_q * block_c // 256), -(-block_q // 8))
    assert split.grid == min(capacity, work)
    with pytest.raises(ValueError, match="no split"):
        fused.ee_work_split(m, block_q, 96, capacity)


@pytest.mark.parametrize(
    "T,m,block_q,block_c,budget,strip_rows,pass_tiles",
    [
        (27, 136704, 64, 256, fused.RECT_SCRATCH_BYTES, 64, 27),  # radikal, B = 64
        (27, 136704, 8, 256, fused.RECT_SCRATCH_BYTES, 8, 27),    # radikal, B = 8
        (3, 2048, 8, 64, fused.RECT_SCRATCH_BYTES, 32, 3),        # 32 threads span 64 rows
        (5, int(2.5 * fused.EE_FK), 24, 64, fused.RECT_SCRATCH_BYTES, 32, 5),  # ragged chunk
        (7, 64, 128, 128, fused.RECT_SCRATCH_BYTES, 128, 7),     # one short chunk
        (9, 3 * fused.EE_FK, 72, 128, 3 * 4 * 3 * 72 * 128, 128, 3),  # passes of 3 tiles
        (4, 3 * fused.EE_FK, 40, 256, 1, 64, 1),                 # a budget below one tile
    ],
)
def test_k4_work_split_covers_every_tile_chunk_and_strip_once(T, m, block_q, block_c, budget,
                                                              strip_rows, pass_tiles):
    """K4's work items: each (tile, feature chunk, corpus strip) once with
    the whole query block in its strip, a corpus strip of 8 rows a thread
    at most, the chunks of the summation order K5 shares, and scratch of
    the pass's partial tiles."""
    split = fused.rect_work_split(T, m, block_q, block_c, budget)
    assert split.n_chunks == -(-m // fused.EE_FK)
    assert split.strip_rows == strip_rows and split.strip_rows >= block_q
    threads_c = 8 * 256 // strip_rows  # each of 256 threads owns 8 strip rows
    assert split.strip_c == min(block_c, 8 * threads_c) and split.strip_c >= threads_c
    assert split.strips * split.strip_c == block_c
    assert split.pass_tiles == pass_tiles
    assert split.scratch_bytes == 4 * pass_tiles * split.n_chunks * block_q * block_c
    items = split.items()
    assert items.dtype == np.int32 and items.shape == (split.n_items, 4)
    assert split.n_items == T * split.n_chunks * split.strips
    cover = np.zeros((T, split.n_chunks, block_q, block_c), np.int32)
    for t, f, r0, c0 in items.tolist():
        assert r0 == 0 and c0 % split.strip_c == 0
        cover[t, f, r0:r0 + split.strip_rows, c0:c0 + split.strip_c] += 1
    assert (cover == 1).all()
    # The kernel numbers a pass's items ((t - t0) * n_chunks + f) * strips + strip.
    n = ((items[:, 0] % pass_tiles) * split.n_chunks + items[:, 1]) * split.strips \
        + items[:, 3] // split.strip_c
    per_pass = items[:, 0] // pass_tiles
    for p in np.unique(per_pass):
        assert (n[per_pass == p] == np.arange((per_pass == p).sum())).all()
    with pytest.raises(ValueError, match="no split"):
        fused.rect_work_split(T, m, block_q, 96)


def test_k4_work_split_scratch_on_radikal():
    """The scratch the K4 design states: 237 MB at B = 64 and 29.6 MB at
    B = 8 for radikal's 27 live tiles of 136,704 features."""
    assert fused.rect_work_split(27, 136704, 64, 256).scratch_bytes == 237_109_248
    assert fused.rect_work_split(27, 136704, 8, 256).scratch_bytes == 29_638_656


# -- index and query path against the JAX package -----------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_build_index_matches_jax(kind):
    C, _ = _corpus_queries(150, 100, 0.1, 1, seed=14)
    got, ref = _index(C, kind, 64, lane_pad=32), _jindex(C, kind, 64, lane_pad=32)
    assert (got.n, got.m, got.block_rows, got.kind, got.n_padded, got.n_blocks) == (
        ref.n, ref.m, ref.block_rows, ref.kind, ref.n_padded, ref.n_blocks)
    for g, r in zip(got.stats, ref.stats):
        np.testing.assert_allclose(host(g), np.asarray(r), rtol=0, atol=VAL_TOL)
    if kind == "dense":
        np.testing.assert_array_equal(host(got.corpus), np.asarray(ref.corpus))
    else:
        for g, r in zip(got.corpus, ref.corpus):
            np.testing.assert_array_equal(host(g), np.asarray(r))
        np.testing.assert_array_equal(host(got.bdims), np.asarray(ref.bdims))
        np.testing.assert_array_equal(host(got.bx), np.asarray(ref.bx))
        assert got.sparse_corpus().n == ref.sparse_corpus().n
    np.testing.assert_array_equal(got.stats_host()[1], ref.stats_host()[1])
    assert index_nbytes(got) == jindex.index_nbytes(ref)


def test_build_index_normalizes_and_index_from_numpy_round_trips():
    C, Q = _corpus_queries(90, 70, 0.2, 5, seed=15)
    ref = jindex.build_index(C * 3.0, block_rows=32)
    got = build_index(C * 3.0, block_rows=32, device="cpu")
    np.testing.assert_allclose(host(got.corpus), np.asarray(ref.corpus), atol=VAL_TOL)
    for kind in ("dense", "sparse"):
        j = _jindex(C, kind, 32)
        corpus = (tuple(np.asarray(x) for x in j.corpus) if kind == "sparse"
                  else np.asarray(j.corpus))
        t = interop.index_from_numpy(
            corpus, *(np.asarray(x) for x in j.stats),
            bdims=None if j.bdims is None else np.asarray(j.bdims),
            bx=None if j.bx is None else np.asarray(j.bx),
            n=j.n, m=j.m, block_rows=j.block_rows, kind=j.kind,
            normalized=j.normalized, device="cpu",
        )
        assert_same_matches(query_topk(t, Q, 0.25, 6, block_q=8), _oracle(Q, C, 0.25, 6))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("t,k,nq", [(0.25, 8, 11), (-0.3, 6, 5), (0.1, 260, 9)])
def test_query_topk_matches_jax_and_oracle(kind, t, k, nq):
    """Both packages against the oracle, at block_q 8/64/128 with the batch
    not a multiple of it, t ≤ 0 (every tile live, padded rows must not
    match) and k above n."""
    C, Q = _corpus_queries(200, 96, 0.1, nq, seed=16)
    assert_clear_of_threshold(Q, C, t)
    ref = _oracle(Q, C, t, k)
    jref = jquery.query_topk(_jindex(C, kind, 64), jnp.asarray(Q), t, k, block_q=16)
    assert_same_matches(jref, ref, order=False)
    index = _index(C, kind, 64)
    for block_q in (8, 64, 128):
        for use_kernel in (False, True):
            got = query_topk(index, Q, t, k, block_q=block_q, use_kernel=use_kernel)
            assert got.values.shape == (nq, k)
            assert_same_matches(got, jref, order=False)
            assert_same_matches(got, ref)
    if t < 0:  # every real corpus row matches every query, padding never
        assert (host(got.counts) == 200).all()


def _f1_case():
    """A standard-normal corpus of 512 x 96 rows, normalised and stored in
    bf16, and 16 queries: its first rows plus 0.05-scaled noise, normalised
    and kept in f32 (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    C = rng.standard_normal((512, 96)).astype(np.float32)
    C /= np.linalg.norm(C, axis=1, keepdims=True)
    Q = C[:16] + 0.05 * rng.standard_normal((16, 96)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    return C, Q.astype(np.float32)


@pytest.mark.parametrize("index_dtype,query_dtype", [
    ("bfloat16", "float32"),  # a bf16 index scores f32 queries unrounded
    ("float32", "bfloat16"),  # a bf16 query is widened exactly, not the index rounded
])
def test_query_topk_mixed_dtypes_match_jax(index_dtype, query_dtype):
    """Neither operand is rounded to the other's dtype: the reference's
    einsum and K4's dot promote f32 x bf16 to an f32 product, so counts,
    match sets and order equal the JAX package's, values to f32 rounding,
    and counts equal the float64 count on the bf16-rounded operands in
    every row with no pair within 1e-5 of t."""
    t, k = 0.1, 8
    C, Q = _f1_case()
    cj = jnp.asarray(C).astype(index_dtype)
    qj = jnp.asarray(Q).astype(query_dtype)
    jref = jquery.query_topk(jindex.build_index(cj, block_rows=128, normalize=False), qj, t, k,
                             block_q=16, use_kernel=False)
    index = build_index(torch.from_numpy(C).to(getattr(torch, index_dtype)), block_rows=128,
                        normalize=False, device="cpu")
    assert index.corpus.dtype == getattr(torch, index_dtype)
    q = torch.from_numpy(Q).to(getattr(torch, query_dtype))
    got = query_topk(index, q, t, k, block_q=16, use_kernel=False)
    assert_same_matches(got, jref)
    S = (q.double() @ index.corpus[:512, :96].double().T).numpy()
    clear = (np.abs(S - t) > 1e-5).all(axis=1)
    assert clear.sum() >= 12
    np.testing.assert_array_equal(host(got.counts)[clear], (S >= t).sum(axis=1)[clear])


def test_query_topk_all_pruned_and_input_checks():
    C, Q = _corpus_queries(100, 64, 0.2, 4, seed=17)
    for kind in ("dense", "sparse"):
        index = _index(C, kind, 32)
        got = query_topk(index, Q, 1.5, 4, block_q=8)  # no pair reaches t
        assert (host(got.indices) == -1).all() and (host(got.counts) == 0).all()
        zero, tiles = _query_tiles(index, np.zeros((2, 64), np.float32), 0.1, 4, block_q=8)
        assert tiles == {"total": 4, "live": 0, "scored": 0}  # all pruned
        assert (host(zero.counts) == 0).all() and np.isneginf(host(zero.values)).all()
        sq = query_topk(index, from_dense(Q, device="cpu"), 0.3, 4, block_q=8)
        assert_same_matches(sq, _oracle(Q, C, 0.3, 4))
        with pytest.raises(ValueError, match="Q must be"):
            query_topk(index, Q[:, :60], 0.3, 4)


# -- early exit ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("t,k", [(0.2, 8), (-0.5, 6)])
def test_early_exit_identical_values_ids_saturated_counts(kind, t, k):
    C, Q = _corpus_queries(220, 96, 0.1, 11, seed=10)
    index = _index(C, kind, 64)
    ref = query_topk(index, Q, t, k, block_q=16)
    for use_kernel in (False, True):
        _assert_ee_exact(ref, query_topk(index, Q, t, k, block_q=16, early_exit=True,
                                         use_kernel=use_kernel), k)


@pytest.mark.parametrize("kind,use_kernel", [("dense", False), ("dense", True),
                                             ("sparse", False)])
def test_early_exit_skips_tiles_on_overlap_clusters(kind, use_kernel):
    """Cross-cluster tiles stay live (the shared vocabulary gives them a small
    bound) but lose to within-cluster top-k: skipped > 0, results exact, and
    as many skips as the JAX early-exit scan."""
    sp, jsp, Q = _overlap_case()
    corpus = sp if kind == "sparse" else host(to_dense(sp))
    index = build_index(corpus, block_rows=64, normalize=False, device="cpu")
    ref = query_topk(index, Q, 0.01, 8)
    got, tiles = _query_tiles(index, Q, 0.01, 8, early_exit=True, use_kernel=use_kernel)
    _assert_ee_exact(ref, got, 8)
    assert tiles["scored"] < tiles["live"]
    jcorpus = jsp if kind == "sparse" else jsparse.to_dense(jsp)
    jidx = jindex.build_index(jcorpus, block_rows=64, normalize=False)
    with MetricsRegistry() as reg:
        jquery.query_topk(jidx, jnp.asarray(Q), 0.01, 8, early_exit=True)
    skipped = int(reg.counters.get("serving.early_exit_skipped_tiles", 0))
    assert tiles["live"] - tiles["scored"] == skipped > 0


def _tie_probe(k=4):
    """A query block holding e_d and e_d'. Corpus block 1 (higher ids) holds
    k copies of each and (e_d + e_d')/√2: its bound √2 puts it first in the
    worklist, and it fills both rows' top-k with 1.0. Corpus block 0 (lower
    ids) holds k copies of e_d and of e_d' only: its bound is exactly 1.0,
    every row's k-th value. The (value desc, id asc) order wants block 0's
    ids; a `k-th ≥ bound` skip would keep block 1's."""
    m, d, d2 = 64, 3, 17
    C = np.zeros((128, m), np.float32)
    C[0:k, d] = 1.0
    C[k:2 * k, d2] = 1.0
    C[64:64 + k, d] = 1.0
    C[64 + k:64 + 2 * k, d2] = 1.0
    C[64 + 2 * k, [d, d2]] = np.float32(1 / np.sqrt(2))
    Q = np.zeros((2, m), np.float32)
    Q[0, d] = Q[1, d2] = 1.0
    return C, Q


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_early_exit_tie_probe_keeps_lower_ids(kind):
    k = 4
    C, Q = _tie_probe(k)
    index = _index(C, kind, 64)
    ref = query_topk(index, Q, 0.5, k, block_q=8)
    np.testing.assert_array_equal(host(ref.indices), [[0, 1, 2, 3], [4, 5, 6, 7]])
    _, wl, ubw = _k5_inputs(index, Q, 0.5, 8)
    assert wl[1].tolist() == [1, 0] and ubw[1].item() == 1.0  # bound = k-th value
    for use_kernel in (False, True):
        got, tiles = _query_tiles(index, Q, 0.5, k, block_q=8, early_exit=True,
                                  use_kernel=use_kernel)
        _assert_ee_exact(ref, got, k)
        assert tiles["scored"] == 2  # strict: the tied tile is scored
    # the JAX scan skips the tied tile (k-th ≥ bound) and keeps block 1's ids
    jidx = _jindex(C, kind, 64)
    jee = jquery.query_topk(jidx, jnp.asarray(Q), 0.5, k, block_q=8, early_exit=True)
    assert set(np.asarray(jee.indices)[0]) == {64, 65, 66, 67}
    v, i, c = triple(ref)
    assert (v == 1.0).all() and (c == 2 * k + 1).all()
