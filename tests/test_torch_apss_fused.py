"""Parity of the port's self-join kernels module (``repro_torch.kernels``)
with the JAX package, on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; these
tests hold those plain versions against the Pallas kernels in interpret
mode (K1 ``apss_fused_pallas``, K2 ``apss_tile_candidates_pallas``) on the
same padded inputs, the host worklist and the packet fold against theirs,
and the whole worklist path against ``apss_reference``. Tolerance, as in
``_torch_parity``: no float64 score within 1e-5 of t; counts and match sets
exactly equal, values within 1e-6, order equal under (value desc, id asc).
Raw kernel outputs keep their ``NEG_LARGE`` / ``-1`` empty slots.
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
)
from repro.core.apss import apss_reference as japss_reference  # noqa: E402
from repro.core.pruning import block_prune_mask as jblock_prune_mask  # noqa: E402
from repro.kernels.apss_block import ops as jops  # noqa: E402
from repro.kernels.apss_block.fused import (  # noqa: E402
    apss_fused_pallas,
    apss_tile_candidates_pallas,
)
from repro_torch.core.apss import apss_blocked  # noqa: E402
from repro_torch.data.synthetic import clustered_corpus  # noqa: E402
from repro_torch.kernels.apss_block import fused, ops  # noqa: E402

T, K = 0.35, 16


def _corp(n, m, seed, density=0.3):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < density
    return D / np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)


def _pad(D, rows, cols):
    return np.pad(D, ((0, (-D.shape[0]) % rows), (0, (-D.shape[1]) % cols)))


def _assert_raw_equal(got, ref):
    """Kernel outputs, tuple by tuple: ids and counts exact, values 1e-6."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = host(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, r.shape)
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, r, atol=VAL_TOL, rtol=0)
        else:
            np.testing.assert_array_equal(g, r)


# -- K1: streaming fused kernel ----------------------------------------------


@pytest.mark.parametrize(
    "case", ["selfjoin_auto_mask", "ring_step_offsets", "no_exclude_dead_tile"]
)
def test_plain_k1_matches_pallas_interpret(case):
    bm = 128
    if case == "selfjoin_auto_mask":
        D = _corp(200, 100, seed=101)
        x = y = _pad(D, bm, 128)
        n_valid, row_off, col_off, excl, k, t = 200, 0, 0, True, K, T
        mask = np.asarray(jblock_prune_mask(
            jnp.asarray(x), jnp.asarray(y), t, bm, bm, use_minsize=False
        )).astype(np.int32)
    else:
        # A ring step: local rows are global rows 100..227, the visiting
        # column shard is global 0..229 (padded to 256).
        D = _corp(230, 120, seed=2)
        x = _pad(D[100:228], bm, 128)
        y = _pad(D, bm, 128)
        n_valid, row_off, col_off = 230, 100, 0
        excl = case == "ring_step_offsets"
        k, t = (K if excl else 8), 0.3
        mask = np.ones((1, 2), np.int32)
        if case == "no_exclude_dead_tile":
            mask[0, 1] = 0
    assert_clear_of_threshold(x, y, t)
    ref = apss_fused_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        jnp.asarray([[row_off, col_off]], jnp.int32), t, k,
        block_m=bm, block_n=bm, block_k=128, n_valid_cols=n_valid,
        exclude_self=excl, interpret=True,
    )
    got = fused.apss_fused_kernel(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask), t, k,
        block_m=bm, block_n=bm, n_valid_cols=n_valid, row_offset=row_off,
        col_offset=col_off, exclude_self=excl,
    )
    _assert_raw_equal(got, ref)
    assert int(np.asarray(ref[2]).sum()) > 0


# -- K1's launch shape: column segments and their merge -----------------------


def _dyadic(n, m, seed):
    """Rows of quarter-steps 0..0.75 (every product and sum exact in f32, so
    the order of a sum cannot change a score), with rows 10-19 copies of
    row 3 (ties broken by id)."""
    X = np.random.default_rng(seed).integers(0, 4, (n, m)).astype(np.float32) / 4
    X[10:20] = X[3]
    return X


@pytest.mark.parametrize("n_segments", [1, 2, 5])
@pytest.mark.parametrize("case", ["self_join", "no_exclude", "ring_offsets", "k_gt_n",
                                  "dead_mask", "fine_mask"])
def test_k1_segment_merge_equals_unsplit(n_segments, case):
    """K1's column segments (each through ``col_offset``) merged equal the
    unsplit plain version exactly in values, ids and counts."""
    Y = torch.from_numpy(_dyadic(640, 64, seed=3))
    X = Y[:256]
    block, k, t = 128, 8, 9.0
    kw = dict(n_valid_cols=600, row_offset=0, col_offset=0, exclude_self=True)
    if case == "no_exclude":
        kw["exclude_self"] = False
    elif case == "ring_offsets":  # rows 1000.., the visiting columns 744.. (self pairs inside)
        kw.update(row_offset=1000, col_offset=744)
    elif case == "k_gt_n":
        k, t = 700, 0.0
    elif case == "fine_mask":  # 64-row blocks, a mask that cuts segments
        block = 64
    mask = torch.ones((256 // block, 640 // block), dtype=torch.int32)
    if case == "dead_mask":
        mask.zero_()
    elif block == 64:
        mask[::2, 1::3] = 0
    kw.update(block_m=block, block_n=block)
    ref = fused.apss_fused_plain(X, Y, mask, t, k, **kw)
    got = fused.apss_fused_segmented_plain(X, Y, mask, t, k, n_segments=n_segments, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert (int(ref[2].sum()) == 0) == (case == "dead_mask")
    if case == "k_gt_n":  # every valid column but the row itself
        assert (ref[2] == 599).all()


def test_k1_merge_breaks_ties_by_id_across_segments():
    """Equal values in two segments: the lower id first, wherever it lies."""
    v = torch.tensor([[[2.0, 1.0, fused.NEG_LARGE]], [[2.0, 2.0, fused.NEG_LARGE]]])
    i = torch.tensor([[[7, 8, -1]], [[1, 3, -1]]], dtype=torch.int32)
    c = torch.tensor([[2], [5]], dtype=torch.int32)
    gv, gi, gc = fused.merge_segments_plain(v, i, c)
    assert gi.tolist() == [[1, 3, 7]] and gv.tolist() == [[2.0, 2.0, 2.0]]
    assert gc.tolist() == [[7]]


@pytest.mark.parametrize("row_tiles,col_tiles,slots,want", [
    (54, 54, 132, 7),    # radikal_full: 6,912 padded rows on an H100
    (512, 512, 132, 1),  # clustered_65k
    (2, 2, 132, 2),      # a corpus of two tiles
    (1, 40, 132, 32),    # one row tile, more columns than lanes of the merge
    (54, 54, 264, 14),
])
def test_k1_segments_fill_the_card_and_fit_the_merge(row_tiles, col_tiles, slots, want):
    """Enough segments for every slot twice, as far as columns and the
    merge's 32 lanes allow; the fewest whose steps on the busiest slot come
    within the slack of the fewest steps any count allows."""
    S = fused.fused_segments(row_tiles, col_tiles, slots)
    assert S == want
    hi = min(col_tiles, 32)
    lo = min(hi, -(-2 * slots // row_tiles))
    assert lo <= S <= hi

    def steps(s):
        return -(-row_tiles * s // slots) * -(-col_tiles // s)

    best = min(steps(s) for s in range(lo, hi + 1))
    assert steps(S) <= (1 + fused.SEGMENT_SLACK) * best
    assert all(steps(s) > (1 + fused.SEGMENT_SLACK) * best for s in range(lo, S))
    bounds = fused.segment_bounds(col_tiles, S)
    assert bounds[0][0] == 0 and bounds[-1][1] == col_tiles
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(bounds, bounds[1:]))
    with pytest.raises(ValueError, match="no segments"):
        fused.fused_segments(0, col_tiles, slots)


# -- K2: live-tile worklist kernel + host worklist + fold --------------------


@pytest.fixture(scope="module")
def k2_case():
    D = _corp(300, 100, seed=303)
    Dp = _pad(D, 128, 128)
    mask, ub = jblock_prune_mask(jnp.asarray(Dp), jnp.asarray(Dp), T, 128, 128,
                                 return_ub=True)
    wl = jops.compact_worklist(mask, ub)
    ref = apss_tile_candidates_pallas(
        jnp.asarray(Dp), jnp.asarray(wl), T, K,
        block_m=128, block_n=128, block_k=128, n_valid=300, interpret=True,
    )
    return D, Dp, np.asarray(mask), np.asarray(ub), wl, ref


def test_plain_k2_matches_pallas_interpret(k2_case):
    D, Dp, _, _, wl, ref = k2_case
    assert_clear_of_threshold(D, D, T, exclude_self=True)
    assert (wl[0] == wl[1]).any() and (wl[0] != wl[1]).any()  # diagonal + mirrors
    got = fused.apss_tile_candidates_kernel(
        torch.from_numpy(Dp), torch.from_numpy(wl), T, K,
        block_m=128, block_n=128, n_valid=300,
    )
    _assert_raw_equal(got, ref)


@pytest.mark.parametrize("T_,block_m,block_n,per_tile", [
    (3, 256, 256, 4), (2, 256, 128, 2), (2, 128, 256, 2), (4, 64, 64, 1)])
def test_k2_work_items_cover_each_tile_once(T_, block_m, block_n, per_tile):
    """K2's scoring launch: parts of up to 128 x 128 scores of square and
    non-square tiles, numbered as the kernel numbers its blocks (t, then row
    part, then column part: one tile's parts adjacent), that cover every
    score of every worklist tile exactly once; K3's items are the square
    case."""
    from repro_torch.kernels.apss_block import sparse

    items = fused.tile_work_items(T_, block_m, block_n)
    assert items.dtype == np.int32 and items.shape == (T_ * per_tile, 3)
    np.testing.assert_array_equal(items[:, 0], np.arange(len(items)) // per_tile)
    cover = np.zeros((T_, block_m, block_n), np.int32)
    for t, r0, c0 in items.tolist():
        cover[t, r0:r0 + fused.TILE_ITEM, c0:c0 + fused.TILE_ITEM] += 1
    assert (cover == 1).all()
    if block_m == block_n:
        np.testing.assert_array_equal(sparse.sparse_work_items(T_, block_m), items)
    assert sparse.K3_ITEM == fused.TILE_ITEM
    with pytest.raises(ValueError, match="no work items"):
        fused.tile_work_items(0, block_m, block_n)


@pytest.mark.parametrize("with_ub", [True, False])
def test_compact_and_pad_worklist_identical(k2_case, with_ub):
    _, _, mask, ub, _, _ = k2_case
    args = (mask, ub) if with_ub else (mask,)
    ref = jops.compact_worklist(*args)
    got = ops.compact_worklist(*(torch.tensor(np.asarray(a)) for a in args))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(ops.pad_worklist(got), jops.pad_worklist(ref)):
        np.testing.assert_array_equal(a, b)
    assert ops.compact_worklist(np.zeros_like(mask)) is None


def test_fold_packets_parity(k2_case):
    D, _, _, _, wl, ref = k2_case
    fv, fi, fc, bv, bi, bc = ref
    kw = dict(grid_m=3, block_m=128, k=K)
    want = jops.fold_packets(
        jnp.asarray(wl), fv, fi, fc[..., 0], bv, bi, bc[..., 0], **kw
    )
    t = [torch.from_numpy(np.asarray(a)) for a in ref]
    got = ops.fold_packets(
        torch.from_numpy(wl), t[0], t[1], t[2][..., 0], t[3], t[4], t[5][..., 0], **kw
    )
    for g, w in zip(got, want):
        assert host(g).shape == np.asarray(w).shape
    from repro.core.matches import Matches as JMatches
    from repro_torch.core.matches import Matches as TMatches

    assert_same_matches(TMatches(*got), JMatches(*want))
    assert_same_matches(
        TMatches(*(a[:300] for a in got)), japss_reference(jnp.asarray(D), T, K)
    )


# -- the worklist path end to end --------------------------------------------


@pytest.mark.parametrize("which", ["conftest", "clustered"])
def test_apss_fused_compacted_parity(corpus, which):
    D, t = (corpus, T) if which == "conftest" else (
        clustered_corpus(300, 192, 10, n_clusters=3, seed=4), 0.4)
    assert_clear_of_threshold(D, D, t, exclude_self=True)
    got = ops.apss_fused_compacted(D, t, K, block_m=128, block_k=128, device="cpu")
    ref = jops.apss_fused_compacted(jnp.asarray(D), t, K, block_m=128, block_k=128)
    assert_same_matches(got, ref, order=False)  # the JAX fold orders ties by tile
    assert_same_matches(got, japss_reference(jnp.asarray(D), t, K))


def test_mirror_packet_reports_partner_id():
    rng = np.random.default_rng(11)
    D = _corp(256, 64, density=1.0, seed=11)
    D[200] = D[5] + 0.01 * np.abs(rng.standard_normal(64)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    S = D @ D.T
    np.fill_diagonal(S, 0.0)
    assert (S[200] >= 0.98).sum() == 1 and S[200].argmax() == 5
    got = ops.apss_fused_compacted(D, 0.98, 8, block_m=128, block_k=64, device="cpu")
    assert int(got.counts[200]) == 1 and int(got.indices[200, 0]) == 5
    assert int(got.indices[5, 0]) == 200


@pytest.mark.parametrize("path", ["fused", "compacted"])
def test_overflow_rows_counts_stay_exact(path):
    one = np.zeros((1, 64), np.float32)
    one[0, 0] = 1.0
    D = np.repeat(one, 32, axis=0)  # 32 identical unit rows: all ties
    if path == "fused":
        got = ops.apss_fused(D, D, 0.5, 4, block_m=128, block_n=128, device="cpu")
    else:
        got = ops.apss_fused_compacted(
            D, 0.5, 4, block_m=128, block_k=128, device="cpu"
        )
    assert (host(got.counts) == 31).all() and bool(got.overflowed().all())
    np.testing.assert_allclose(host(got.values), 1.0)
    # Ties go to the lower id: row 0 keeps 1..4, every other row 0..3 minus itself.
    np.testing.assert_array_equal(host(got.indices)[0], [1, 2, 3, 4])
    np.testing.assert_array_equal(host(got.indices)[2], [0, 1, 3, 4])


# -- edge probes ---------------------------------------------------------------


def _probe(name):
    if name == "n130_m100":
        return _corp(130, 100, seed=21), T, K
    if name == "negative_t_padded":
        return _corp(130, 100, seed=22), -0.1, K
    if name == "k_gt_n":
        return _corp(100, 64, seed=23), 0.2, 160
    if name == "bf16":
        return _corp(200, 96, seed=24), 0.3, K
    return _corp(200, 96, seed=25), 1.5, K


@pytest.mark.parametrize(
    "name", ["n130_m100", "negative_t_padded", "k_gt_n", "bf16", "all_pruned"]
)
def test_edge_probes(name):
    D, t, k = _probe(name)
    if name == "bf16":
        Dt = torch.from_numpy(D).to(torch.bfloat16)
        Dj = jnp.asarray(D).astype(jnp.bfloat16)
        np.testing.assert_array_equal(Dt.float().numpy(), np.asarray(Dj, np.float32))
        D = Dt.float().numpy()
    else:
        Dt, Dj = torch.from_numpy(D), jnp.asarray(D)
    assert_clear_of_threshold(D, D, t, exclude_self=True)
    ref = japss_reference(Dj, t, k)
    for got in (
        apss_blocked(Dt, t, k, block_rows=128, use_kernel=True, device="cpu"),
        ops.apss_fused_compacted(Dt, t, k, block_m=128, block_k=128, device="cpu"),
    ):
        assert_same_matches(got, ref)
    if name == "negative_t_padded":  # every real pair matches, no padding row
        assert (host(ref.counts) == 129).all()
    if name == "all_pruned":
        assert int(np.asarray(ref.counts).sum()) == 0


def test_explicit_dead_mask_is_empty():
    D = _corp(128, 96, seed=1)
    got = ops.apss_fused(D, D, 0.0, K, block_mask=np.zeros((1, 1), np.int32),
                         block_m=128, block_n=128, device="cpu")
    assert int(got.counts.sum()) == 0
    assert (host(got.indices) == -1).all() and not np.isfinite(host(got.values)).any()


def test_cpu_tensors_take_the_plain_versions():
    before = dict(fused.LAUNCHES)
    D = torch.from_numpy(_pad(_corp(130, 100, seed=5), 128, 128))
    mask = torch.ones((2, 2), dtype=torch.int32)
    a = fused.apss_fused_kernel(D, D, mask, T, K, block_m=128, block_n=128,
                                n_valid_cols=130)
    b = fused.apss_fused_plain(D, D, mask, T, K, block_m=128, block_n=128,
                               n_valid_cols=130)
    _assert_raw_equal(a, b)
    ij = torch.tensor([[0, 0, 1], [0, 1, 1]], dtype=torch.int32)
    c = fused.apss_tile_candidates_kernel(D, ij, T, K, block_m=128, block_n=128,
                                          n_valid=130)
    d = fused.apss_tile_candidates_plain(D, ij, T, K, block_m=128, block_n=128,
                                         n_valid=130)
    _assert_raw_equal(c, d)
    assert fused.LAUNCHES == before  # a plain version launches nothing
