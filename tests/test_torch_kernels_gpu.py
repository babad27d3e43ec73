"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 and K2 (the dense self-join), K3 (the sparse one), K7 (the dense score
matrix), the serving kernels K4 (also per shard of a sharded index, and
its masked entry under the live index and the resumable sweep), K5 and
K6, and the LM's attention
kernels
K8 (flash attention) and K9 (flash-decode partials); the work each launch
reports to the op census (``launch.op_analysis``), and the build/load
monitor's no-retrace contract on a warmed query (``obs.compile``). Every
test here needs
an NVIDIA Hopper card and ``nvcc``;
each decides that inside itself (the ``card`` fixture) and skips with a
reason elsewhere. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance: inputs keep every float64 score more than 1e-5 from t, so the
kernel (FMA in feature order) and the plain version (cuBLAS) keep the same
pairs; ids and counts must be equal, values within 1e-5 (K7: the zero
pattern equal as well). K8 and K9 against their plain versions: outputs
within 2e-5 in f32 and 2e-2 in bf16 (the kernels and the plain versions
widen bf16 exactly and sum in f32, in other orders); K9's m within 2e-5 and
l within a relative 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_clear_of_threshold  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _corp(n, m, seed, density=0.3):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < density
    return D / np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)


def _pad(D, rows, cols):
    return np.pad(D, ((0, (-D.shape[0]) % rows), (0, (-D.shape[1]) % cols)))


def _assert_close(got, ref):
    for g, r in zip(got, ref):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        assert g.shape == r.shape and g.dtype == r.dtype
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, r, atol=TOL, rtol=0)
        else:
            np.testing.assert_array_equal(g, r)


def _inputs(dtype, seed):
    D = _corp(300, 200, seed=seed)
    if dtype == torch.bfloat16:
        D = torch.from_numpy(D).bfloat16().float().numpy()
    assert_clear_of_threshold(D, D, 0.3, exclude_self=True)
    return D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [128, 256])
def test_k1_kernel_matches_plain(card, dtype, block):
    from repro_torch.kernels.apss_block import fused

    D = _inputs(dtype, seed=1)
    Dp = torch.from_numpy(_pad(D, 256, 128)).to(card, dtype)
    g = Dp.shape[0] // block
    mask = torch.ones((g, g), dtype=torch.int32)
    mask[0, -1] = 0
    kw = dict(block_m=block, block_n=block, n_valid_cols=300, row_offset=0,
              col_offset=0, exclude_self=True)
    before = fused.LAUNCHES["apss_fused"]
    got = fused.apss_fused_kernel(Dp, Dp, mask, 0.3, 16, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["apss_fused"] == before + 1
    ref = fused.apss_fused_plain(Dp, Dp, mask, 0.3, 16, **kw)
    _assert_close(got, ref)
    assert int(ref[2].sum()) > 0


def test_k1_kernel_runtime_offsets(card):
    from repro_torch.kernels.apss_block import fused

    D = _corp(230, 120, seed=2)
    assert_clear_of_threshold(D[100:228], D, 0.3)
    x = torch.from_numpy(_pad(D[100:228], 128, 128)).to(card)
    y = torch.from_numpy(_pad(D, 128, 128)).to(card)
    mask = torch.ones((1, 2), dtype=torch.int32)
    for col_off in (0, 300):  # the second step sees no self pair
        kw = dict(block_m=128, block_n=128, n_valid_cols=230, row_offset=100,
                  col_offset=col_off, exclude_self=True)
        got = fused.apss_fused_kernel(x, y, mask, 0.3, 16, **kw)
        _assert_close(got, fused.apss_fused_plain(x, y, mask, 0.3, 16, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 32, "cap"])
@pytest.mark.parametrize("live", ["all", "masked"])
def test_k1_segments_match_plain(card, dtype, k, live):
    """K1 over 40 column tiles in 32 segments (which 40 does not divide), a
    row count off the 128-row tile (64-row blocks), ring-step offsets, a
    masked or all-live grid, k from 1 to the cap: equal to the unsplit plain
    version."""
    from repro_torch.kernels.apss_block import fused

    k = fused.FUSED_MAX_K if k == "cap" else k
    # Quarter steps (exact in bf16; every product and sum exact in f32, so
    # no order of summation moves a score across t = 9), rows 1010-1019
    # copies of row 1003 (ties broken by id).
    D = np.random.default_rng(5).integers(0, 4, (5100, 64)).astype(np.float32) / 4
    D[1010:1020] = D[1003]
    x = torch.from_numpy(_pad(D[1000:1300], 64, 64)).to(card, dtype)
    y = torch.from_numpy(_pad(D, 128, 64)).to(card, dtype)
    assert x.shape[0] % 128 and y.shape[0] // 128 == 40
    assert fused.fused_segments_for(x, y.shape[0], k) == 32
    mask = torch.ones((x.shape[0] // 64, y.shape[0] // 64), dtype=torch.int32)
    if live == "masked":
        mask[::2, 1::3] = 0
        mask[:, :4] = 0
    kw = dict(block_m=64, block_n=64, n_valid_cols=5100, row_offset=1000, col_offset=0,
              exclude_self=True)
    before = fused.LAUNCHES["apss_fused"]
    got = fused.apss_fused_kernel(x, y, mask, 9.0, k, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["apss_fused"] == before + 1
    ref = fused.apss_fused_plain(x, y, mask, 9.0, k, **kw)
    _assert_close(got, ref)
    assert int(ref[2].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_matches_plain(card, dtype):
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.kernels.apss_block import fused
    from repro_torch.kernels.apss_block.ops import compact_worklist

    D = _inputs(dtype, seed=2)
    Dp = torch.from_numpy(_pad(D, 128, 128)).to(card, dtype)
    mask, ub = block_prune_mask(Dp, Dp, 0.3, 128, return_ub=True)
    ij = torch.as_tensor(compact_worklist(mask, ub)).to(card)
    kw = dict(block_m=128, block_n=128, n_valid=300)
    before = fused.LAUNCHES["apss_tile_candidates"]
    got = fused.apss_tile_candidates_kernel(Dp, ij, 0.3, 16, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["apss_tile_candidates"] == before + 1
    _assert_close(got, fused.apss_tile_candidates_plain(Dp, ij, 0.3, 16, **kw))


def _k2_run(D, ij, block_m, block_n, n_valid, *, t=0.3, k=16):
    """K2 and its plain version on the padded ``D``; one launch counted."""
    from repro_torch.kernels.apss_block import fused

    kw = dict(block_m=block_m, block_n=block_n, n_valid=n_valid)
    before = fused.LAUNCHES["apss_tile_candidates"]
    got = fused.apss_tile_candidates_kernel(D, ij, t, k, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["apss_tile_candidates"] == before + 1
    return got, fused.apss_tile_candidates_plain(D, ij, t, k, **kw)


def _every_pair(n_i, n_j, card):
    return torch.tensor([[i, j] for i in range(n_i) for j in range(n_j)],
                        dtype=torch.int32).T.contiguous().to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_m,block_n", [(64, 64), (128, 128), (256, 256), (256, 128),
                                             (128, 256)])
def test_k2_blocks_match_plain(card, dtype, block_m, block_n):
    """Square and non-square tiles (1, 2 or 4 work items a tile, parts of
    64 rows or columns), every (row block, column block) pair as the
    worklist, m = 224 (not a multiple of 128), n_valid inside the last
    block."""
    D = _inputs(dtype, seed=2)
    Dp = torch.from_numpy(_pad(D, 256, 32)).to(card, dtype)
    assert Dp.shape[1] == 224
    ij = _every_pair(Dp.shape[0] // block_m, Dp.shape[0] // block_n, card)
    got, ref = _k2_run(Dp, ij, block_m, block_n, 300)
    _assert_close(got, ref)
    assert int(ref[2].sum()) > 0 and int(ref[5].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,seed", [(32, 16), (96, 16), (160, 14)])
def test_k2_narrow_widths_match_plain(card, dtype, m, seed):
    """One ring stage (m = 32), three, and five (not a multiple of 128)."""
    D = _corp(300, m, seed=seed)
    if dtype == torch.bfloat16:
        D = torch.from_numpy(D).bfloat16().float().numpy()
    assert_clear_of_threshold(D, D, 0.3, exclude_self=True)
    Dp = torch.from_numpy(_pad(D, 128, 32)).to(card, dtype)
    assert Dp.shape[1] == m
    ij = torch.tensor([[0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]], dtype=torch.int32).to(card)
    got, ref = _k2_run(Dp, ij, 128, 128, 300)
    _assert_close(got, ref)
    assert int(ref[2].sum()) > 0


@pytest.mark.parametrize("case", ["one_tile", "all_diagonal", "n_valid_inside"])
def test_k2_worklist_edges_match_plain(card, case):
    """A one-tile worklist, a worklist of diagonal tiles only (every mirror
    packet empty), and n_valid inside the last block with real rows past
    it (they must not appear)."""
    D = _inputs(torch.float32, seed=2)
    Dp = torch.from_numpy(_pad(D, 128, 32)).to(card)
    n_valid = 300
    if case == "one_tile":
        ij = torch.tensor([[1], [2]], dtype=torch.int32).to(card)
    elif case == "all_diagonal":
        ij = torch.tensor([[2, 0, 1], [2, 0, 1]], dtype=torch.int32).to(card)
    else:
        n_valid = 270
        ij = torch.tensor([[0, 0, 1, 2, 1, 0], [0, 2, 2, 2, 1, 1]], dtype=torch.int32).to(card)
    got, ref = _k2_run(Dp, ij, 128, 128, n_valid)
    _assert_close(got, ref)
    if case == "all_diagonal":
        assert int(got[5].sum()) == 0 and bool((got[4] == -1).all())
    if case == "n_valid_inside":
        assert int(ref[2].sum()) > 0
        for ids in (got[1], got[4]):
            assert int(ids.max()) < n_valid
    assert int(ref[2].sum()) > 0


def _dense_from_packets(p, ij, n, block_m, block_n):
    """The (n, n) scores the packets of a full upper-triangular worklist
    hold (forward at (row, gcol), mirror at (col, grow)), NaN elsewhere."""
    S = torch.full((n, n), float("nan"), device=p[0].device)
    for v, i, blocks, bs in ((p[0], p[1], ij[0], block_m), (p[3], p[4], ij[1], block_n)):
        rows = (blocks.long()[:, None] * bs + torch.arange(bs, device=v.device))[:, :, None]
        keep = i >= 0
        S[rows.expand_as(i)[keep], i[keep].long()] = v[keep]
    return S


def _zipf_law(n, m, seed, nnz=40.0):
    """Unit rows of Poisson(nnz) nonzeros on dimensions drawn without
    replacement ∝ (d + 1)^-1.1 (Gumbel-top-k), weights |N(0, 1)| + 0.05:
    radikal's law. At 1,024 × 32,768 a pair of 128-row tiles shares a
    nonzero in about 41 % of its 32-feature chunks."""
    rng = np.random.default_rng(seed)
    logp = -1.1 * np.log(np.arange(m) + 1.0)
    X = np.zeros((n, m), np.float32)
    for i, k in enumerate(np.maximum(1, rng.poisson(nnz, n))):
        dims = np.argpartition(-(logp - np.log(-np.log(rng.random(m)))), k)[:k]
        X[i, dims] = np.abs(rng.standard_normal(k)) + 0.05
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def _law_case(law, block):
    """``(D, t)`` of a K1 = K2 case: ``uniform`` (30 % dense, every chunk
    held), ``zipf`` (radikal's law), ``zero_tile`` (rows 128-255 zero, t =
    0: their scores +0, every one counted), ``non_finite`` (an Inf at a
    chunk only its row holds: Inf · 0 is NaN in the walk over every chunk,
    so that chunk must be walked; t = -1 counts every finite score)."""
    if law == "uniform":
        return _corp(3 * block - 20, 200, seed=8), 0.3
    D = _zipf_law(1024, 32768, seed=9)
    if law == "zero_tile":
        D[128:256] = 0
        return D, 0.0
    if law == "non_finite":
        D[:, 32 * 1000:32 * 1001] = 0
        D[5, 32 * 1000 + 7] = np.inf
        return D, -1.0
    return D, 0.2


def _scores_of(v, i, rows, n, device, row0=0):
    """The (n, n) scores a K1 output holds at (row0 + row, id), NaN elsewhere."""
    S = torch.full((n, n), float("nan"), device=device)
    keep = i >= 0
    r = row0 + torch.arange(rows, device=device)[:, None].expand_as(i)
    S[r[keep], i[keep].long()] = v[keep]
    return S


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("law", ["uniform", "zipf", "zero_tile", "non_finite"])
def test_k2_scores_bit_identical_to_k1(card, dtype, block, law):
    """K1 and K2 both sum each score as one fmaf chain from 0 in feature
    order, K2 over every chunk and K1 over the chunks both row tiles hold a
    nonzero in (or either a non-finite value): with k covering every
    candidate, every (row, column) score in K2's forward and mirror packets
    equals K1's bit for bit, and K1's counts are the packets' candidates a
    row. K1's bitmaps and walked stages equal their plain versions; the
    uniform corpus walks every stage, radikal's law under two thirds."""
    from repro_torch.kernels.apss_block import fused

    D, t = _law_case(law, block)
    Dp = torch.from_numpy(_pad(D, block, 32)).to(card, dtype)
    n = Dp.shape[0]
    nb = n // block
    ij = torch.tensor([[i, j] for i in range(nb) for j in range(i, nb)],
                      dtype=torch.int32).T.contiguous().to(card)
    k2 = fused.apss_tile_candidates_kernel(Dp, ij, t, n, block_m=block, block_n=block,
                                           n_valid=D.shape[0])
    mask = torch.ones((nb, nb), dtype=torch.int32)
    v1, i1, c1 = fused.apss_fused_kernel(Dp, Dp, mask, t, n, block_m=block, block_n=block,
                                         n_valid_cols=D.shape[0], exclude_self=True)
    walk = fused.last_walk()
    S1 = _scores_of(v1, i1, n, n, card)
    S2 = _dense_from_packets(k2, ij, n, block, block)
    live = ~torch.isnan(S1)
    assert torch.equal(live, ~torch.isnan(S2))
    assert torch.equal(S1[live], S2[live])
    assert torch.equal(live.sum(dim=1, dtype=torch.int32), c1[:, 0])  # k held every one
    assert int(c1.sum()) > 0

    occ = fused.fused_occupancy(Dp)
    assert torch.equal(occ.cpu(), fused.fused_occupancy_plain(Dp.cpu()))
    assert walk == fused.fused_walk_plain(occ, occ, mask, block_m=block, block_n=block,
                                          m=Dp.shape[1])
    if law == "uniform":
        assert walk[0] == walk[1]
    else:
        assert walk[0] < 2 / 3 * walk[1]
    if law == "zero_tile":  # +0 against every column, each counted
        z = S1[128:256, :D.shape[0]]
        z = z[~torch.isnan(z)]
        assert z.numel() == 128 * (D.shape[0] - 1)
        assert bool((z == 0).all()) and not bool(torch.signbit(z).any())
        assert bool((c1[128:256, 0] == D.shape[0] - 1).all())
    if law == "non_finite":  # row 5's scores are NaN, never counted
        assert int(c1[5, 0]) == 0 and int(live[:, 5].sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_offsets_and_segments_bit_identical_to_k2(card, dtype):
    """K1 on x ≠ y (two sets of bitmaps) at runtime offsets, in S > 1
    segments, scores each pair as K2 does over every chunk, bit for bit;
    its walked stages equal the plain reckoning of the two bitmaps."""
    from repro_torch.kernels.apss_block import fused

    D = _zipf_law(1024, 32768, seed=10)
    Dp = torch.from_numpy(D).to(card, dtype)
    n, t = Dp.shape[0], 0.2
    ij = torch.tensor([[i, j] for i in range(8) for j in range(i, 8)],
                      dtype=torch.int32).T.contiguous().to(card)
    S2 = _dense_from_packets(
        fused.apss_tile_candidates_kernel(Dp, ij, t, n, block_m=128, block_n=128, n_valid=n),
        ij, n, 128, 128)
    x, y = Dp[256:512], Dp[128:]
    mask = torch.ones((2, 7), dtype=torch.int32)
    mask[1, 3] = 0  # a dead tile: not walked, not scored
    assert fused.fused_segments_for(x, y.shape[0], y.shape[0]) > 1
    v1, i1, c1 = fused.apss_fused_kernel(x, y, mask, t, y.shape[0], block_m=128, block_n=128,
                                         n_valid_cols=y.shape[0], row_offset=256,
                                         col_offset=128, exclude_self=True)
    walk = fused.last_walk()
    S1 = _scores_of(v1, i1, 256, n, card, row0=256)[256:512, 128:]
    want = S2[256:512, 128:].clone()
    want[128:, 384:512] = float("nan")
    live = ~torch.isnan(S1)
    assert torch.equal(live, ~torch.isnan(want))
    assert torch.equal(S1[live], want[live])
    assert torch.equal(live.sum(dim=1, dtype=torch.int32), c1[:, 0])
    assert int(c1.sum()) > 0
    assert walk == fused.fused_walk_plain(fused.fused_occupancy(x), fused.fused_occupancy(y),
                                          mask, block_m=128, block_n=128, m=Dp.shape[1])
    assert walk[1] == 13 * 1024 and walk[0] < 2 / 3 * walk[1]


def test_k1_telemetry_records_the_walk(card):
    """Under a telemetry log, ``apss_blocked``'s K1 record carries the
    stages K1 walked and those of the walk over every chunk, and scales its
    FLOPs by their ratio."""
    from repro_torch.core.apss import apss_blocked
    from repro_torch.kernels.apss_block import fused
    from repro_torch.planner import CommLog
    from repro_torch.planner import telemetry as tt

    D = torch.from_numpy(_zipf_law(1024, 32768, seed=11)).to(card)
    with CommLog() as log:
        got = apss_blocked(D, 0.2, 16, block_rows=128, use_kernel=True, device=card)
    rec = log.last
    walked, dense = fused.last_walk()
    assert rec.variant == "blocked/dense-kernel"
    assert rec.extra == {"k1_stages_walked": walked, "k1_stages_dense": dense}
    assert 0 < walked < 2 / 3 * dense
    assert rec.flops == pytest.approx(tt.dense_join_flops(1024, 1024, 32768) * walked / dense,
                                      rel=1e-12)
    assert int(got.counts.sum()) > 0


def test_k2_repeated_call_is_bit_identical(card):
    from repro_torch.kernels.apss_block import fused

    D = _corp(1000, 512, seed=9)
    Dp = torch.from_numpy(_pad(D, 256, 32)).to(card)
    ij = torch.tensor([[i, j] for i in range(4) for j in range(i, 4)],
                      dtype=torch.int32).T.contiguous().to(card)
    kw = dict(block_m=256, block_n=256, n_valid=1000)
    a = fused.apss_tile_candidates_kernel(Dp, ij, 0.2, 32, **kw)
    b = fused.apss_tile_candidates_kernel(Dp, ij, 0.2, 32, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a[2].sum()) > 0


def test_entry_points_on_card_match_plain_path(card):
    from repro_torch import apss_blocked, apss_fused_compacted

    D = _inputs(torch.float32, seed=17)
    ref = apss_blocked(D, 0.3, 16, use_kernel=False, device="cpu")
    for got in (
        apss_blocked(D, 0.3, 16, use_kernel=True),
        apss_fused_compacted(D, 0.3, 16),
    ):
        assert got.values.device.type == "cuda"
        _assert_close((got.values, got.indices, got.counts), ref)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.apss_block import fused

    D = torch.zeros((256, 128), device=card)
    mask = torch.ones((2, 2), dtype=torch.int32)
    D192 = torch.zeros((192, 128), device=card)
    with pytest.raises(ValueError, match="multiples"):
        fused.apss_fused_kernel(D192, D192, mask, 0.3, 8, block_m=96, block_n=96,
                                n_valid_cols=192)
    with pytest.raises(ValueError, match="contiguous"):
        fused.apss_fused_kernel(D.T, D.T, mask, 0.3, 8, block_m=128, block_n=128,
                                n_valid_cols=256)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused.apss_fused_kernel(D.half(), D.half(), mask, 0.3, 8, block_m=128,
                                block_n=128, n_valid_cols=256)
    with pytest.raises(ValueError, match="merge area"):  # past FUSED_MAX_K, never the plain path
        fused.apss_fused_kernel(D, D, mask, 0.3, fused.FUSED_MAX_K + 1, block_m=128,
                                block_n=128, n_valid_cols=256)
    with pytest.raises(ValueError, match="outside the corpus"):
        fused.apss_tile_candidates_kernel(
            D, torch.tensor([[0], [2]], dtype=torch.int32), 0.3, 8,
            block_m=128, block_n=128, n_valid=256,
        )
    with pytest.raises(ValueError, match="up to 256"):
        fused.apss_tile_candidates_kernel(
            torch.zeros((512, 128), device=card),
            torch.zeros((2, 1), dtype=torch.int32),
            0.3, 8, block_m=512, block_n=512, n_valid=512,
        )


def _k3_operands(card, dtype, bm, seed):
    """Support-compacted K3 operands of a clustered CSR corpus, as the main
    path builds them."""
    from repro_torch.core.pruning import sparse_block_prune_mask
    from repro_torch.core.sparse import pad_rows_sparse
    from repro_torch.data.sparse import sparse_clustered_corpus
    from repro_torch.kernels.apss_block import sparse
    from repro_torch.kernels.apss_block.ops import compact_worklist

    sp = sparse_clustered_corpus(3 * bm - 20, 2048, 24.0, n_clusters=2, seed=seed,
                                 device=card)
    spp = pad_rows_sparse(sp, bm)[0]
    mask, ub = sparse_block_prune_mask(spp, spp, 0.5, bm, return_ub=True)
    ij = torch.as_tensor(compact_worklist(mask, ub)).to(card)
    bdims, bx = sparse.block_support_gather(spp, bm)
    nb = spp.n // bm
    yg = sparse.gather_tiles(torch.from_numpy(bdims).to(card),
                             spp.indices.reshape(nb, bm, -1),
                             spp.values.reshape(nb, bm, -1), ij)
    bx = torch.from_numpy(bx).to(card)
    if dtype == torch.bfloat16:
        bx, yg = bx.bfloat16(), yg.bfloat16()
    return sp, bx.contiguous(), yg.contiguous(), ij


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [128, 256])
def test_k3_kernel_matches_plain(card, dtype, bm):
    from repro_torch.core.sparse import to_dense
    from repro_torch.kernels.apss_block import fused, sparse

    sp, bx, yg, ij = _k3_operands(card, dtype, bm, seed=3)
    D = to_dense(sp).cpu().numpy()
    if dtype == torch.bfloat16:  # the kernel sees the bf16 scores
        Db = torch.from_numpy(D).bfloat16().float().numpy()
        assert_clear_of_threshold(Db, Db, 0.5, exclude_self=True)
    else:
        assert_clear_of_threshold(D, D, 0.5, exclude_self=True)
    assert (ij[0] != ij[1]).any()  # mirror packets are exercised
    before = fused.LAUNCHES["sparse_tile_candidates"]
    got = sparse.sparse_tile_candidates_kernel(bx, yg, ij, 0.5, 16, n_valid=sp.n)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["sparse_tile_candidates"] == before + 1
    ref = sparse.sparse_tile_candidates_plain(bx, yg, ij, 0.5, 16, n_valid=sp.n)
    _assert_close(got, ref)
    assert int(ref[2].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_kernel_matches_plain_and_zeroes_dead_tiles(card, dtype):
    from repro_torch.kernels.apss_block import apss_block, fused

    D = _inputs(dtype, seed=17)
    x = torch.from_numpy(_pad(D, 128, 128)).to(card, dtype)
    y = torch.from_numpy(_pad(D[:256], 128, 128)).to(card, dtype)
    mask = torch.ones((3, 2), dtype=torch.int32)
    mask[0, 1] = mask[2, 0] = 0
    for t in (0.3, -0.5):  # at t < 0 a dead tile is still all zeros
        before = fused.LAUNCHES["apss_block"]
        got = apss_block.apss_block_kernel(x, y, mask, t, block_m=128, block_n=128)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["apss_block"] == before + 1
        ref = apss_block.apss_block_plain(x, y, t, block_mask=mask, block_m=128,
                                          block_n=128)
        _assert_close((got,), (ref,))
        g = got.cpu().numpy()
        assert not g[:128, 128:].any() and not g[256:, :128].any()
        np.testing.assert_array_equal(g != 0, ref.cpu().numpy() != 0)


def _k7_case(case, dtype, seed):
    """``(x, y, mask, t, block)`` of one K7 edge case: x and y unit rows
    (rounded to ``dtype`` and back), t < 0 or between two float64 scores near
    the 80th percentile that lie more than 3e-5 apart (none within 1e-5)."""
    if case == "mask64_under_tile":  # 64-entries of the mask inside one 128 x 256 tile
        nx, ny, m, block = 256, 512, 128, 64
    elif case == "negative_t_dead_tiles":
        nx, ny, m, block = 256, 512, 128, 64
    elif case == "ragged_m":  # 96 features: 3 f32 stages, 1.5 bf16 stages
        nx, ny, m, block = 192, 320, 96, 64
    else:  # non_square: a partial row tile (320 = 2.5 x 128), partial column tile
        nx, ny, m, block = 320, 448, 160, 64
    rng = np.random.default_rng(seed)
    mask = (rng.random((nx // block, ny // block)) < 0.6).astype(np.int32)
    mask[0, 0], mask[0, 1] = 1, 0
    x, y = (torch.from_numpy(_corp(n, m, seed=seed + i)).to(dtype).float().numpy()
            for i, n in ((1, nx), (2, ny)))
    t = -0.5
    if case != "negative_t_dead_tiles":
        sc = np.sort((x.astype(np.float64) @ y.astype(np.float64).T).ravel())
        gaps = np.flatnonzero(np.diff(sc) > 3e-5)
        i = gaps[np.argmin(np.abs(gaps - int(0.8 * sc.size)))]
        t = float(np.float32((sc[i] + sc[i + 1]) / 2))
    return x, y, mask, t, block


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "case", ["mask64_under_tile", "negative_t_dead_tiles", "ragged_m", "non_square"])
def test_k7_tensor_core_edges_match_plain(card, dtype, case):
    """K7's 128 x 256 tensor-core tiles against its plain version: mask
    entries of 64 under one tile (each score held to its own entry), dead
    entries all zero at t < 0, m a multiple of 32 but not of the 64-feature
    bf16 stage, and row and column counts that leave partial tiles."""
    from repro_torch.kernels.apss_block import apss_block, fused

    xn, yn, maskn, t, block = _k7_case(case, dtype, seed=31)
    assert_clear_of_threshold(xn, yn, t)
    x, y = torch.from_numpy(xn).to(card, dtype), torch.from_numpy(yn).to(card, dtype)
    mask = torch.from_numpy(maskn)
    before = fused.LAUNCHES["apss_block"]
    got = apss_block.apss_block_kernel(x, y, mask, t, block_m=block, block_n=block)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["apss_block"] == before + 1
    ref = apss_block.apss_block_plain(x, y, t, block_mask=mask, block_m=block, block_n=block)
    _assert_close((got,), (ref,))
    g = got.cpu().numpy()
    np.testing.assert_array_equal(g != 0, ref.cpu().numpy() != 0)
    dead = np.repeat(np.repeat(maskn == 0, block, 0), block, 1)
    assert not g[dead].any() and g[~dead].any()
    if t < 0:  # every live score passes t
        assert (g[~dead] != 0).all()


def test_k7_f32_within_2e6_of_float64(card):
    """The three-pass TF32 split on 1,024 rows at radikal's 155.8 nonzeros a
    row: every score within 2e-6 of the float64 product."""
    from repro_torch.data.synthetic import synthetic_corpus
    from repro_torch.kernels.apss_block import apss_block

    D = synthetic_corpus(1024, 16384, 1072472 / 6883, seed=3)
    x = torch.from_numpy(D).to(card)
    got = apss_block.apss_block_kernel(x, x, torch.ones((4, 4), dtype=torch.int32), -2.0)
    exact = D.astype(np.float64) @ D.astype(np.float64).T
    assert np.abs(got.cpu().numpy() - exact).max() <= 2e-6


def _full_support_case(dtype, bm, card, seed, m=2560):
    """Unit rows with every entry nonzero (so each row block's support is
    every feature), padded to whole blocks, and the worklist of all upper
    tiles."""
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((3 * bm - 20, m))).astype(np.float32) + 0.01
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    Dp = torch.from_numpy(_pad(D, bm, 32)).to(card, dtype)
    nb = Dp.shape[0] // bm
    ij = torch.tensor([[i, j] for i in range(nb) for j in range(i, nb)],
                      dtype=torch.int32).T.contiguous().to(card)
    t = float(torch.quantile((Dp[:512].float() @ Dp[:512].float().T).ravel(), 0.6))
    return D, Dp, ij, t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [128, 256])
def test_k3_bit_identical_to_k2_on_full_support(card, dtype, bm):
    """Where every row block's support is every feature, K3's operands are
    K2's row blocks (bx = D's blocks, yg[t] = block ij[1, t]) and both sum
    each score as one fmaf chain in feature order: the packets are equal
    bit for bit, mirrors and diagonal tiles included."""
    from repro_torch.kernels.apss_block import fused, sparse

    D, Dp, ij, t = _full_support_case(dtype, bm, card, seed=41)
    blocks = Dp.view(-1, bm, Dp.shape[1])
    yg = blocks[ij[1].long()].contiguous()
    kw = dict(n_valid=D.shape[0])
    before = fused.LAUNCHES["sparse_tile_candidates"]
    k3 = sparse.sparse_tile_candidates_kernel(blocks, yg, ij, t, 16, **kw)
    assert fused.LAUNCHES["sparse_tile_candidates"] == before + 1
    k2 = fused.apss_tile_candidates_kernel(Dp, ij, t, 16, block_m=bm, block_n=bm, **kw)
    for a, b in zip(k3, k2):
        assert torch.equal(a, b)
    assert int(k2[2].sum()) > 0 and int(k2[5].sum()) > 0


def test_k3_through_the_support_gather_bit_identical_to_k2(card):
    """The same through the sparse path's own operands: a CSR corpus with no
    zero entry (m = 2464), its block supports (every feature, padded to S =
    2560 with the sentinel's zero columns, which add +0) and gathered
    tiles."""
    from repro_torch.core.sparse import from_dense, pad_rows_sparse
    from repro_torch.kernels.apss_block import fused, sparse

    D, Dp, ij, t = _full_support_case(torch.float32, 256, card, seed=42, m=2464)
    spp = pad_rows_sparse(from_dense(D, device=card), 256)[0]
    bdims, bx = sparse.block_support_gather(spp, 256)
    nb = spp.n // 256
    yg = sparse.gather_tiles(torch.from_numpy(bdims).to(card), spp.indices.reshape(nb, 256, -1),
                             spp.values.reshape(nb, 256, -1), ij)
    bx = torch.from_numpy(bx).to(card)
    assert bx.shape[2] == 2560 and (bdims[:, :2464] == np.arange(2464)).all()
    k3 = sparse.sparse_tile_candidates_kernel(bx, yg, ij, t, 16, n_valid=D.shape[0])
    k2 = fused.apss_tile_candidates_kernel(Dp, ij, t, 16, block_m=256, block_n=256,
                                           n_valid=D.shape[0])
    for a, b in zip(k3, k2):
        assert torch.equal(a, b)
    assert int(k2[2].sum()) > 0


def test_sparse_entry_points_on_card_match_plain_path(card):
    from repro_torch import apss_block_matmul, apss_blocked, from_dense

    D = _inputs(torch.float32, seed=17)
    sp = from_dense(D)
    ref = apss_blocked(D, 0.3, 16, use_kernel=False, device="cpu")
    got = apss_blocked(sp, 0.3, 16, use_kernel=True)
    assert got.values.device.type == "cuda"
    _assert_close((got.values, got.indices, got.counts), ref)
    plain = apss_blocked(sp, 0.3, 16, use_kernel=False)
    _assert_close((plain.values, plain.indices, plain.counts), ref)
    S = apss_block_matmul(D, D, 0.3)
    want = apss_block_matmul(D, D, 0.3, device="cpu")
    _assert_close((S,), (want,))


def test_k3_k7_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.apss_block import apss_block, sparse

    bx = torch.zeros((2, 128, 256), device=card)
    yg = torch.zeros((1, 128, 256), device=card)
    ij = torch.tensor([[0], [1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 64"):
        sparse.sparse_tile_candidates_kernel(
            torch.zeros((2, 96, 256), device=card), torch.zeros((1, 96, 256), device=card),
            ij, 0.3, 8, n_valid=192)
    with pytest.raises(ValueError, match="multiple of 32"):
        sparse.sparse_tile_candidates_kernel(
            torch.zeros((2, 128, 200), device=card), torch.zeros((1, 128, 200), device=card),
            ij, 0.3, 8, n_valid=256)
    with pytest.raises(ValueError, match="share device and dtype"):
        sparse.sparse_tile_candidates_kernel(bx, yg.bfloat16(), ij, 0.3, 8, n_valid=256)
    with pytest.raises(ValueError, match="yg shape"):
        sparse.sparse_tile_candidates_kernel(bx, torch.zeros((2, 128, 256), device=card),
                                             ij, 0.3, 8, n_valid=256)
    with pytest.raises(ValueError, match="outside the corpus"):
        sparse.sparse_tile_candidates_kernel(bx, yg, torch.tensor([[0], [2]]), 0.3, 8,
                                             n_valid=256)
    with pytest.raises(ValueError, match="contiguous 3-D"):
        sparse.sparse_tile_candidates_kernel(bx.transpose(1, 2), yg, ij, 0.3, 8,
                                             n_valid=256)
    x = torch.zeros((256, 128), device=card)
    with pytest.raises(ValueError, match="multiples"):
        apss_block.apss_block_kernel(x, x[:192].contiguous(),
                                     torch.ones((1, 2), dtype=torch.int32), 0.3,
                                     block_m=256, block_n=96)
    with pytest.raises(ValueError, match="multiples"):
        apss_block.apss_block_kernel(x[:, :100].contiguous(), x[:, :100].contiguous(),
                                     torch.ones((2, 2), dtype=torch.int32), 0.3,
                                     block_m=128, block_n=128)
    with pytest.raises(ValueError, match="not the grid"):
        apss_block.apss_block_kernel(x, x, torch.ones((1, 1), dtype=torch.int32), 0.3,
                                     block_m=128, block_n=128)


# -- serving: K4, K5, K6 -------------------------------------------------------


def _rounded(a, dtype):
    return torch.from_numpy(a).to(dtype).float().numpy()


def _rect_inputs(dtype, nq, seed, t=0.3, c_dtype=None):
    """Queries and a 512-row corpus of width 256, both clear of t in the
    dtypes the kernel reads (the corpus in ``c_dtype``, default ``dtype``)."""
    C = _rounded(_corp(500, 230, seed=seed), c_dtype or dtype)
    Q = _rounded(_corp(nq, 230, seed=seed + 100), dtype)
    assert_clear_of_threshold(Q, C, t)
    return _pad(Q, 128, 256), _pad(C, 256, 256)


# (query dtype, corpus dtype): K4 and K5 take each operand in either type.
PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
# The seed of K4's inputs per pair: the first from 11 whose float64 scores
# all lie more than 1e-5 from t in that pair's rounding.
PAIR_SEED = {PAIRS[0]: 11, PAIRS[1]: 11, PAIRS[2]: 12, PAIRS[3]: 13}


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}".replace("torch.", ""))
@pytest.mark.parametrize("block_c", [64, 128, 256])
@pytest.mark.parametrize("block_q", [8, 16, 24, 64, 128])
def test_k4_kernel_matches_plain(card, pair, block_q, block_c):
    from repro_torch.kernels.apss_block import fused

    qd, cd = pair
    Qn, Cn = _rect_inputs(qd, 100, seed=PAIR_SEED[pair], c_dtype=cd)
    Qn = _pad(Qn[:100], block_q, 256)  # whole query blocks (block_q 24: 120 rows)
    Q = torch.from_numpy(Qn).to(card, qd)
    C = torch.from_numpy(Cn).to(card, cd)
    gq, gc = Q.shape[0] // block_q, C.shape[0] // block_c
    qi, cj = torch.meshgrid(torch.arange(gq), torch.arange(gc), indexing="ij")
    ij = torch.stack([qi.flatten(), cj.flatten()]).int()
    kw = dict(block_q=block_q, block_c=block_c, nc_valid=500)
    for wl in (ij, torch.cat([ij, ij[1:2] + 1])):  # (2, T) and (3, T)
        before = fused.LAUNCHES["rect_tile_candidates"]
        got = fused.rect_tile_candidates_kernel(Q, C, wl, 0.3, 16, **kw)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["rect_tile_candidates"] == before + 1
        ref = fused.rect_tile_candidates_plain(Q, C, wl, 0.3, 16, **kw)
        _assert_close(got, ref)
        assert int(ref[2].sum()) > 0


def test_k5_kernel_matches_plain_with_padding(card):
    """Worklist padding entries (ub = NEG_LARGE) are skipped, padded query
    rows never pin a block, and the kernel's packets and skips equal the
    plain version's."""
    from repro_torch.kernels.apss_block import fused
    from repro_torch.serving import build_index
    from repro_torch.serving.query import _query_mask
    from repro_torch.kernels.apss_block.ops import compact_rect_worklist

    Qn, Cn = _rect_inputs(torch.float32, 100, seed=28)
    index = build_index(Cn[:500], block_rows=64, normalize=False)
    Q = torch.from_numpy(Qn).to(card)
    for block_q, nq_valid in ((64, 100), (128, 100), (8, 5)):
        Qp = Q[: -(-nq_valid // block_q) * block_q].contiguous()
        mask, ub = _query_mask(Qp, index.stats, threshold=0.3, block_q=block_q,
                               use_minsize=True, normalized=True)
        wl = compact_rect_worklist(mask, ub)
        ubw = ub.cpu().numpy()[wl[0], wl[1]]
        ij = torch.from_numpy(np.concatenate([wl, np.zeros((2, 2), np.int32)], 1))
        ubw = torch.from_numpy(np.concatenate([ubw, [fused.NEG_LARGE] * 2]).astype(np.float32))
        kw = dict(block_q=block_q, block_c=64, nc_valid=500, nq_valid=nq_valid)
        before = fused.LAUNCHES["rect_tile_candidates_ee"]
        got = fused.rect_tile_candidates_early_exit_kernel(Qp, index.corpus, ij, ubw, 0.3, 8, **kw)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["rect_tile_candidates_ee"] == before + 1
        ref = fused.rect_tile_candidates_early_exit_plain(Qp, index.corpus, ij, ubw, 0.3, 8, **kw)
        _assert_close(got, ref)
        assert got[3][-2:].tolist() == [[1], [1]]


def _k5_case(dtype, m, block_q, block_c, *, grid_q=3, nc_blocks=4, seed=0, c_dtype=None):
    """Queries (rounded to ``dtype``) and a corpus (to ``c_dtype``, default
    ``dtype``) whose blocks are scaled by 1, 1/2, 1/4, 1/8, the (2, T)
    worklist of every tile ordered by its bound descending (query blocks
    interleaved), the bounds (each tile's largest score plus 0.1 %) and the
    count of valid query rows (the last block has three)."""
    rng = np.random.default_rng(seed)
    Q = np.abs(rng.standard_normal((grid_q * block_q, m))).astype(np.float32)
    C = np.abs(rng.standard_normal((nc_blocks * block_c, m))).astype(np.float32)
    C *= (0.5 ** np.repeat(np.arange(nc_blocks), block_c)).astype(np.float32)[:, None]
    nq_valid = (grid_q - 1) * block_q + 3
    Q[nq_valid:] = 0
    Q, C = _rounded(Q, dtype), _rounded(C, c_dtype or dtype)
    S = (Q.astype(np.float64) @ C.astype(np.float64).T).reshape(
        grid_q, block_q, nc_blocks, block_c)
    tmax = S.max(axis=(1, 3)).ravel() * 1.001
    order = np.argsort(-tmax, kind="stable")
    ij = np.stack([order // nc_blocks, order % nc_blocks]).astype(np.int32)
    return Q, C, ij, tmax[order].astype(np.float32), nq_valid


def _fold(ij, p, *, grid_q, block_q, k):
    from repro_torch.kernels.apss_block.ops import fold_rect_packets

    ones = torch.ones(ij.shape[1], dtype=torch.bool)
    return fold_rect_packets(ij, ones, p[0], p[1], p[2][..., 0], grid_q=grid_q,
                             block_q=block_q, k=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [64, 2560])  # one short chunk; 2.5 chunks of FK, the last ragged
@pytest.mark.parametrize("block_c", [64, 256])
@pytest.mark.parametrize("block_q", [8, 64, 128])
def test_k5_bit_identical_to_k4_fold(card, dtype, m, block_c, block_q):
    """K5's packets fold to K4's values and ids bit for bit on the valid rows,
    counts saturated at k, and its skip flags equal the plain version's,
    over three interleaved query blocks, k = 1, 8 and 256."""
    from repro_torch.kernels.apss_block import fused

    Qn, Cn, wl, ubn, nq_valid = _k5_case(dtype, m, block_q, block_c)
    Q = torch.from_numpy(Qn).to(card, dtype)
    C = torch.from_numpy(Cn).to(card, dtype)
    ij, ub = torch.from_numpy(wl).to(card), torch.from_numpy(ubn).to(card)
    kw = dict(block_q=block_q, block_c=block_c, nc_valid=C.shape[0])
    t = float(np.float32(0.25 * np.median(ubn)))
    skipped_any = False
    for k in (1, 8, 256):
        fold = dict(grid_q=3, block_q=block_q, k=k)
        before = fused.LAUNCHES["rect_tile_candidates_ee"]
        ee = fused.rect_tile_candidates_early_exit_kernel(Q, C, ij, ub, t, k,
                                                          nq_valid=nq_valid, **kw)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["rect_tile_candidates_ee"] == before + 1
        full = fused.rect_tile_candidates_kernel(Q, C, ij, t, k, **kw)
        plain = fused.rect_tile_candidates_early_exit_plain(Q, C, ij, ub, t, k,
                                                            nq_valid=nq_valid, **kw)
        got, want = _fold(ij, ee[:3], **fold), _fold(ij, full, **fold)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a[:nq_valid], b[:nq_valid])
        assert torch.equal(got[2][:nq_valid].clamp_max(k), want[2][:nq_valid].clamp_max(k))
        assert torch.equal(ee[3].cpu(), plain[3].cpu())
        scored = ee[3][:, 0] == 0
        for a, b in zip(ee[:3], full):  # a scored tile's packet is K4's
            assert torch.equal(a[scored], b[scored])
        skipped_any |= bool((~scored).any())
    assert skipped_any  # k = 1: every row holds its block-0 maximum above the later bounds


def test_k5_single_tile_padding_worklist_and_grid(card):
    """T = 1 gives K4's packet; a worklist of padding entries only is all
    skipped and neutral; on radikal's serving shape the grid covers every
    SM."""
    from repro_torch.kernels.apss_block import fused

    Qn, Cn, wl, ubn, _ = _k5_case(torch.float32, 2560, 64, 256)
    Q, C = torch.from_numpy(Qn).to(card), torch.from_numpy(Cn).to(card)
    kw = dict(block_q=64, block_c=256, nc_valid=C.shape[0])
    one = torch.tensor([[1], [0]], dtype=torch.int32)
    ee = fused.rect_tile_candidates_early_exit_kernel(Q, C, one, torch.tensor([1e30]), 0.0, 8,
                                                      nq_valid=150, **kw)
    full = fused.rect_tile_candidates_kernel(Q, C, one, 0.0, 8, **kw)
    assert ee[3].tolist() == [[0]]
    for a, b in zip(ee[:3], full):
        assert torch.equal(a, b)
    ij = torch.from_numpy(wl)
    pad = torch.full((ij.shape[1],), fused.NEG_LARGE)
    fv, fi, fc, sk = fused.rect_tile_candidates_early_exit_kernel(Q, C, ij, pad, 0.0, 8,
                                                                  nq_valid=150, **kw)
    assert bool((sk == 1).all()) and bool((fi == -1).all()) and bool((fc == 0).all())
    assert bool((fv == fused.NEG_LARGE).all())
    wide = torch.empty((64, 136704), device=card)
    split = fused.ee_split_for(wide, wide, block_q=64, block_c=256, k=32)
    assert split.n_chunks == 134
    assert split.grid >= torch.cuda.get_device_properties(0).multi_processor_count


def test_k5_tie_probe_on_card(card):
    """The strict skip test: a tile whose bound equals every row's k-th value
    exactly is scored, so the lower ids of the tie win, as in K4 + fold."""
    from repro_torch.serving import build_index, query, query_topk

    k = 4
    C = np.zeros((128, 64), np.float32)
    C[0:k, 3] = C[64:64 + k, 3] = 1.0
    C[k:2 * k, 17] = C[64 + k:64 + 2 * k, 17] = 1.0
    C[64 + 2 * k, [3, 17]] = np.float32(1 / np.sqrt(2))
    Q = np.zeros((2, 64), np.float32)
    Q[0, 3] = Q[1, 17] = 1.0
    index = build_index(C, block_rows=64, normalize=False)
    full = query_topk(index, Q, 0.5, k, block_q=8, use_kernel=True)
    query.TILES.update(total=0, live=0, scored=0)
    ee = query_topk(index, Q, 0.5, k, block_q=8, use_kernel=True, early_exit=True)
    assert full.indices.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert torch.equal(ee.indices, full.indices) and torch.equal(ee.values, full.values)
    assert query.TILES["scored"] == 2


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}".replace("torch.", ""))
@pytest.mark.parametrize("block_c", [64, 128, 256])
@pytest.mark.parametrize("block_q", [8, 16, 24, 64, 128])
def test_k4_bit_identical_to_k5_without_skips(card, pair, block_q, block_c):
    """K4's two-phase packets equal K5's bit for bit when K5's bounds never
    let it skip, at a width of 2.5 FK chunks (the last ragged), and a (3, T)
    worklist gives K4's packets the ids of its last row."""
    from repro_torch.kernels.apss_block import fused

    qd, cd = pair
    Qn, Cn, wl, _, nq_valid = _k5_case(qd, 2560, block_q, block_c, c_dtype=cd)
    Q = torch.from_numpy(Qn).to(card, qd)
    C = torch.from_numpy(Cn).to(card, cd)
    ij = torch.from_numpy(wl).to(card)
    never = torch.full((ij.shape[1],), 1e30, device=card)
    t = float(np.float32(0.5 * float((Q.float() @ C.float().T).median())))
    kw = dict(block_q=block_q, block_c=block_c, nc_valid=C.shape[0] - 5)
    k4 = fused.rect_tile_candidates_kernel(Q, C, ij, t, 8, **kw)
    k5 = fused.rect_tile_candidates_early_exit_kernel(Q, C, ij, never, t, 8,
                                                      nq_valid=nq_valid, **kw)
    assert (k5[3] == 0).all()
    for a, b in zip(k4, k5[:3]):
        assert torch.equal(a, b)
    assert int(k4[2].sum()) > 0
    ij3 = torch.cat([ij, ij[1:2] + 2])  # the packet ids come from the last row
    wide = dict(kw, nc_valid=10**6)
    k42 = fused.rect_tile_candidates_kernel(Q, C, ij, t, 8, **wide)
    k43 = fused.rect_tile_candidates_kernel(Q, C, ij3, t, 8, **wide)
    assert torch.equal(k43[0], k42[0]) and torch.equal(k43[2], k42[2])
    assert torch.equal(k43[1], torch.where(k42[1] >= 0, k42[1] + 2 * block_c, -1))


def test_k5_mixed_dtypes_match_plain(card):
    """K5 on f32 queries against a bf16 index (the pair F1 serves), with
    the bounds query_topk computes, against its plain version: packets and
    skip flags."""
    from repro_torch.kernels.apss_block import fused
    from repro_torch.kernels.apss_block.ops import compact_rect_worklist
    from repro_torch.serving import build_index
    from repro_torch.serving.query import _query_mask

    pair = (torch.float32, torch.bfloat16)
    Qn, Cn = _rect_inputs(pair[0], 100, seed=PAIR_SEED[pair], c_dtype=pair[1])
    index = build_index(torch.from_numpy(Cn[:500]).to(card, torch.bfloat16), block_rows=64,
                        normalize=False)
    Q = torch.from_numpy(Qn).to(card)
    for block_q, k in ((64, 8), (8, 1)):
        Qp = Q[: -(-100 // block_q) * block_q].contiguous()
        mask, ub = _query_mask(Qp, index.stats, threshold=0.3, block_q=block_q,
                               use_minsize=True, normalized=True)
        wl = compact_rect_worklist(mask, ub)
        ij = torch.from_numpy(wl).to(card)
        ubw = torch.from_numpy(ub.cpu().numpy()[wl[0], wl[1]].astype(np.float32)).to(card)
        kw = dict(block_q=block_q, block_c=64, nc_valid=500, nq_valid=100)
        got = fused.rect_tile_candidates_early_exit_kernel(Qp, index.corpus, ij, ubw, 0.3, k,
                                                           **kw)
        want = fused.rect_tile_candidates_early_exit_plain(Qp, index.corpus, ij, ubw, 0.3, k,
                                                           **kw)
        assert torch.equal(got[3].cpu(), want[3].cpu())
        _assert_close(got[:3], want[:3])


@pytest.mark.parametrize("block_q", [8, 64])
def test_k6_kernel_matches_plain(card, block_q):
    from repro_torch.core.sparse import from_dense
    from repro_torch.kernels.apss_block import fused, sparse
    from repro_torch.serving import build_index

    Qn, Cn = _rect_inputs(torch.float32, 60, seed=7)
    index = build_index(from_dense(Cn[:500]), block_rows=256, normalize=False)
    Qp = torch.from_numpy(Qn[: -(-60 // block_q) * block_q]).to(card)
    gq = Qp.shape[0] // block_q
    qi, cj = torch.meshgrid(torch.arange(gq), torch.arange(2), indexing="ij")
    ij = torch.stack([qi.flatten(), cj.flatten()]).int().to(card)
    qg = sparse.gather_query_tiles(Qp, index.bdims, ij, block_q)
    before = fused.LAUNCHES["rect_sparse_tile_candidates"]
    got = sparse.rect_sparse_tile_candidates_kernel(qg, index.bx, ij, 0.3, 16, nc_valid=500)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rect_sparse_tile_candidates"] == before + 1
    ref = sparse.rect_sparse_tile_candidates_plain(qg, index.bx, ij, 0.3, 16, nc_valid=500)
    _assert_close(got, ref)
    assert int(ref[2].sum()) > 0


def _k6_case(block_q, block_c, S, *, T=5, nb=3, seed=0):
    """Gathered query blocks ``qg (T, block_q, S)`` and corpus blocks ``bx
    (nb, block_c, S)`` with unit rows (30 % nonzero), a (2, T) worklist
    over them, and a threshold between two float64 scores near the median
    that lie more than 1e-5 apart from each other (none within 1e-5 of it)."""
    rng = np.random.default_rng(seed)

    def unit(shape):
        x = np.abs(rng.standard_normal(shape)) * (rng.random(shape) < 0.3)
        return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)).astype(
            np.float32)

    qg, bx = unit((T, block_q, S)), unit((nb, block_c, S))
    ij = np.stack([np.arange(T) // nb, np.arange(T) % nb]).astype(np.int32)
    s = np.sort(np.einsum("tqs,tcs->tqc", qg.astype(np.float64),
                          bx[ij[1]].astype(np.float64)).ravel())
    gaps = np.flatnonzero(np.diff(s) > 3e-5)
    i = gaps[np.argmin(np.abs(gaps - s.size // 2))]
    return qg, bx, ij, float(np.float32((s[i] + s[i + 1]) / 2))


@pytest.mark.parametrize("S", [256, 1024, 2560])  # below one FK chunk, one, 2.5 (ragged)
@pytest.mark.parametrize("block_c", [64, 128, 256])
@pytest.mark.parametrize("block_q", [8, 16, 64, 128])
def test_k6_work_items_match_plain(card, block_q, block_c, S):
    """K6's work items and selection pass against its plain version at every
    strip shape, over support widths of one short, one whole and 2.5 FK
    chunks, with padded corpus rows past nc_valid; k = 256 keeps every
    candidate of a row."""
    from repro_torch.kernels.apss_block import fused, sparse

    qgn, bxn, ijn, t = _k6_case(block_q, block_c, S)
    qg, bx = torch.from_numpy(qgn).to(card), torch.from_numpy(bxn).to(card)
    ij = torch.from_numpy(ijn).to(card)
    kw = dict(nc_valid=3 * block_c - 5)
    before = fused.LAUNCHES["rect_sparse_tile_candidates"]
    got = sparse.rect_sparse_tile_candidates_kernel(qg, bx, ij, t, 256, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rect_sparse_tile_candidates"] == before + 1
    ref = sparse.rect_sparse_tile_candidates_plain(qg, bx, ij, t, 256, **kw)
    _assert_same_candidates(got, ref)
    assert int(ref[2].sum()) > 0


def _assert_same_candidates(got, ref):
    """Packets that keep every candidate (k >= block_c) hold the same ids per
    row and, id by id, values within 1e-5; counts equal. Their order may
    differ where two values lie within f32 noise of each other (wide
    supports give many such near ties)."""
    (gv, gi, gc), (rv, ri, rc) = ([a.cpu().numpy() for a in p] for p in (got, ref))
    np.testing.assert_array_equal(gc, rc)
    go, ro = np.argsort(gi, axis=-1, kind="stable"), np.argsort(ri, axis=-1, kind="stable")
    np.testing.assert_array_equal(np.take_along_axis(gi, go, -1), np.take_along_axis(ri, ro, -1))
    np.testing.assert_allclose(np.take_along_axis(gv, go, -1), np.take_along_axis(rv, ro, -1),
                               atol=TOL, rtol=0)


def test_k6_one_tile_and_forced_passes_are_bit_identical(card, monkeypatch):
    """A one-tile worklist (the sparse early-exit scan's call) gives that
    tile's packet of the whole worklist's call bit for bit, and so does a
    scratch budget that forces a pass per two tiles."""
    from repro_torch.kernels.apss_block import fused, sparse

    qgn, bxn, ijn, t = _k6_case(64, 256, 2560, T=7)
    qg, bx = torch.from_numpy(qgn).to(card), torch.from_numpy(bxn).to(card)
    ij = torch.from_numpy(ijn).to(card)
    full = sparse.rect_sparse_tile_candidates_kernel(qg, bx, ij, t, 8, nc_valid=768)
    for e in (0, 3, 6):
        one = sparse.rect_sparse_tile_candidates_kernel(qg[e:e + 1].contiguous(), bx,
                                                        ij[:, e:e + 1], t, 8, nc_valid=768)
        for a, b in zip(one, full):
            assert torch.equal(a[0], b[e])
    budget = 2 * 4 * 3 * 64 * 256  # two tiles of three chunks
    assert fused.rect_work_split(7, 2560, 64, 256, budget).pass_tiles == 2
    monkeypatch.setattr(sparse, "RECT_SCRATCH_BYTES", budget)
    before = fused.LAUNCHES["rect_sparse_tile_candidates"]
    passes = sparse.rect_sparse_tile_candidates_kernel(qg, bx, ij, t, 8, nc_valid=768)
    assert fused.LAUNCHES["rect_sparse_tile_candidates"] == before + 1
    for a, b in zip(passes, full):
        assert torch.equal(a, b)
    assert int(full[2].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_c", [64, 256])
@pytest.mark.parametrize("block_q", [8, 64, 128])
def test_k6_bit_identical_to_k4_on_full_support(card, dtype, block_q, block_c):
    """On a corpus whose blocks span every feature, K6's packets are K4's bit
    for bit: the query blocks of the worklist gathered per entry and the
    corpus blocks as they are (support arange(m)), 2.5 FK chunks wide."""
    from repro_torch.kernels.apss_block import fused, sparse

    Qn, Cn, wl, _, _ = _k5_case(dtype, 2560, block_q, block_c)
    Q = torch.from_numpy(Qn).to(card, dtype)
    C = torch.from_numpy(Cn).to(card, dtype)
    ij = torch.from_numpy(wl).to(card)
    t = float(np.float32(0.5 * float((Q.float() @ C.float().T).median())))
    nc = C.shape[0] - 5
    qg = Q.view(-1, block_q, 2560)[ij[0].long()].contiguous()
    k6 = sparse.rect_sparse_tile_candidates_kernel(qg, C.view(-1, block_c, 2560), ij, t, 8,
                                                   nc_valid=nc)
    k4 = fused.rect_tile_candidates_kernel(Q, C, ij, t, 8, block_q=block_q, block_c=block_c,
                                           nc_valid=nc)
    for a, b in zip(k6, k4):
        assert torch.equal(a, b)
    assert int(k4[2].sum()) > 0


def test_k6_through_the_index_bit_identical_to_k4(card):
    """The same through a sparse index of a corpus with no zero entry: each
    block's support is arange(m) padded with the sentinel to S = 2560 > m =
    2464, whose zero columns add nothing, so K6's packets on the gathered
    queries equal K4's on the dense corpus bit for bit."""
    from repro_torch.core.sparse import from_dense
    from repro_torch.kernels.apss_block import fused, sparse
    from repro_torch.serving import build_index

    Qn, Cn, wl, _, _ = _k5_case(torch.float32, 2464, 64, 256)
    index = build_index(from_dense(Cn), block_rows=256, normalize=False)
    Q = torch.from_numpy(Qn).to(card)
    ij = torch.from_numpy(wl).to(card)
    assert index.bdims.shape[1] == 2560 and index.bx.shape == (4, 256, 2560)
    t = float(np.float32(0.5 * float((Q @ torch.from_numpy(Cn).to(card).T).median())))
    qg = sparse.gather_query_tiles(Q, index.bdims, ij, 64)
    k6 = sparse.rect_sparse_tile_candidates_kernel(qg, index.bx, ij, t, 8, nc_valid=1000)
    k4 = fused.rect_tile_candidates_kernel(Q, torch.from_numpy(Cn).to(card), ij, t, 8,
                                           block_q=64, block_c=256, nc_valid=1000)
    for a, b in zip(k6, k4):
        assert torch.equal(a, b)
    assert int(k4[2].sum()) > 0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_query_topk_on_card_matches_plain_path(card, kind):
    from repro_torch.core.sparse import from_dense
    from repro_torch.serving import build_index, query_topk

    Qn, Cn = _rect_inputs(torch.float32, 40, seed=8)
    C, Q = Cn[:500, :230], Qn[:40, :230]
    cpu = build_index(C if kind == "dense" else from_dense(C, device="cpu"), block_rows=64,
                      normalize=False, device="cpu")
    gpu = build_index(C if kind == "dense" else from_dense(C), block_rows=64, normalize=False)
    ref = query_topk(cpu, Q, 0.3, 16, block_q=64)
    for early_exit in (False, True):
        got = query_topk(gpu, Q, 0.3, 16, block_q=64, use_kernel=True, early_exit=early_exit)
        assert got.values.device.type == "cuda"
        counts = ref.counts.clamp_max(16) if early_exit else ref.counts
        _assert_close((got.values, got.indices, got.counts), (ref.values, ref.indices, counts))


def test_sharded_k4_bit_identical_to_unsharded(card):
    """K4 per shard at p = 4 on one card: 900 rows pad to 960 unsharded and
    to 1,024 in 4 shards of 4 blocks of 64, so block 15 is all padding,
    pruned, and shard 3 scores one tile fewer. One launch per shard, global
    ids, and the merged result equal to the unsharded K4's bit for bit."""
    from repro_torch.kernels.apss_block import fused
    from repro_torch.serving import build_index, query_topk
    from repro_torch.serving import query as tquery

    C, Q = _corp(900, 300, seed=51), _corp(40, 300, seed=52)
    assert_clear_of_threshold(Q, C, 0.3)
    flat = build_index(C, block_rows=64, normalize=False)
    sharded = build_index(C, block_rows=64, normalize=False, devices=[card] * 4)
    assert (flat.n_padded, sharded.n_padded, sharded.nb_local) == (960, 1024, 4)
    assert float(sharded.stats.mw[15]) == 0.0
    kw = dict(block_q=64, use_kernel=True)
    tquery.TILES.update(total=0, live=0, scored=0)
    ref = query_topk(flat, Q, 0.3, 16, **kw)
    flat_tiles = dict(tquery.TILES)
    tquery.TILES.update(total=0, live=0, scored=0)
    before = fused.LAUNCHES["rect_tile_candidates"]
    got = query_topk(sharded, Q, 0.3, 16, **kw)
    assert fused.LAUNCHES["rect_tile_candidates"] - before == 4
    assert tquery.TILES["live"] == flat_tiles["live"] == 15 and tquery.TILES["total"] == 16
    assert got.values.device.type == "cuda"
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got.counts.sum()) > 0 and int(got.indices.max()) >= 3 * 256
    plain = query_topk(sharded, Q, 0.3, 16, block_q=64)
    _assert_close((got.values, got.indices, got.counts),
                  (plain.values, plain.indices, plain.counts))


def test_server_raises_when_a_kernel_refuses_its_operands(card):
    """The degradation ladder does not hide a kernel fault: a batch width K4
    does not take (block_q 12) raises instead of falling to the plain tier."""
    from repro_torch.kernels.apss_block import fused
    from repro_torch.serving import RetrievalServer, build_index

    D = _corp(200, 96, seed=41)
    index = build_index(D, block_rows=64, normalize=False)
    kw = dict(threshold=0.3, k=8, use_kernel=True, cache_size=0)
    good = RetrievalServer(index, max_batch=8, **kw)
    before = fused.LAUNCHES["rect_tile_candidates"]
    assert good.result(good.submit(D[0])).status == "ok"
    assert fused.LAUNCHES["rect_tile_candidates"] == before + 1
    assert good.stats.degraded == good.stats.retries == 0
    bad = RetrievalServer(index, max_batch=12, **kw)
    with pytest.raises(ValueError, match="multiple of 8"):
        bad.result(bad.submit(D[0]))
    assert bad.stats.degraded == bad.stats.retries == 0


def test_rect_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.apss_block import fused, sparse

    Q = torch.zeros((64, 128), device=card)
    C = torch.zeros((256, 128), device=card)
    ij = torch.tensor([[0], [0]], dtype=torch.int32)
    kw = dict(block_q=64, block_c=256, nc_valid=256)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused.rect_tile_candidates_kernel(Q[:60].contiguous(), C, ij, 0.3, 8, block_q=12,
                                          block_c=256, nc_valid=256)
    with pytest.raises(ValueError, match="block_c 64, 128 or 256"):
        fused.rect_tile_candidates_kernel(Q, C[:192].contiguous(), ij, 0.3, 8, block_q=64,
                                          block_c=96, nc_valid=192)
    with pytest.raises(ValueError, match="contiguous"):
        fused.rect_tile_candidates_kernel(Q.T, C, ij, 0.3, 8, **kw)
    with pytest.raises(ValueError, match="share device and width"):
        fused.rect_tile_candidates_kernel(Q[:, :96].contiguous(), C, ij, 0.3, 8, **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused.rect_tile_candidates_kernel(Q.half(), C, ij, 0.3, 8, **kw)
    with pytest.raises(ValueError, match="outside"):
        fused.rect_tile_candidates_kernel(Q, C, torch.tensor([[0], [1]]), 0.3, 8, **kw)
    with pytest.raises(ValueError, match="worklist"):
        fused.rect_tile_candidates_kernel(Q, C, torch.zeros((4, 1), dtype=torch.int32), 0.3,
                                          8, **kw)
    ub = torch.zeros(1)
    with pytest.raises(ValueError, match="values buffer"):
        fused.rect_tile_candidates_early_exit_kernel(Q, C, ij, ub, 0.3, 300, nq_valid=64, **kw)
    # 128 x (256 + 256) f32 once exceeded a block's shared memory; the tile
    # now lives in device scratch, so K5 takes it.
    got = fused.rect_tile_candidates_early_exit_kernel(
        torch.zeros((128, 128), device=card), C, ij, ub, 0.3, 256, nq_valid=128,
        block_q=128, block_c=256, nc_valid=256)
    assert tuple(got[0].shape) == (1, 128, 256) and got[3].tolist() == [[0]]
    with pytest.raises(ValueError, match="ub shape"):
        fused.rect_tile_candidates_early_exit_kernel(Q, C, ij, torch.zeros(2), 0.3, 8,
                                                     nq_valid=64, **kw)
    with pytest.raises(ValueError, match="worklist"):  # K5 takes no (3, T) worklist
        fused.rect_tile_candidates_early_exit_kernel(
            Q, C, torch.zeros((3, 1), dtype=torch.int32), ub, 0.3, 8, nq_valid=64, **kw)
    bx = torch.zeros((2, 256, 128), device=card)
    qg = torch.zeros((1, 64, 128), device=card)
    with pytest.raises(ValueError, match="support width"):
        sparse.rect_sparse_tile_candidates_kernel(torch.zeros((1, 64, 96), device=card), bx,
                                                  ij, 0.3, 8, nc_valid=512)
    with pytest.raises(ValueError, match="tiles but ij"):
        sparse.rect_sparse_tile_candidates_kernel(qg, bx, torch.zeros((2, 2), dtype=torch.int32),
                                                  0.3, 8, nc_valid=512)
    with pytest.raises(ValueError, match="outside"):
        sparse.rect_sparse_tile_candidates_kernel(qg, bx, torch.tensor([[0], [2]]), 0.3, 8,
                                                  nc_valid=512)


# -- K4's masked entry: the live index's delta joins -----------------------------


def _masks(nq, nc, seed):
    """col_live with dead columns and padding rows; qpos naming each of the
    first query rows' own corpus positions (the rest -1)."""
    rng = np.random.default_rng(seed)
    col_live = rng.random(nc) > 0.1
    col_live[500:] = False
    qpos = np.full(nq, -1, np.int32)
    qpos[: nq // 2] = rng.choice(500, nq // 2, replace=False)
    return torch.from_numpy(col_live), torch.from_numpy(qpos)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block_c", [64, 128, 256])
@pytest.mark.parametrize("block_q", [8, 64, 128])
def test_k4_masked_entry_matches_plain(card, block_q, block_c, masked):
    """f32: the masked entry against its plain version (ids and counts
    equal, values within 1e-5). Without masks (all columns live, no own
    positions) it is the unmasked K4 bit for bit, and with masks every
    surviving (row, id) pair keeps the unmasked K4's value bit for bit:
    the masks touch the selection, never the scores."""
    from repro_torch.kernels.apss_block import fused

    Qn, Cn = _rect_inputs(torch.float32, 100, seed=PAIR_SEED[PAIRS[0]])
    Qn = _pad(Qn[:100], block_q, 256)
    Q, C = torch.from_numpy(Qn).to(card), torch.from_numpy(Cn).to(card)
    gq, gc = Q.shape[0] // block_q, C.shape[0] // block_c
    qi, cj = torch.meshgrid(torch.arange(gq), torch.arange(gc), indexing="ij")
    ij = torch.stack([qi.flatten(), cj.flatten()]).int()
    if masked:
        col_live, qpos = _masks(Q.shape[0], C.shape[0], seed=block_q + block_c)
    else:
        col_live = torch.ones(C.shape[0], dtype=torch.bool)
        qpos = torch.full((Q.shape[0],), -1, dtype=torch.int32)
    kw = dict(block_q=block_q, block_c=block_c, nc_valid=C.shape[0])
    before = dict(fused.LAUNCHES)
    got = fused.rect_tile_candidates_kernel(Q, C, ij, 0.3, 16, col_live=col_live,
                                            qpos=qpos, **kw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rect_tile_candidates_masked"] == (
        before["rect_tile_candidates_masked"] + 1)
    assert fused.LAUNCHES["rect_tile_candidates"] == before["rect_tile_candidates"]
    ref = fused.rect_tile_candidates_plain(Q, C, ij, 0.3, 16, col_live=col_live.to(card),
                                           qpos=qpos.to(card), **kw)
    _assert_close(got, ref)
    assert int(ref[2].sum()) > 0
    plain = fused.rect_tile_candidates_kernel(Q, C, ij, 0.3, 16, **kw)
    if not masked:
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
        return
    gv, gi = got[0].cpu().numpy(), got[1].cpu().numpy()
    pv, pi = plain[0].cpu().numpy(), plain[1].cpu().numpy()
    dead = ~col_live.numpy()
    rows = (ij[0].numpy()[:, None] * block_q + np.arange(block_q)).reshape(-1)
    own = qpos.numpy()[rows].reshape(gv.shape[0], block_q, 1)
    assert not (gi[gi >= 0][:, None] == np.nonzero(dead)[0][None, :]).any()
    assert not ((gi == own) & (gi >= 0)).any()
    unmasked = {(t, r, int(i)): v for (t, r, j), i in np.ndenumerate(pi) if i >= 0
                for v in [pv[t, r, j]]}
    for (t, r, j), i in np.ndenumerate(gi):
        if i >= 0 and (t, r, int(i)) in unmasked:
            assert gv[t, r, j] == unmasked[(t, r, int(i))]


def test_k4_masked_entry_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.apss_block import fused

    Q = torch.zeros((64, 128), device=card)
    C = torch.zeros((256, 128), device=card)
    ij = torch.tensor([[0], [0]], dtype=torch.int32)
    kw = dict(block_q=64, block_c=256, nc_valid=256)
    live = torch.ones(256, dtype=torch.bool)
    qpos = torch.full((64,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="go together"):
        fused.rect_tile_candidates_kernel(Q, C, ij, 0.3, 8, col_live=live, **kw)
    with pytest.raises(ValueError, match="must be"):
        fused.rect_tile_candidates_kernel(Q, C, ij, 0.3, 8, col_live=live[:100], qpos=qpos,
                                          **kw)
    with pytest.raises(ValueError, match="worklist"):  # masks index the (2, T) worklist's ids
        fused.rect_tile_candidates_kernel(Q, C, torch.zeros((3, 1), dtype=torch.int32), 0.3,
                                          8, col_live=live, qpos=qpos, **kw)


@pytest.mark.parametrize("block_rows", [64, 128, 256])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_live_index_on_card_equals_rebuild_and_cpu(card, kind, block_rows):
    """The live index on the card: mutated equals a fresh rebuild over the
    survivors bit for bit (graph and queries), every dense join launched
    K4's masked entry, and the graph agrees with the CPU index's (ids and
    counts equal, values within 1e-5)."""
    from repro_torch.kernels.apss_block import fused
    from repro_torch.serving import MutableAPSSIndex

    rng = np.random.default_rng(3)  # every float64 score more than 1e-5 from t
    D = np.abs(rng.standard_normal((700, 96))).astype(np.float32)
    D *= rng.random(D.shape) < 0.3
    D[np.arange(700), rng.integers(0, 96, 700)] += 1.0
    t, k = 0.5, 4  # some rows hold more than k matches
    kw = dict(threshold=t, k=k, kind=kind, block_rows=block_rows, cap=64)
    assert_clear_of_threshold(D / np.linalg.norm(D, axis=1, keepdims=True),
                              D / np.linalg.norm(D, axis=1, keepdims=True), t,
                              exclude_self=True)
    before = fused.LAUNCHES["rect_tile_candidates_masked"]
    idx = {dev: MutableAPSSIndex(D[:500], device=dev, **kw) for dev in ("cuda", "cpu")}
    for mi in idx.values():
        mi.append(D[500:520])
        mi.delete([3, 250, 505])
        mi.append(D[520:])
    launched = fused.LAUNCHES["rect_tile_candidates_masked"] - before
    assert launched >= (4 if kind == "dense" else 0)
    assert launched == 0 or kind == "dense"
    keep = [g for g in range(700) if g not in (3, 250, 505)]
    fresh = MutableAPSSIndex(D[keep], device="cuda", **kw)
    surv = np.asarray(keep)
    (gids, g), (_, fg) = idx["cuda"].graph(), fresh.graph()
    np.testing.assert_array_equal(gids, surv)
    assert np.array_equal(g.values, fg.values) and np.array_equal(g.counts, fg.counts)
    assert np.array_equal(g.indices, np.where(fg.indices >= 0,
                                              surv[np.maximum(fg.indices, 0)], -1))
    Q = D[:16] / np.linalg.norm(D[:16], axis=1, keepdims=True)
    r, rf = idx["cuda"].query(Q), fresh.query(Q)
    assert np.array_equal(r.values, rf.values) and np.array_equal(r.counts, rf.counts)
    _, cg = idx["cpu"].graph()
    np.testing.assert_array_equal(g.counts, cg.counts)
    np.testing.assert_array_equal(np.sort(g.indices, axis=1), np.sort(cg.indices, axis=1))
    finite = g.values > -np.inf
    np.testing.assert_allclose(g.values[finite], cg.values[finite], atol=TOL)


# -- the resumable sweep: K4's masked entry once per step ----------------------


def _sweep_corpus():
    D = _corp(700, 200, seed=11)
    assert_clear_of_threshold(D, D, 0.4, exclude_self=True)
    return D


@pytest.mark.parametrize("block_rows", [64, 128, 256])
def test_sweep_step_matches_plain(card, block_rows):
    """A sweep step (K4's masked entry over every row block and its partner,
    a 256-row block as two query blocks of 128) against the plain version
    of the same tiles on the card: ids and counts equal, values within
    1e-5; one launch per step. k = 2: some rows hold more matches."""
    from repro_torch.kernels.apss_block import fused
    from repro_torch.robust import sweep as tsweep

    D = _sweep_corpus()
    Dp = torch.from_numpy(_pad(D, block_rows, 32)).to(card)
    B = Dp.shape[0] // block_rows
    ids = torch.arange(Dp.shape[0], dtype=torch.int32, device=card)
    live = ids < 700
    kw = dict(B=B, bn=block_rows, n=700, threshold=0.4, k=2, col_live=live,
              qpos=torch.where(live, ids, -1))
    for s in (0, 1, B - 1):
        before = fused.LAUNCHES["rect_tile_candidates_masked"]
        got = tsweep.sweep_step(Dp, np.arange(B), s, **kw)
        assert fused.LAUNCHES["rect_tile_candidates_masked"] == before + 1
        blocks = torch.arange(B)
        ij = torch.stack([blocks, (blocks - s) % B]).int()
        fv, fi, fc = fused.rect_tile_candidates_plain(
            Dp, Dp, ij, 0.4, 2, block_q=block_rows, block_c=block_rows, nc_valid=700,
            col_live=kw["col_live"], qpos=kw["qpos"])
        ref = (torch.where(fi >= 0, fv, float("-inf")).reshape(-1, 2), fi.reshape(-1, 2),
               fc.reshape(-1))
        _assert_close(got, ref)
        assert int(ref[2].sum()) > 0


def test_sweep_on_card_resumed_and_ranked_bit_for_bit(card, tmp_path):
    """The sweep on the card equals itself bit for bit killed and resumed,
    and in 4 ranks on the card (one block each, a delay fault on rank 1,
    killed at step 3, rank 1 evicted, 3 survivors resuming with every
    block); and it agrees with the CPU sweep (ids and counts equal, values
    within 1e-5)."""
    from repro_torch.kernels.apss_block import fused
    from repro_torch.launch.mesh import spawn
    from repro_torch.robust import Fault, FaultPlan, ResumableSweep, SweepKilled

    D = _sweep_corpus()[:512]
    kw = dict(threshold=0.4, k=2, block_rows=128)
    before = fused.LAUNCHES["rect_tile_candidates_masked"]
    solo = ResumableSweep(D, directory=str(tmp_path / "solo"), **kw).run()
    assert fused.LAUNCHES["rect_tile_candidates_masked"] == before + 4
    with pytest.raises(SweepKilled):
        ResumableSweep(D, directory=str(tmp_path / "k"),
                       fault_plan=FaultPlan([Fault("kill", step=2)]), **kw).run()
    resumed = ResumableSweep(D, directory=str(tmp_path / "k"), **kw)
    for a, b in zip(resumed.run(), solo):
        assert torch.equal(a, b)
    assert resumed.resumed_from == 2
    np.save(tmp_path / "corpus.npy", D)
    outs = spawn("repro_torch.launch.sweep:run_ranks", 4, str(tmp_path / "corpus.npy"),
                 str(tmp_path / "ranks"), kw,
                 [Fault("kill", step=3), Fault("delay", rank=1, seconds=0.2, times=-1)],
                 device="cuda", run_dir=str(tmp_path), join_timeout=300)
    assert all(o["evict"] == [1] and o["killed"] for o in outs)
    assert outs[0]["resumed_ranks"] == 3 and not outs[0]["resumed_sharded"]
    for a, b in zip(outs[0]["matches"], solo):
        np.testing.assert_array_equal(a, b.cpu().numpy())
    cpu = ResumableSweep(D, directory=str(tmp_path / "cpu"), device="cpu", **kw).run()
    _assert_close(solo, cpu)


@pytest.mark.parametrize("block_rows", [32, 512])
def test_sweep_block_rows_outside_k4_raises_on_card(card, tmp_path, block_rows):
    from repro_torch.robust import ResumableSweep

    with pytest.raises(ValueError, match="on the card"):
        ResumableSweep(_corp(64, 32, seed=1), threshold=0.3, block_rows=block_rows,
                       directory=str(tmp_path))


# -- K8 and K9: the LM's attention kernels ------------------------------------

ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _normal(shape, seed, dtype, card):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(card, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Hq,Hkv,S,D,causal",
    [
        (1, 2, 2, 1, 16, True),       # S = 1, group 1
        (2, 4, 2, 130, 64, True),     # S not a multiple of the tile, group 2
        (1, 8, 1, 200, 128, True),    # group 8
        (1, 4, 2, 512, 32, True),
        (2, 16, 8, 256, 128, False),  # non-causal, divisible S
        (1, 2, 1, 512, 16, False),    # D = 16 over several kv tiles
        (2, 4, 4, 1024, 64, True),
    ],
)
def test_k8_matches_plain(card, dtype, B, Hq, Hkv, S, D, causal):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES,
        flash_attention_plain,
    )

    q = _normal((B, Hq, S, D), 1, dtype, card)
    k = _normal((B, Hkv, S, D), 2, dtype, card)
    v = _normal((B, Hkv, S, D), 3, dtype, card)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [64, 192])
@pytest.mark.parametrize("D", [16, 128])
def test_k8_kernel_at_tile_multiples(card, dtype, S, D):
    """The kernel itself at S a multiple of its 64-row tile (one tile; an odd
    number of them), causal and not, GQA group 2."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_kernel,
        flash_attention_plain,
    )

    q = _normal((2, 4, S, D), 4, dtype, card)
    k = _normal((2, 2, S, D), 5, dtype, card)
    v = _normal((2, 2, S, D), 6, dtype, card)
    for causal in (True, False):
        got = flash_attention_kernel(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   atol=ATOL[dtype], rtol=0)


def test_k8_refuses_instead_of_running_the_plain_version(card):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES,
        flash_attention_kernel,
    )

    q = torch.zeros((1, 2, 100, 64), device=card)
    before = LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_attention_kernel(q, q, q)
    q48 = torch.zeros((1, 2, 128, 48), device=card)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_kernel(q48, q48, q48)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_kernel(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(q, q, q, causal=False)
    assert LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Hq,Hkv,L,D,lengths",
    [
        (3, 2, 2, 100, 16, [0, 1, 100]),      # lengths 0, 1 and L; group 1
        (3, 4, 2, 1000, 64, [0, 1, 1000]),    # L not a multiple of any tile
        (2, 16, 2, 777, 128, [777, 5]),       # group 8
        (2, 4, 1, 300, 32, [150, 300]),       # group 4
    ],
)
def test_k9_matches_plain(card, dtype, B, Hq, Hkv, L, D, lengths):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.decode_attention import (
        LAUNCHES,
        decode_attention_kernel,
        decode_attention_plain,
    )

    q = _normal((B, Hq, D), 4, dtype, card)
    k = _normal((B, Hkv, L, D), 5, dtype, card)
    v = _normal((B, Hkv, L, D), 6, dtype, card)
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = LAUNCHES["decode_attention"]
    acc, m, l = decode_attention_kernel(q, k, v, lens)
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == before + 2
    pacc, pm, pl = decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(m.cpu().numpy(), pm.cpu().numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(l.cpu().numpy(), pl.cpu().numpy(), rtol=1e-5, atol=0)
    want = pacc / torch.where(pl == 0, 1.0, pl)[..., None]
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), atol=ATOL[dtype], rtol=0)
    empty = lens.cpu().numpy() == 0
    assert (acc.cpu().numpy()[empty] == 0).all() and (l.cpu().numpy()[empty] == 0).all()


def test_k9_refuses_instead_of_running_the_plain_version(card):
    from repro_torch.kernels.decode_attention.decode_attention import (
        LAUNCHES,
        decode_attention_kernel,
    )

    lens = torch.ones(2, dtype=torch.int32, device=card)
    before = LAUNCHES["decode_attention"]
    with pytest.raises(ValueError, match="groups"):  # group 3
        decode_attention_kernel(torch.zeros((2, 3, 64), device=card),
                                torch.zeros((2, 1, 8, 64), device=card),
                                torch.zeros((2, 1, 8, 64), device=card), lens)
    with pytest.raises(ValueError, match="head dims"):
        decode_attention_kernel(torch.zeros((2, 2, 48), device=card),
                                torch.zeros((2, 2, 8, 48), device=card),
                                torch.zeros((2, 2, 8, 48), device=card), lens)
    kv = torch.zeros((2, 2, 8, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_kernel(torch.zeros((2, 2, 64), device=card), kv.transpose(2, 3)
                                .contiguous().transpose(2, 3), kv, lens)
    assert LAUNCHES["decode_attention"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,D", [(1, 16), (2, 32), (4, 64), (8, 128), (2, 128)])
def test_k9_split_lengths_match_plain(card, dtype, group, D):
    """K9's split over a 32,768-position cache at skewed lengths: 32,767, 1,
    0 and one split less one, one split and one split plus one position,
    against its plain version at the tolerances above."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        LAUNCHES,
        decode_attention_kernel,
        decode_attention_plain,
        decode_split,
    )

    L, Hkv = 32768, 2
    split = decode_split(L, D).split
    lengths = [L - 1, 1, 0, split - 1, split, split + 1]
    B = len(lengths)
    q = _normal((B, group * Hkv, D), 7, dtype, card)
    k = _normal((B, Hkv, L, D), 8, dtype, card)
    v = _normal((B, Hkv, L, D), 9, dtype, card)
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = LAUNCHES["decode_attention"]
    acc, m, l = decode_attention_kernel(q, k, v, lens)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == before + 1
    pacc, pm, pl = decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(m.cpu().numpy(), pm.cpu().numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(l.cpu().numpy(), pl.cpu().numpy(), rtol=1e-5, atol=0)
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    want = pacc / torch.where(pl == 0, 1.0, pl)[..., None]
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), atol=ATOL[dtype], rtol=0)
    assert (acc[2] == 0).all() and (l[2] == 0).all() and (m[2] == -0.5e30).all()


def test_k9_repeated_call_is_bit_identical(card):
    """No atomics: the splits merge in a fixed order, so two calls give the
    same bits."""
    from repro_torch.kernels.decode_attention.decode_attention import decode_attention_kernel

    q = _normal((4, 16, 128), 10, torch.bfloat16, card)
    k = _normal((4, 8, 8192, 128), 11, torch.bfloat16, card)
    v = _normal((4, 8, 8192, 128), 12, torch.bfloat16, card)
    lens = torch.tensor([8191, 3000, 1025, 7], dtype=torch.int32, device=card)
    first = decode_attention_kernel(q, k, v, lens)
    second = decode_attention_kernel(q, k, v, lens)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits): 2 ** (floor(log2 |x|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def test_r1_bf16_outputs_of_magnitude_four_within_two_ulps(card):
    """R1's probe: V drawn from 4 * (1 + |N(0, 1)|), so every output lies at
    or above 4, where one bf16 ulp (0.031) passes the absolute 2e-2 bound.
    K8 rounds its output and P to bf16, so it stays within 2 bf16 ulps of
    the output of its plain version and of the f32 reference (half an ulp
    for each output's rounding, the rest for P's); K9 keeps f32 partials of
    exactly widened inputs, so it stays within a relative 1e-5 of both."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_kernel,
        decode_attention_plain,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    from repro_torch.kernels.flash_attention import attention_reference, flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain

    bf = torch.bfloat16
    q = _normal((2, 16, 1024, 128), 13, bf, card)
    k = _normal((2, 8, 1024, 128), 14, bf, card)
    v = (4 * (1 + _normal((2, 8, 1024, 128), 15, torch.float32, card).abs())).to(bf)
    got = flash_attention(q, k, v).float()
    for want in (flash_attention_plain(q, k, v).float(),
                 attention_reference(q.float(), k.float(), v.float())):
        assert want.min() >= 4
        assert ((got - want).abs() / _bf16_ulp(want)).max() <= 2
    qd = _normal((2, 16, 128), 16, bf, card)
    lens = torch.tensor([1024, 333], dtype=torch.int32, device=card)
    acc, _, l = decode_attention_kernel(qd, k, v, lens)
    out = acc / l[..., None]
    pacc, _, pl = decode_attention_plain(qd, k, v, lens)
    for want in (pacc / pl[..., None],
                 decode_attention_reference(qd.float(), k.float(), v.float(), lens)):
        assert want.min() >= 4
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=0)


def test_lm_kernel_path_matches_plain_path_on_card(card):
    """The qwen3 smoke model (f32) through K8 and K9 against use_kernel=False,
    at the tolerance the CPU tests hold the model to JAX (atol 5e-4, rtol 5e-3)."""
    import dataclasses

    from repro_torch.configs.qwen3_1_7b import smoke_config
    from repro_torch.models import transformer as tt

    cfg = smoke_config()
    model = tt.init_transformer(cfg, generator=torch.Generator(card).manual_seed(0), device=card)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)).to(card)
    tol = dict(atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(tt.prefill(model, cfg, tokens).cpu().numpy(),
                               tt.prefill(model, cfg, tokens, use_kernel=False).cpu().numpy(),
                               **tol)
    kernel, plain = (tt.make_cache(cfg, 2, 48, device=card) for _ in range(2))
    for i in range(tokens.shape[1]):
        a, _ = tt.decode_step(model, cfg, kernel, tokens[:, i])
        b, _ = tt.decode_step(model, cfg, plain, tokens[:, i], use_kernel=False)
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol)
    with pytest.raises(ValueError, match="bf16_probs"):
        tt.prefill(model, dataclasses.replace(cfg, bf16_probs=True), tokens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dqk,dv", [(96, 64), (24, 16)])
def test_k8_padded_mla_matches_plain(card, dtype, dqk, dv):
    """MLA's call of K8 (``transformer._mla_flash``): q and k of width dqk, v of
    width dv, zero-padded to K8's head dim and scaled by 1/√dqk, against the
    plain chunked attention on the unpadded tensors."""
    import importlib

    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import chunked_attention

    k8 = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    g = torch.Generator(card).manual_seed(dqk)
    q, k = (torch.randn((2, 40, 200, dqk), generator=g, device=card).to(dtype) for _ in range(2))
    v = torch.randn((2, 40, 200, dv), generator=g, device=card).to(dtype)
    scale = 1.0 / dqk ** 0.5
    before = k8.LAUNCHES["flash_attention"]
    got = tt._mla_flash(q, k, v, scale=scale)
    assert k8.LAUNCHES["flash_attention"] == before + 1
    want = chunked_attention(q, k, v, causal=True, scale=scale, q_chunk=100, kv_chunk=100)
    assert got.shape == want.shape == (2, 40, 200, dv) and got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=2e-5 if dtype == torch.float32 else 2e-2, rtol=0)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-moe-16b"])
def test_zoo_kernel_path_matches_plain_path_on_card(card, arch):
    """The smoke models of the MLA and MoE families (f32) through K8 (padded
    for MLA) and K9 (GQA decode; MLA decode has no kernel) against
    use_kernel=False, at the CPU tests' model tolerance; K8 launches once a
    layer a prefill, K9 once a GQA layer a step. (arctic-480b's smoke head
    dim of 8 is below K8's and K9's: ``test_zoo_head_dim_k8_cannot_take_raises``.)"""
    import importlib

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt

    k8 = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    k9 = importlib.import_module("repro_torch.kernels.decode_attention.decode_attention")
    cfg = get_arch(arch).make_smoke_config()
    model = tt.init_transformer(cfg, generator=torch.Generator(card).manual_seed(0), device=card)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)).to(card)
    tol = dict(atol=5e-4, rtol=5e-3)
    k8.LAUNCHES["flash_attention"] = 0
    got = tt.prefill(model, cfg, tokens)
    assert k8.LAUNCHES["flash_attention"] == cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(),
                               tt.prefill(model, cfg, tokens, use_kernel=False).cpu().numpy(),
                               **tol)
    kernel, plain = (tt.make_cache(cfg, 8, 48, device=card) for _ in range(2))
    steps = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 12)).astype(np.int32)).to(card)
    for i in range(steps.shape[1]):
        k9.LAUNCHES["decode_attention"] = 0
        a, _ = tt.decode_step(model, cfg, kernel, steps[:, i])
        assert k9.LAUNCHES["decode_attention"] == (0 if cfg.attention == "mla" else cfg.n_layers)
        b, _ = tt.decode_step(model, cfg, plain, steps[:, i], use_kernel=False)
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol)


def test_zoo_head_dim_k8_cannot_take_raises(card):
    """arctic-480b's smoke config (head dim 8) on the card: the kernel path
    raises rather than falling back; the plain path runs."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt

    cfg = get_arch("arctic-480b").make_smoke_config()
    model = tt.init_transformer(cfg, generator=torch.Generator(card).manual_seed(0), device=card)
    tokens = torch.zeros((2, 16), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dims"):
        tt.prefill(model, cfg, tokens)
    assert torch.isfinite(tt.prefill(model, cfg, tokens, use_kernel=False)).all()


def test_dedup_k1_matches_plain(card):
    """``dedup_corpus`` on the card takes K1 (``use_kernel=None``) and keeps
    and drops the rows the plain path does, every planted copy dropped."""
    import importlib

    from repro_torch.data import dedup_corpus
    from repro_torch.data.synthetic import synthetic_corpus

    fused = importlib.import_module("repro_torch.kernels.apss_block.fused")
    D = synthetic_corpus(1500, 3000, 40.0, seed=3)
    rng = np.random.default_rng(4)
    src = rng.choice(1500, 64, replace=False)
    X = np.concatenate([D, D[src] * (1 + 0.01 * rng.random((64, 3000)).astype(np.float32))])
    fused.LAUNCHES["apss_fused"] = 0
    keep, dup_of = dedup_corpus(X, device=card)
    assert fused.LAUNCHES["apss_fused"] == 1
    want_keep, want_dup = dedup_corpus(X, device=card, use_kernel=False)
    np.testing.assert_array_equal(keep, want_keep)
    np.testing.assert_array_equal(dup_of, want_dup)
    assert not keep[1500:].any()


# -- the planner on the card -----------------------------------------------------------


def test_planner_offers_the_kernels_on_the_card(card):
    """Kernel candidates are offered where the data lives on the card (K1
    dense, K3 sparse; K4/K6 for a query plan), and on no other device."""
    from repro_torch.core.sparse import from_dense
    from repro_torch.planner import default_profile, plan_apss, plan_query_topk
    from repro_torch.planner.plan import candidate_configs, summarize_corpus
    from repro_torch.serving import build_index

    D = torch.from_numpy(_corp(256, 96, seed=51)).cuda()
    s = summarize_corpus(D, 0.3)
    names = [c.name for c in candidate_configs(s)]  # the port's default device: cuda
    assert "blocked[dense,b=128,kernel]" in names
    assert not any(c.use_kernel for c in candidate_configs(s, device="cpu"))
    plan = plan_apss(D, 0.3, 8, profile=default_profile())
    assert plan.device.type == "cuda" and any(e.config.use_kernel for e in plan.estimates)
    for corpus in (D, from_dense(D, device=D.device)):
        index = build_index(corpus, block_rows=64, normalize=False)
        assert plan_query_topk(index, 8, 0.3, 8).use_kernel


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_query_plan_auto_launches_k4_or_k6(card, kind):
    from repro_torch.core.sparse import from_dense
    from repro_torch.kernels.apss_block import fused
    from repro_torch.serving import build_index, query_topk

    C = _corp(300, 96, seed=52)
    Q = _corp(12, 96, seed=53)
    assert_clear_of_threshold(Q, C, 0.3)
    Ct = torch.from_numpy(C).cuda()
    index = build_index(Ct if kind == "dense" else from_dense(Ct, device=Ct.device),
                        block_rows=64, normalize=False)
    name = "rect_tile_candidates" if kind == "dense" else "rect_sparse_tile_candidates"
    before = fused.LAUNCHES[name]
    got = query_topk(index, torch.from_numpy(Q).cuda(), 0.3, 8, plan="auto")
    assert fused.LAUNCHES[name] == before + 1
    plain = query_topk(index, torch.from_numpy(Q).cuda(), 0.3, 8, block_q=16)
    _assert_close((got.values, got.indices, got.counts),
                  (plain.values, plain.indices, plain.counts))


def test_plan_runs_the_kernel_and_is_exact(card):
    from repro_torch.core.apss import apss_reference
    from repro_torch.kernels.apss_block import fused
    from repro_torch.planner import VariantConfig, execute

    D = _corp(300, 96, seed=68)  # every score clear of t
    assert_clear_of_threshold(D, D, 0.3, exclude_self=True)
    Dt = torch.from_numpy(D).cuda()
    ref = apss_reference(Dt, 0.3, 8)
    for cfg, name in ((VariantConfig("blocked", False, 128, use_kernel=True), "apss_fused"),
                      (VariantConfig("blocked", True, 128, use_kernel=True),
                       "sparse_tile_candidates")):
        before = fused.LAUNCHES[name]
        got = execute(cfg, Dt, 0.3, 8)
        assert fused.LAUNCHES[name] == before + 1
        assert got.values.device.type == "cuda"
        _assert_close((got.indices, got.counts), (ref.indices, ref.counts))


def test_autotune_raises_a_kernel_error_instead_of_pricing_it_inf(card, monkeypatch):
    from repro_torch.kernels._build import KernelError
    from repro_torch.kernels.apss_block import ops
    from repro_torch.planner import default_profile, plan_apss

    D = np.zeros((256, 128), np.float32)  # two clusters: the kernel is the dense favourite
    D[:128, :64] = np.random.default_rng(4).random((128, 64))
    D[128:, 64:] = np.random.default_rng(5).random((128, 64))
    D /= np.linalg.norm(D, axis=1, keepdims=True)

    def broken(*a, **kw):
        raise KernelError("apss_fused failed to launch")

    monkeypatch.setattr(ops, "apss_fused_kernel", broken)
    with pytest.raises(KernelError, match="failed to launch"):
        plan_apss(torch.from_numpy(D).cuda(), 0.5, 16, profile=default_profile(),
                  autotune=True, block_rows_choices=(128,))


# ---------------------------------------------------------------------------
# The op census (launch.op_analysis) and the build/load monitor (obs.compile)
# ---------------------------------------------------------------------------


def _packets(rows, k):
    return rows * (2 * k + 1) * 4


def _census_case(name, card):
    """``(call, kernel name, flops, bytes)`` of one launch of ``name`` at
    small padded shapes; the work is the formula of the wrapper's doc,
    written out here from the shapes, the mask and the split."""
    from repro_torch.kernels.apss_block import apss_block, fused, sparse

    k = 16
    if name in ("apss_fused", "apss_block"):
        D = torch.from_numpy(_pad(_inputs(torch.float32, seed=1), 256, 128)).to(card)
        n, m = D.shape
        mask = torch.ones((n // 128, n // 128), dtype=torch.int32, device=card)
        mask[0, 1] = mask[2, 0] = 0
        live = int(mask.sum())
        if name == "apss_block":
            return (lambda: apss_block.apss_block_kernel(D, D, mask, 0.3, block_m=128,
                                                         block_n=128),
                    name, 2.0 * live * 128 * 128 * m * 3,
                    live * 256 * m * 4 + 4 * n * n + 4 * mask.numel())
        S = fused.fused_segments_for(D, n, k)
        out = _packets(n, k) * (1 + 2 * S if S > 1 else 1)
        occ = fused.fused_occupancy_plain(D.cpu())
        walked, dense = fused.fused_walk_plain(occ, occ, mask, block_m=128, block_n=128, m=m)
        assert dense == live * m // 32 and walked < dense  # the padded features are skipped
        step0 = n * m * 4 + 8 * occ.numel()  # the bitmaps: the corpus read, words written
        return (lambda: fused.apss_fused_kernel(D, D, mask, 0.3, k, block_m=128, block_n=128,
                                                n_valid_cols=300),
                name, 2.0 * walked * 128 * 128 * 32,
                walked * 256 * 32 * 4 + out + 4 * mask.numel() + step0)
    if name == "apss_tile_candidates":
        D = torch.from_numpy(_pad(_inputs(torch.float32, seed=1), 256, 128)).to(card)
        ij = torch.tensor([[0, 0, 1], [0, 1, 1]], dtype=torch.int32, device=card)
        T, m = 3, D.shape[1]
        return (lambda: fused.apss_tile_candidates_kernel(D, ij, 0.3, k, block_m=256,
                                                          block_n=256, n_valid=300),
                name, 2.0 * T * 256 * 256 * m,
                T * 512 * m * 4 + 8 * T * 256 * 256 + _packets(T * 512, k) + 8 * T)
    if name == "sparse_tile_candidates":
        _, bx, yg, ij = _k3_operands(card, torch.float32, 128, seed=3)
        T, bm, S = yg.shape
        return (lambda: sparse.sparse_tile_candidates_kernel(bx, yg, ij, 0.5, k, n_valid=364),
                name, 2.0 * T * bm * bm * S,
                2 * T * bm * S * 4 + 8 * T * bm * bm + _packets(2 * T * bm, k) + 8 * T)
    if name == "rect_sparse_tile_candidates":
        qg, bx, ij, t = _k6_case(64, 128, 1024)
        qg, bx = (torch.from_numpy(a).to(card) for a in (qg, bx))
        ij = torch.from_numpy(ij).to(card)
        T, S = qg.shape[0], qg.shape[2]
        chunks = fused.rect_work_split(T, S, 64, 128, sparse.RECT_SCRATCH_BYTES).n_chunks
        return (lambda: sparse.rect_sparse_tile_candidates_kernel(qg, bx, ij, t, k,
                                                                  nc_valid=384),
                name, 2.0 * T * 64 * 128 * S,
                T * 192 * S * 4 + 8 * T * chunks * 64 * 128 + _packets(T * 64, k) + 8 * T)
    Qn, Cn = _rect_inputs(torch.float32, 100, seed=11)
    Q, C = (torch.from_numpy(a).to(card) for a in (Qn[:128], Cn))
    bq, bc, m = 64, 128, Q.shape[1]
    gq, gc = Q.shape[0] // bq, C.shape[0] // bc
    qi, cj = torch.meshgrid(torch.arange(gq), torch.arange(gc), indexing="ij")
    ij = torch.stack([qi.flatten(), cj.flatten()]).int()
    T = ij.shape[1]
    chunks = fused.rect_work_split(T, m, bq, bc).n_chunks
    per_tile = (bq + bc) * m * 4 + 8 * chunks * bq * bc
    kw = dict(block_q=bq, block_c=bc, nc_valid=500)
    if name == "rect_tile_candidates_ee":
        # Query block 0's tiles first, then block 1's at a bound below every
        # row's k-th value at t = 0 once one of its tiles is scored: skipped.
        ub = torch.full((T,), 2.0, device=card)
        ub[T // 2:] = 0.05
        got = fused.rect_tile_candidates_early_exit_kernel(Q, C, ij, ub, 0.0, k, nq_valid=100,
                                                           **kw)
        scored = T - int(got[3].sum())
        assert 0 < scored < T
        return (lambda: fused.rect_tile_candidates_early_exit_kernel(
                    Q, C, ij, ub, 0.0, k, nq_valid=100, **kw),
                name, 2.0 * scored * bq * bc * m,
                scored * per_tile + _packets(T * bq, k) + 16 * T)
    if name == "rect_tile_candidates_masked":
        col_live = torch.ones(C.shape[0], dtype=torch.bool)
        qpos = torch.full((Q.shape[0],), -1, dtype=torch.int32)
        return (lambda: fused.rect_tile_candidates_kernel(Q, C, ij, 0.3, k, col_live=col_live,
                                                          qpos=qpos, **kw),
                name, 2.0 * T * bq * bc * m,
                T * per_tile + _packets(T * bq, k) + 8 * T + C.shape[0] + 4 * Q.shape[0])
    return (lambda: fused.rect_tile_candidates_kernel(Q, C, ij, 0.3, k, **kw),
            name, 2.0 * T * bq * bc * m, T * per_tile + _packets(T * bq, k) + 8 * T)


@pytest.mark.parametrize("name", [
    "apss_fused", "apss_tile_candidates", "sparse_tile_candidates", "rect_tile_candidates",
    "rect_tile_candidates_masked", "rect_tile_candidates_ee", "rect_sparse_tile_candidates",
    "apss_block"])
def test_census_reports_each_apss_kernel_launch(card, name):
    """One launch under the op census reports its work at the padded shapes
    the card computes (dead tiles and K5's skipped tiles not counted), read
    when the census closes."""
    from repro_torch.launch.op_analysis import analyze

    call, kname, flops, nbytes = _census_case(name, card)
    _, got = analyze(call)
    assert got["kernels"][kname] == {"launches": 1, "flops": flops, "bytes": nbytes}
    assert got["flops"] == flops  # the kernel's products are opaque to the dispatcher


def test_census_reports_attention_work(card):
    import importlib

    from repro_torch.launch.op_analysis import analyze

    k8 = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    k9 = importlib.import_module("repro_torch.kernels.decode_attention.decode_attention")
    g = torch.Generator("cuda").manual_seed(0)
    B, Hq, Hkv, S, D = 2, 4, 2, 192, 64
    q = torch.randn((B, Hq, S, D), generator=g, device=card)
    kv = torch.randn((B, Hkv, S, D), generator=g, device=card)
    pairs = 3 * 4 // 2  # 3 tiles of 64 on and below the diagonal
    _, got = analyze(lambda: k8.flash_attention_kernel(q, kv, kv))
    assert got["kernels"]["flash_attention"]["flops"] == 4.0 * B * Hq * D * 64 * 64 * pairs
    _, got = analyze(lambda: k8.flash_attention_kernel(q, kv, kv, causal=False))
    assert got["kernels"]["flash_attention"]["flops"] == 4.0 * B * Hq * D * S * S
    L = 300
    qd = torch.randn((B, Hq, D), generator=g, device=card)
    cache = torch.randn((B, Hkv, L, D), generator=g, device=card)
    lengths = torch.tensor([7, 1000], dtype=torch.int32, device=card)
    _, got = analyze(lambda: k9.decode_attention_kernel(qd, cache, cache, lengths))
    assert got["kernels"]["decode_attention"]["flops"] == 4.0 * Hq * D * (7 + L)


def _served(card, sparse_index):
    from repro_torch.core.sparse import from_dense
    from repro_torch.serving import build_index

    D = _corp(700, 3000, seed=5, density=0.05)
    data = from_dense(D, device=card) if sparse_index else D
    return build_index(data, block_rows=128, device=card), D[:32]


@pytest.mark.parametrize("sparse_index", [False, True], ids=["dense", "csr"])
def test_warmed_query_topk_builds_and_loads_nothing(card, sparse_index):
    from repro_torch.obs import compile as obs_compile
    from repro_torch.serving import query_topk

    index, Q = _served(card, sparse_index)
    want = query_topk(index, Q, 0.2, 8, use_kernel=True, block_q=32)  # warm
    with obs_compile.assert_no_retrace("serving.query"):
        got = query_topk(index, Q, 0.2, 8, use_kernel=True, block_q=32)
    _assert_close(got, want)


def test_no_retrace_contract_raises_when_the_libraries_are_dropped(card):
    from repro_torch.kernels import _build
    from repro_torch.obs import RetraceError
    from repro_torch.obs import compile as obs_compile
    from repro_torch.serving import query_topk

    index, Q = _served(card, False)
    query_topk(index, Q, 0.2, 8, use_kernel=True, block_q=32)  # warm
    before = obs_compile.snapshot().get("rect_tile_candidates", 0)
    with pytest.raises(RetraceError, match="rect_tile_candidates"):
        with obs_compile.assert_no_retrace("serving.query"):
            _build._LIBS.clear()
            query_topk(index, Q, 0.2, 8, use_kernel=True, block_q=32)
    assert obs_compile.snapshot()["rect_tile_candidates"] == before + 1  # one load


def test_measure_on_card_reports_libraries_and_staging(card, tmp_path):
    """``measure`` of a K4 query on the card: its library's size and ptxas
    rows, the peak allocation above its arguments; and a gloo all-reduce
    of a card tensor stages it through the host both ways, billed as
    ``host_copy_bytes``, not HBM."""
    import torch.distributed as dist

    from repro_torch.core import distributed as dd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.obs.compile import CompileMonitor
    from repro_torch.serving import query_topk

    index, Q = _served(card, False)
    _, rec = CompileMonitor().measure(query_topk, index, Q, 0.2, 8, use_kernel=True,
                                      block_q=32, name="k4")
    assert rec.analysis["kernels"]["rect_tile_candidates"]["launches"] == 1
    assert rec.code_bytes > 0 and rec.temp_bytes > 0
    assert {r["library"] for r in rec.kernels} == {"rect_tile_candidates"}
    assert all("registers" in r for r in rec.kernels)
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        x = torch.ones((64, 32), device=card)
        mesh = make_mesh((1,), ("data",))
        _, got = analyze(lambda: dd._psum(x, mesh, "data"))
    finally:
        dist.destroy_process_group()
    assert got["host_copy_bytes"] == 2 * x.numel() * 4  # to the host and back
    assert got["hbm_bytes"] == 0
    assert got["collectives"]["all-reduce"]["count"] == 1


def test_attention_wrappers_refuse_autograd_on_the_card(card):
    """K8 and K9 have no backward pass: their wrappers raise on inputs that
    require a gradient under grad mode, and run under ``no_grad``."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn((1, 2, 128, 64), device=card, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q, q.detach(), q.detach())
    k = torch.randn((1, 2, 256, 64), device=card)
    lens = torch.tensor([200], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="no backward"):
        decode_attention(q[:, :, 0], k, k, lens)
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape
        assert decode_attention(q[:, :, 0], k, k, lens).shape == (1, 2, 64)


def test_segment_sum_and_take_backward_are_deterministic_on_the_card(card):
    """The fixed-order reductions training rests on: ``segment_sum`` and
    ``take``'s backward give the same bits on every run, and agree with a
    float64 run on the CPU within the f32 bound of a sum of the largest
    segment's length n: n · 2⁻²⁴ of the largest value (one segment holds
    5,000 rows, summed serially)."""
    from repro_torch.models.layers import segment_sum, take

    gen = torch.Generator().manual_seed(0)
    data = torch.randn((50_000, 8, 4), generator=gen)
    seg = torch.randint(0, 3000, (50_000,), generator=gen)
    seg[:5000] = 7  # one heavy segment
    w = torch.randn((3000, 8, 4), generator=gen)
    runs = []
    for dev, dt in ((card, torch.float32), (card, torch.float32),
                    (torch.device("cpu"), torch.float64)):
        x = data.to(dev, dt).requires_grad_(True)
        out = segment_sum(take(x, seg.to(dev)), seg.to(dev), 3000)
        (g,) = torch.autograd.grad((out * w.to(dev, dt)).sum(), x)
        runs.append((out.detach().cpu().numpy(), g.cpu().numpy()))
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a, b)
    n = int(torch.bincount(seg).max())
    for a, b in zip(runs[0], runs[2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=n * 2.0 ** -24 * float(np.abs(b).max()))
