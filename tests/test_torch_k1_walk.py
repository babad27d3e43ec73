"""K1's chunk walk on the CPU: the plain versions of its bitmaps
(``fused.fused_occupancy_plain``) and of the count of stages it walks
(``fused.fused_walk_plain``), against loops in numpy over the same inputs.

K1 walks, for each live 128 × 128 tile, the 32-feature chunks in which both
of its row tiles hold a nonzero or either an Inf or NaN; the card tests
(``tests/test_torch_kernels_gpu.py``) hold the kernel's bitmaps and counter
to these plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.apss_block import fused  # noqa: E402


def _zipf(n, m, seed, nnz=12.0):
    """Rows of Poisson(nnz) nonzeros on Zipf(1.1)-popular dimensions, so the
    last chunks of a tile are often empty."""
    rng = np.random.default_rng(seed)
    p = (np.arange(m) + 1.0) ** -1.1
    p /= p.sum()
    X = np.zeros((n, m), np.float32)
    for i in range(n):
        dims = rng.choice(m, size=min(m, max(1, rng.poisson(nnz))), replace=False, p=p)
        X[i, dims] = rng.random(len(dims)) + 0.05
    return X


def _case(name):
    """``(x, y or None for y = x, mask, block_m, block_n)``: rows padded to
    whole blocks, every width a multiple of 32."""
    if name == "ragged":  # 300 rows: tiles of 128, 128 and 44 (64 padded)
        x = _zipf(300, 2080, seed=1)  # 65 chunks: the last word holds one
        x = np.pad(x, ((0, 20), (0, 0)))
        return x, None, np.ones((5, 5), np.int32), 64, 64
    if name == "zero_tile":  # rows 128-255 all zero
        x = _zipf(384, 1024, seed=2)
        x[128:256] = 0
        return x, None, np.ones((3, 3), np.int32), 128, 128
    if name == "last_feature":  # one nonzero at the last feature of a chunk
        x = np.zeros((256, 2048), np.float32)
        x[5, 32 * 40 + 31] = 1.0    # tile 0 only: walked by (0, 0) alone
        x[130, 32 * 63 + 31] = 2.0  # tiles 0 and 1: walked by every pair
        x[7, 32 * 63 + 31] = -0.5
        x[200, 32 * 7] = -0.0       # -0 counts as zero
        return x, None, np.ones((2, 2), np.int32), 128, 128
    if name == "non_finite":  # an Inf or NaN chunk is walked by every pair it meets
        x = _zipf(256, 1024, seed=3)
        x[3, 32 * 30 + 4] = np.inf
        x[250, 32 * 31 + 9] = np.nan
        return x, None, np.ones((2, 2), np.int32), 128, 128
    if name == "distinct_y":  # y is not x: other rows, another tile count
        x = _zipf(256, 1536, seed=4)
        y = _zipf(640, 1536, seed=5, nnz=6.0)
        return x, y, np.ones((1, 5), np.int32), 256, 128
    if name == "dead_mask":  # dead entries are not counted, at 256 x 256
        x = _zipf(768, 4096, seed=6, nnz=6.0)
        mask = np.ones((3, 3), np.int32)
        mask[0, 2] = mask[2, 1] = mask[1, 1] = 0
        return x, None, mask, 256, 256
    raise ValueError(name)


CASES = ["ragged", "zero_tile", "last_feature", "non_finite", "distinct_y", "dead_mask"]


def _chunk_bits(X):
    """``(nonzero, non-finite)`` of each (128-row tile, 32-feature chunk)."""
    tiles, chunks = -(-X.shape[0] // 128), X.shape[1] // 32
    nz = np.zeros((tiles, chunks), bool)
    bad = np.zeros((tiles, chunks), bool)
    for t in range(tiles):
        for c in range(chunks):
            blk = X[128 * t:128 * (t + 1), 32 * c:32 * (c + 1)]
            nz[t, c] = bool(np.any(blk != 0))
            bad[t, c] = not bool(np.all(np.isfinite(blk)))
    return nz, bad


def _words(bits):
    tiles, chunks = bits.shape
    out = np.zeros((tiles, -(-chunks // 32)), np.uint32)
    for t, c in zip(*np.nonzero(bits)):
        out[t, c // 32] |= np.uint32(1 << (c % 32))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_k1_bitmaps_plain_match_numpy(name, dtype):
    x, y, _, _, _ = _case(name)
    for X in (x, y[:500] if y is not None else x[:130]):  # a ragged last tile too
        X = torch.from_numpy(X).to(dtype)
        got = fused.fused_occupancy_plain(X)
        nz, bad = _chunk_bits(X.float().numpy())
        want = np.stack([_words(nz), _words(bad)], axis=1)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        assert fused.fused_occupancy(X).equal(got)  # the CPU takes the plain version


@pytest.mark.parametrize("name", CASES)
def test_k1_walked_stages_plain_match_numpy(name):
    """Σ over the live 128 × 128 tiles of the chunks both row tiles hold a
    nonzero in, or either a non-finite value; the dense walk is m / 32 a
    live tile."""
    x, y, mask, bm, bn = _case(name)
    Y = x if y is None else y
    ox = fused.fused_occupancy_plain(torch.from_numpy(x))
    oy = ox if y is None else fused.fused_occupancy_plain(torch.from_numpy(Y))
    got = fused.fused_walk_plain(ox, oy, torch.from_numpy(mask), block_m=bm, block_n=bn,
                                 m=x.shape[1])

    live_el = np.kron(mask != 0, np.ones((bm, bn), bool))  # (rows, cols) of x · Yᵀ
    nzx, badx = _chunk_bits(x)
    nzy, bady = _chunk_bits(Y)
    walked = live = 0
    for i in range(nzx.shape[0]):
        for j in range(nzy.shape[0]):
            if not live_el[128 * i:128 * (i + 1), 128 * j:128 * (j + 1)].any():
                continue
            live += 1
            walked += int(((nzx[i] & nzy[j]) | badx[i] | bady[j]).sum())
    assert got == (walked, live * (x.shape[1] // 32))
    assert 0 <= walked <= live * (x.shape[1] // 32)
    if name in ("ragged", "distinct_y", "dead_mask", "last_feature"):
        assert walked < live * (x.shape[1] // 32)  # the case skips chunks
    if name == "last_feature":
        assert got[0] == 1 + 4 * 1  # chunk 40 by (0, 0); chunk 63 by all four pairs
    if name == "zero_tile":  # the zero tile's pairs walk nothing
        assert walked == sum(int((nzx[i] & nzx[j]).sum())
                             for i in (0, 2) for j in (0, 2))


def test_k1_plain_version_reports_no_walk():
    """A call that runs the plain version leaves no counter to read."""
    x = torch.from_numpy(_zipf(128, 256, seed=7))
    fused.apss_fused_kernel(x, x, torch.ones((1, 1), dtype=torch.int32), 0.3, 4,
                            block_m=128, block_n=128, n_valid_cols=128)
    assert fused.last_walk() is None


def test_the_walk_is_read_only_by_telemetry(monkeypatch):
    """``apss_blocked(use_kernel=True)`` reads K1's counter (a wait on the
    card) only while a telemetry log is open."""
    from repro_torch.core.apss import apss_blocked
    from repro_torch.planner import CommLog

    def read():
        raise AssertionError("the walk was read")

    monkeypatch.setattr(fused, "last_walk", read)
    D = _zipf(256, 512, seed=8)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    apss_blocked(D, 0.3, 4, block_rows=128, use_kernel=True, device="cpu")
    with CommLog(), pytest.raises(AssertionError, match="was read"):
        apss_blocked(D, 0.3, 4, block_rows=128, use_kernel=True, device="cpu")
