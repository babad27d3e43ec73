"""Parity of the port's distributed APSS with the JAX package's on sparse
(padded-CSR) corpora, of the dimension split (``shard_dims``,
``dim_slices``) and of the candidate helpers of the compressed and
recursive accumulations.

As in ``test_torch_distributed.py``: one set of 4 gloo ranks and one of 3
run every variant once; each case holds one variant against the
reference's ``apss`` on the same ``SparseCorpus`` (the port's made from the
reference's arrays).
"""

from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_dist import K, T, jax_run, run_ranks, variant  # noqa: E402
from _torch_parity import assert_clear_of_threshold, assert_same_matches  # noqa: E402
from repro.core import distributed as jd  # noqa: E402
from repro.core import matches as jm  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import matches as tm  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.interop import sparse_corpus_from_numpy, sparse_corpus_to_numpy  # noqa: E402

ROW4, MODEL4, GRID = ((4,), ("data",)), ((4,), ("model",)), ((2, 2), ("data", "model"))
SP = dict(corpus="sparse")

VARIANTS4 = [
    *(variant(f"horizontal_{s}", "horizontal", *ROW4, gather="data", schedule=s,
              block_rows=16, **SP) for s in ("allgather", "ring", "halfring")),
    variant("hierarchical", "hierarchical", (2, 2), ("pod", "data"), gather=("pod", "data"),
            axes=("pod", "data"), block_rows=16, **SP),
    *(variant(f"vertical_{a}", "vertical", *MODEL4, gather="model" if a == "scatter" else None,
              scatter=a == "scatter", axis_name="model", accumulation=a, block_rows=32,
              candidate_capacity=128, return_stats=True, **SP)
      for a in ("allreduce", "scatter", "compressed", "recursive")),
    *(variant(f"2d_{a}", "2d", *GRID, gather="data", accumulation=a, block_rows=16,
              candidate_capacity=128, return_stats=True, ticks=True, **SP)
      for a in ("allreduce", "compressed")),
]
VARIANTS3 = [
    variant(f"odd_{s}", "horizontal", (3,), ("data",), gather="data", schedule=s,
            block_rows=13, **SP) for s in ("ring", "halfring")
]


def _padded(corpus):
    """129 rows, so that 3 ranks divide them (a zero row: no matches)."""
    return np.concatenate([corpus, np.zeros((1, corpus.shape[1]), np.float32)])


def _save_csr(path, D) -> str:
    idx, val, nnz, m = sparse_corpus_to_numpy(jsparse.from_dense(jnp.asarray(D)))
    np.savez(path, indices=idx, values=val, nnz=nnz, m=m)
    return str(path)


@pytest.fixture(scope="module")
def ranks(corpus, tmp_path_factory):
    run = tmp_path_factory.mktemp("torch_distributed_sparse")
    out = run_ranks(run, 4, {"sparse": _save_csr(run / "s4.npz", corpus)}, VARIANTS4)
    out.update(run_ranks(run, 3, {"sparse": _save_csr(run / "s3.npz", _padded(corpus))},
                         VARIANTS3))
    return out


@pytest.mark.parametrize("v", VARIANTS4, ids=lambda v: v["name"])
def test_four_ranks_equal_jax(ranks, corpus, v):
    ref, stats = jax_run(jsparse.from_dense(jnp.asarray(corpus)), v)
    rec = ranks[v["name"]]
    assert_clear_of_threshold(corpus, corpus, T, exclude_self=True)
    assert_same_matches(td.Matches(*rec["matches"]), ref)
    if stats is not None:
        assert rec["overflow_rows"] == int(stats.overflow_rows) == 0


@pytest.mark.parametrize("v", VARIANTS3, ids=lambda v: v["name"])
def test_three_ranks_odd_ring_equal_jax(ranks, corpus, v):
    D = _padded(corpus)
    ref, _ = jax_run(jsparse.from_dense(jnp.asarray(D)), v)
    assert_clear_of_threshold(D, D, T, exclude_self=True)
    assert_same_matches(td.Matches(*ranks[v["name"]]["matches"]), ref)


@pytest.mark.parametrize("name", ["2d_allreduce", "2d_compressed"])
def test_step_ticker_ticks_once_per_rank_and_ring_step(ranks, name):
    """``StepTicker`` through the 2-D sweep's seam: on the (2, 2) grid every
    one of the 4 ranks ticks each of the q = 2 ring steps exactly once."""
    assert [tuple(t) for t in ranks[name]["ticks"]] == [(r, s) for r in range(4)
                                                        for s in range(2)]


def test_csr_triple_travels_instead_of_dense_rows(ranks, corpus):
    """The sparse ring hops the CSR triple of each block: ``(n/p) · cap``
    ids and values and ``n/p`` counts, 3 hops at p = 4."""
    cap = int(jsparse.from_dense(jnp.asarray(corpus)).cap)
    n_loc = corpus.shape[0] // 4
    assert ranks["horizontal_ring"]["wire_bytes"][0]["ppermute"] == 3 * n_loc * (8 * cap + 4)


def _mesh(shape, names):
    return SimpleNamespace(shape=shape, mesh_dim_names=names, get_local_rank=lambda a: 0)


@pytest.mark.parametrize("call", [
    lambda sp: td.apss_horizontal(sp, T, K, _mesh((4,), ("data",)), use_kernel=True,
                                  device="cpu"),
    lambda sp: td.apss_horizontal_hierarchical(sp, T, K, _mesh((2, 2), ("pod", "data")),
                                               use_kernel=True, device="cpu"),
    lambda sp: td.apss_horizontal(sp, T, K, _mesh((2, 2), ("pod", "data")), ("pod", "data"),
                                  schedule="allgather", device="cpu"),
], ids=["horizontal_kernel", "hierarchical_kernel", "two_axes"])
def test_sparse_rejects_what_the_reference_rejects(corpus, call):
    with pytest.raises(ValueError):
        call(tsparse.from_dense(corpus, device="cpu"))


# ---------------------------------------------------------------------------
# The dimension split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_shard_dims_equals_jax(corpus, p):
    ref = jsparse.shard_dims(jsparse.from_dense(jnp.asarray(corpus)), p)
    got = tsparse.shard_dims(tsparse.from_dense(corpus, device="cpu"), p)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g, r)
    assert got[3] == ref[3]


def test_dim_slices_equal_jax_and_rebuild_the_corpus(corpus):
    ref = jsparse.dim_slices(jsparse.from_dense(jnp.asarray(corpus)), 4)
    got = tsparse.dim_slices(tsparse.from_dense(corpus, device="cpu"), 4)
    for g, r in zip(got, ref):
        for a, b in zip(sparse_corpus_to_numpy(g), sparse_corpus_to_numpy(r)):
            np.testing.assert_array_equal(a, b)
    dense = np.concatenate([tsparse.to_dense(g).numpy() for g in got], axis=1)
    np.testing.assert_array_equal(dense, corpus)


def test_shard_dims_rejects_indivisible_width(corpus):
    with pytest.raises(ValueError, match="multiple"):
        tsparse.shard_dims(tsparse.from_dense(corpus, device="cpu"), 5)


# ---------------------------------------------------------------------------
# Candidate helpers, without ranks. Scores are drawn on a coarse grid so that
# ties are common: ties must go to the lower position, as ``lax.top_k`` does.
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 2]


def _scores(seed, rows=12, cols=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, (rows, cols)) / 32).astype(np.float32)


def _ids(seed, rows=12, cols=24, hi=30):
    """Candidate id lists with repeats and -1 empties."""
    rng = np.random.default_rng(seed + 100)
    ids = rng.integers(-1, hi, (rows, cols)).astype(np.int32)
    return ids


@pytest.mark.parametrize("seed", SEEDS)
def test_local_candidates_equal_jax(seed):
    A = _scores(seed)
    ref = jd._local_candidates(jnp.asarray(A), jnp.float32(0.2), 8)
    got = td._local_candidates(torch.from_numpy(A), torch.tensor(0.2), 8)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", SEEDS)
def test_pairwise_merge_candidates_equal_jax(seed):
    rng = np.random.default_rng(seed)
    args = []
    for side in range(2):
        ids = np.stack([rng.permutation(20)[:8] for _ in range(12)]).astype(np.int32)
        ids[rng.random(ids.shape) < 0.2] = -1
        val = (rng.integers(0, 8, ids.shape) / 16).astype(np.float32)
        ub = np.where(ids >= 0, val + 0.125, -np.inf).astype(np.float32)
        args += [ids, np.where(ids >= 0, val, 0).astype(np.float32), ub]
    ref = jd._pairwise_merge_candidates(*map(jnp.asarray, args), 6)
    got = td._pairwise_merge_candidates(*map(torch.from_numpy, args), 6)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", SEEDS)
def test_dedupe_candidates_equal_jax(seed):
    ids = _ids(seed)
    val = _scores(seed, cols=ids.shape[1])
    ref = jm.dedupe_candidates(jnp.asarray(val), jnp.asarray(ids))
    got = tm.dedupe_candidates(torch.from_numpy(val), torch.from_numpy(ids))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", SEEDS)
def test_matches_from_candidates_equal_jax(seed):
    ids = _ids(seed)
    val = _scores(seed, cols=ids.shape[1])
    for dedupe in (True, False):
        kw = dict(row_offset=3, exclude_self=True, dedupe=dedupe)
        ref = jm.matches_from_candidates(jnp.asarray(val), jnp.asarray(ids), 0.2, 6, **kw)
        got = tm.matches_from_candidates(torch.from_numpy(val), torch.from_numpy(ids), 0.2, 6,
                                         **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_port_sparse_corpus_round_trips(corpus):
    """The corpus the ranks load is the reference's, field for field."""
    ref = jsparse.from_dense(jnp.asarray(corpus))
    got = sparse_corpus_from_numpy(*sparse_corpus_to_numpy(ref), device="cpu")
    for a, b in zip(sparse_corpus_to_numpy(got), sparse_corpus_to_numpy(ref)):
        np.testing.assert_array_equal(a, b)
