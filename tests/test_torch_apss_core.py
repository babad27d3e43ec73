"""Parity of the PyTorch port's dense self-join (``repro_torch.core``,
``repro_torch.data``, ``repro_torch.interop``) with the JAX package.

The same numpy inputs go through both packages on the CPU, under the
tolerance rule of ``_torch_parity``: no float64 score within 1e-5 of t;
then counts and match sets exactly equal, values within 1e-6, order equal
under (value desc, id asc).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (  # noqa: E402
    assert_clear_of_threshold,
    assert_same_matches,
    host,
    triple,
)
from repro.core import apss as japss  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import matches as jmatches  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import apss as tapss  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import matches as tmatches  # noqa: E402
from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.data import synthetic as tsynth  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
T, K = 0.35, 16


def _corp(n, m, seed, density=0.3):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
    D *= rng.random((n, m)) < density
    return D / np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)


def _cpu(a):
    return torch.tensor(np.asarray(a))


# -- package hygiene ----------------------------------------------------------


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.data, repro_torch.core.graph, "
        "repro_torch.core.sparse, repro_torch.data.sparse, "
        "repro_torch.kernels.apss_block.sparse, "
        "repro_torch.kernels.apss_block.apss_block, "
        "repro_torch.serving, repro_torch.serving.server, repro_torch.launch.serve, "
        "repro_torch.models.transformer, repro_torch.kernels.flash_attention, "
        "repro_torch.kernels.decode_attention, repro_torch.configs, "
        "repro_torch.core.distributed, repro_torch.launch.mesh, "
        "repro_torch.launch.apss_mesh; "
        "bad = sorted(m for m in sys.modules "
        "if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro'); "
        "print(bad)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, check=True,
    ).stdout.strip()
    assert out == "[]"


def test_entry_points_default_to_cuda_and_raise_without_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    from repro_torch import (
        apss_block_matmul,
        apss_fused,
        apss_fused_compacted,
        apss_sparse_compacted,
        from_dense,
    )
    from repro_torch.configs.qwen3_1_7b import smoke_config
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import LMServer
    from repro_torch.models.transformer import init_transformer, make_cache
    from repro_torch.serving import build_index, query_topk

    for call in (
        lambda: tapss.apss_blocked(corpus, T, K),
        lambda: tapss.apss_blocked(corpus, T, K, use_kernel=True),
        lambda: tapss.similarity_topk(corpus, corpus, T, K),
        lambda: tapss.apss_reference(corpus, T, K),
        lambda: apss_fused(corpus, corpus, T, K),
        lambda: apss_fused_compacted(corpus, T, K),
        lambda: apss_block_matmul(corpus, corpus, T),
        lambda: from_dense(corpus),
        lambda: apss_sparse_compacted(from_dense(corpus, device="cpu"), T, K),
        lambda: tapss.apss_blocked(from_dense(corpus, device="cpu"), T, K),
        lambda: build_index(corpus),
        lambda: build_index(from_dense(corpus, device="cpu")),
        lambda: query_topk(build_index(corpus), corpus[:4], T, K),  # the index's device
        lambda: init_transformer(smoke_config()),
        lambda: make_cache(smoke_config(), 1, 8),
        lambda: LMServer(smoke_config()),
        # The distributed entry points check the device before the mesh.
        lambda: tdist.apss_horizontal(corpus, T, K, None),
        lambda: tdist.apss_horizontal(corpus, T, K, None, use_kernel=True),
        lambda: tdist.apss_horizontal_hierarchical(corpus, T, K, None),
        lambda: tdist.apss_vertical(corpus, T, K, None),
        lambda: tdist.apss_2d(corpus, T, K, None),
        lambda: tdist.apss(from_dense(corpus, device="cpu"), T, K, None),
        lambda: spawn("repro_torch.launch.apss_mesh:run_variants", 2),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_auto_variant_raises_not_implemented(corpus):
    """``variant="auto"`` runs the planner (``test_torch_planner.py``); what
    it still refuses: the default device without a card (no CPU fallback),
    a rectangular join and any other variant."""
    with pytest.raises(RuntimeError, match="is_available"):
        tapss.similarity_topk(corpus, corpus, T, K, variant="auto", exclude_self=True)
    with pytest.raises(ValueError, match="self-join"):
        tapss.similarity_topk(corpus[:8], corpus, T, K, variant="auto", exclude_self=True,
                              device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        tapss.similarity_topk(corpus, corpus, T, K, variant="ring", device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apss_blocked_sparse_input_parity(corpus, use_kernel):
    """A JAX ``SparseCorpus`` carried across takes the port's sparse path and
    matches the JAX sparse path and the dense oracle."""
    from repro.core.sparse import from_dense

    sp = from_dense(jnp.asarray(corpus))
    assert_clear_of_threshold(corpus, corpus, T, exclude_self=True)
    carried = interop.sparse_corpus_from_numpy(
        np.asarray(sp.indices), np.asarray(sp.values), np.asarray(sp.nnz), sp.m, "cpu"
    )
    got = tapss.apss_blocked(carried, T, K, use_kernel=use_kernel, device="cpu")
    assert_same_matches(got, japss.apss_reference(jnp.asarray(corpus), T, K))
    assert_same_matches(got, japss.apss_blocked(sp, T, K))


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("synthetic_corpus", dict(n=50, m=300, avg_nnz=12.0, seed=3)),
        ("synthetic_corpus", dict(n=40, m=64, avg_nnz=5.0, zipf_alpha=0.8, seed=9)),
        ("clustered_corpus", dict(n=64, m=256, avg_nnz=6.0, n_clusters=4, seed=1)),
    ],
)
def test_synthetic_generators_byte_identical(name, kwargs):
    a = getattr(jsynth, name)(**kwargs)
    b = getattr(tsynth, name)(**kwargs)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_paper_like_corpus_and_stats_identical():
    assert tsynth.PAPER_DATASETS == jsynth.PAPER_DATASETS
    (a, ta), (b, tb) = (
        jsynth.paper_like_corpus("radikal", scale=0.01, seed=2),
        tsynth.paper_like_corpus("radikal", scale=0.01, seed=2),
    )
    assert ta == tb and a.tobytes() == b.tobytes()
    assert jsynth.corpus_stats(a).row() == tsynth.corpus_stats(b).row()


# -- matches ------------------------------------------------------------------


@pytest.mark.parametrize(
    "k,row_offset,col_offset,exclude_self,use_col_valid",
    [
        (8, 0, 0, True, False),
        (8, 5, 20, True, False),      # offsets put part of the diagonal in view
        (64, 0, 0, False, False),     # k > cols pads to capacity
        (8, 3, 3, True, True),
    ],
)
def test_extract_matches_parity(k, row_offset, col_offset, exclude_self, use_col_valid):
    rng = np.random.default_rng(4)
    S = rng.uniform(-1, 1, (37, 50)).astype(np.float32)
    t = 0.1
    assert np.abs(S.astype(np.float64) - t).min() > 1e-5
    col_valid = (np.arange(50) < 41) if use_col_valid else None
    kw = dict(row_offset=row_offset, col_offset=col_offset, exclude_self=exclude_self)
    ref = jmatches.extract_matches(
        jnp.asarray(S), t, k, **kw,
        col_valid=None if col_valid is None else jnp.asarray(col_valid),
    )
    got = tmatches.extract_matches(
        _cpu(S), t, k, **kw,
        col_valid=None if col_valid is None else _cpu(col_valid),
    )
    assert got.indices.dtype == torch.int32 and got.counts.dtype == torch.int32
    assert_same_matches(got, ref)


def test_merge_matches_parity():
    rng = np.random.default_rng(5)
    S = rng.uniform(-1, 1, (20, 60)).astype(np.float32)
    t, k = 0.2, 6
    halves = [(S[:, :30], 0), (S[:, 30:], 30)]
    kw = dict(exclude_self=False)
    ja = [jmatches.extract_matches(jnp.asarray(s), t, k, col_offset=o, **kw)
          for s, o in halves]
    ta = [tmatches.extract_matches(_cpu(s), t, k, col_offset=o, **kw)
          for s, o in halves]
    ref = jmatches.merge_matches(*ja)
    got = tmatches.merge_matches(*ta)
    assert_same_matches(got, ref)
    whole = tmatches.extract_matches(_cpu(S), t, k, exclude_self=False)
    assert_same_matches(got, whole)
    assert int(tmatches.total_matches(got)) == int(jmatches.total_matches(ref))
    np.testing.assert_array_equal(host(got.overflowed()), host(ref.overflowed()))


# -- pruning ------------------------------------------------------------------


@pytest.mark.parametrize("use_minsize", [True, False])
def test_block_stats_and_live_mask_parity(use_minsize):
    D = tsynth.clustered_corpus(256, 128, 6, n_clusters=4, seed=2)
    js = jpruning.dense_block_stats(jnp.asarray(D), 32)
    ts = tpruning.dense_block_stats(_cpu(D), 32)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(host(b), np.asarray(a))
    assert ts.max_nnz.dtype == torch.int32
    t = 0.3
    kw = dict(use_minsize=use_minsize, return_ub=True)
    jl, jub = jpruning.live_tile_mask(js, js, t, **kw)
    tl, tub = tpruning.live_tile_mask(ts, ts, t, **kw)
    np.testing.assert_allclose(host(tub), np.asarray(jub), rtol=1e-6)
    np.testing.assert_array_equal(host(tl), np.asarray(jl))
    assert 0 < int(np.asarray(jl).sum()) < jl.size  # both live and dead tiles

    # JAX's stats, carried across, give the same mask in the port.
    carried = interop.block_stats_from_numpy(*(np.asarray(a) for a in js), "cpu")
    np.testing.assert_array_equal(
        host(tpruning.live_tile_mask(carried, carried, t, use_minsize=use_minsize)),
        np.asarray(jl),
    )


@pytest.mark.parametrize("chunk_bytes", [1, 3 * 32 * 128 * 4])
def test_dense_block_stats_in_chunks_equal_jax(monkeypatch, chunk_bytes):
    """Stats taken a row block (or three) at a time equal the one-pass
    reference's; the last chunk may hold fewer blocks."""
    monkeypatch.setattr(tpruning, "STATS_CHUNK_BYTES", chunk_bytes)
    D = tsynth.clustered_corpus(256, 128, 6, n_clusters=4, seed=2)
    js = jpruning.dense_block_stats(jnp.asarray(D), 32)
    for a, b in zip(js, tpruning.dense_block_stats(_cpu(D), 32)):
        np.testing.assert_array_equal(host(b), np.asarray(a))


def test_block_prune_mask_prune_stats_and_bounds_parity(corpus):
    D = corpus
    for kw in (dict(), dict(use_minsize=False), dict(block_cols=64)):
        ref = jpruning.block_prune_mask(jnp.asarray(D), jnp.asarray(D), T, 32, **kw)
        got = tpruning.block_prune_mask(_cpu(D), _cpu(D), T, 32, **kw)
        np.testing.assert_array_equal(host(got), np.asarray(ref))
    jstats = jpruning.prune_stats(ref)
    tstats = tpruning.prune_stats(got)
    for a, b in zip(jstats, tstats):
        np.testing.assert_allclose(host(b), np.asarray(a))
    np.testing.assert_array_equal(
        host(tpruning.row_nnz(_cpu(D))), np.asarray(jpruning.row_nnz(jnp.asarray(D)))
    )
    np.testing.assert_allclose(
        host(tpruning.local_threshold(0.9, 4)),
        np.asarray(jpruning.local_threshold(0.9, 4)),
    )


# -- apss ---------------------------------------------------------------------


def test_normalize_and_pad_rows_parity():
    rng = np.random.default_rng(6)
    X = rng.standard_normal((30, 20)).astype(np.float32)
    X[3] = 0.0
    np.testing.assert_allclose(
        host(tapss.normalize_rows(_cpu(X))),
        np.asarray(japss.normalize_rows(jnp.asarray(X))),
        rtol=1e-6, atol=1e-7,
    )
    p, n = tapss.pad_rows(_cpu(X), 16)
    q, n2 = japss.pad_rows(jnp.asarray(X), 16)
    assert n == n2 == 30
    np.testing.assert_array_equal(host(p), np.asarray(q))


def test_apss_reference_parity(corpus):
    assert_clear_of_threshold(corpus, corpus, T, exclude_self=True)
    ref = japss.apss_reference(jnp.asarray(corpus), T, K)
    got = tapss.apss_reference(corpus, T, K, device="cpu")
    assert_same_matches(got, ref)


def _clustered():
    return tsynth.clustered_corpus(300, 192, 10, n_clusters=3, seed=4)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("which", ["conftest", "clustered"])
def test_apss_blocked_parity(corpus, use_kernel, which):
    D, t = (corpus, T) if which == "conftest" else (_clustered(), 0.4)
    assert_clear_of_threshold(D, D, t, exclude_self=True)
    ref = japss.apss_reference(jnp.asarray(D), t, K)
    got, stats = tapss.apss_blocked(
        D, t, K, block_rows=128, use_kernel=use_kernel, with_prune_stats=True,
        device="cpu",
    )
    assert_same_matches(got, ref)
    _, jstats = japss.apss_blocked(
        jnp.asarray(D), t, K, block_rows=128, with_prune_stats=True
    )
    for a, b in zip(jstats, stats):
        np.testing.assert_allclose(host(b), np.asarray(a))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_similarity_topk_offsets_parity(use_kernel):
    Q = _corp(37, 80, seed=3)
    C = _corp(90, 80, seed=4)
    t = 0.2
    assert_clear_of_threshold(Q, C, t)
    kw = dict(block_rows=16, row_offset=50, col_offset=40, exclude_self=True)
    ref = japss.similarity_topk(jnp.asarray(Q), jnp.asarray(C), t, 8, **kw)
    got = tapss.similarity_topk(Q, C, t, 8, use_kernel=use_kernel, device="cpu", **kw)
    assert_same_matches(got, ref)
    # The offsets put global rows 50..86 against columns 40..129: the self
    # pairs 50..86 are in view and excluded.
    assert int(np.asarray(ref.counts).sum()) > 0


def test_similarity_topk_col_valid_parity():
    Q = _corp(21, 40, seed=7)
    C = _corp(33, 40, seed=8)
    t = 0.25
    assert_clear_of_threshold(Q, C, t)
    valid = np.arange(33) % 3 != 0
    ref = japss.similarity_topk(
        jnp.asarray(Q), jnp.asarray(C), t, 8, block_rows=8, col_valid=jnp.asarray(valid)
    )
    got = tapss.similarity_topk(
        Q, C, t, 8, block_rows=8, col_valid=_cpu(valid), device="cpu"
    )
    assert_same_matches(got, ref)
    with pytest.raises(ValueError, match="col_valid"):
        tapss.similarity_topk(
            Q, C, t, 8, col_valid=_cpu(valid), use_kernel=True, device="cpu"
        )


# -- graph + interop ----------------------------------------------------------


def test_graph_helpers_and_interop_parity(corpus):
    ref = japss.apss_reference(jnp.asarray(corpus), T, K)
    carried = interop.matches_from_numpy(
        np.asarray(ref.values), np.asarray(ref.indices), np.asarray(ref.counts), "cpu"
    )
    for a, b in zip(interop.matches_to_numpy(carried), interop.matches_to_numpy(ref)):
        np.testing.assert_array_equal(a, b)
    assert tgraph.match_set(carried) == jgraph.match_set(ref)
    for undirected in (True, False):
        for a, b in zip(
            tgraph.matches_to_coo(carried, undirected=undirected),
            jgraph.matches_to_coo(ref, undirected=undirected),
        ):
            np.testing.assert_array_equal(a, b)
    r, c, w = tgraph.matches_to_coo(carried)
    e = 2 * len(r) + corpus.shape[0]
    for a, b in zip(
        tgraph.coo_to_padded_edges(r, c, w, e + 5, add_self_loops_n=corpus.shape[0]),
        jgraph.coo_to_padded_edges(r, c, w, e + 5, add_self_loops_n=corpus.shape[0]),
    ):
        np.testing.assert_array_equal(a, b)
    D = interop.corpus_from_numpy(corpus, "cpu")
    assert D.dtype == torch.float32 and triple(carried)[1].dtype == np.int32
