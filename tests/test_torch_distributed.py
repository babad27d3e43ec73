"""Parity of the port's distributed APSS (``repro_torch.core.distributed``)
with the JAX package's, on dense corpora.

One set of 4 gloo ranks (spawned on the CPU) runs every 4-way variant once,
and one set of 3 ranks the odd-p ring, halfring and allgather; each case holds one
variant's gathered ``Matches`` against the reference's ``apss`` on a JAX
mesh over the same number of virtual CPU devices: counts and match sets
exact, values within ``VAL_TOL``, rows in (value desc, id asc) order.
"""

from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_dist import K, T, jax_run, run_ranks, variant  # noqa: E402
from _torch_parity import assert_clear_of_threshold, assert_same_matches  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402

ROW4, MODEL4, GRID = ((4,), ("data",)), ((4,), ("model",)), ((2, 2), ("data", "model"))
PODS = ((2, 2), ("pod", "data"))
STATS = dict(block_rows=32, candidate_capacity=128, return_stats=True)

VARIANTS4 = [
    *(variant(f"horizontal_{s}", "horizontal", *ROW4, gather="data", schedule=s,
              block_rows=16) for s in ("allgather", "ring", "halfring")),
    variant("horizontal_ring_kernel", "horizontal", *ROW4, gather="data", schedule="ring",
            block_rows=16, use_kernel=True),
    variant("horizontal_allgather_pods", "horizontal", *PODS, gather=("pod", "data"),
            axis_name=("pod", "data"), schedule="allgather", block_rows=16),
    variant("hierarchical", "hierarchical", *PODS, gather=("pod", "data"),
            axes=("pod", "data"), block_rows=16),
    *(variant(f"vertical_{a}", "vertical", *MODEL4, gather="model" if a == "scatter" else None,
              scatter=a == "scatter", axis_name="model", accumulation=a, **STATS)
      for a in ("allreduce", "scatter", "compressed", "recursive")),
    *(variant(f"2d_{a}", "2d", *GRID, gather="data", accumulation=a, block_rows=16,
              candidate_capacity=128, return_stats=True) for a in ("allreduce", "compressed")),
    # A tiny capacity at a low threshold truncates candidate sets: the
    # overflow counters must equal the reference's.
    *(variant(f"overflow_vertical_{a}", "vertical", *MODEL4, threshold=0.05,
              axis_name="model", accumulation=a, block_rows=32, candidate_capacity=4,
              return_stats=True) for a in ("compressed", "recursive")),
    variant("overflow_2d_compressed", "2d", *GRID, gather="data", threshold=0.05,
            accumulation="compressed", block_rows=16, candidate_capacity=4, return_stats=True),
]
VARIANTS3 = [
    variant(f"odd_{s}", "horizontal", (3,), ("data",), gather="data", schedule=s, block_rows=13)
    for s in ("ring", "halfring", "allgather")
]
EXACT4 = [v for v in VARIANTS4 if not v["name"].startswith("overflow")]
OVERFLOW4 = [v for v in VARIANTS4 if v["name"].startswith("overflow")]


def _padded(corpus):
    """129 rows, so that 3 ranks divide them (a zero row: no matches)."""
    return np.concatenate([corpus, np.zeros((1, corpus.shape[1]), np.float32)])


@pytest.fixture(scope="module")
def ranks(corpus, tmp_path_factory):
    run = tmp_path_factory.mktemp("torch_distributed")
    np.save(run / "d4.npy", corpus)
    np.save(run / "d3.npy", _padded(corpus))
    out = run_ranks(run, 4, {"dense": str(run / "d4.npy")}, VARIANTS4)
    out.update(run_ranks(run, 3, {"dense": str(run / "d3.npy")}, VARIANTS3))
    return out


def _assert_parity(got, ref, D):
    assert_clear_of_threshold(D, D, T, exclude_self=True)
    assert_same_matches(td.Matches(*got), ref)


@pytest.mark.parametrize("v", EXACT4, ids=lambda v: v["name"])
def test_four_ranks_equal_jax(ranks, corpus, v):
    ref, stats = jax_run(jnp.asarray(corpus), v)
    rec = ranks[v["name"]]
    _assert_parity(rec["matches"], ref, corpus)
    if stats is not None:
        assert rec["overflow_rows"] == int(stats.overflow_rows) == 0
    assert rec["launches"]["apss_fused"] == 0  # the CPU runs K1's plain version


@pytest.mark.parametrize("v", VARIANTS3, ids=lambda v: v["name"])
def test_three_ranks_odd_ring_equal_jax(ranks, corpus, v):
    D = _padded(corpus)
    ref, _ = jax_run(jnp.asarray(D), v)
    _assert_parity(ranks[v["name"]]["matches"], ref, D)
    assert not ranks[v["name"]]["matches"][2][128:].any()  # zero rows hold no match


@pytest.mark.parametrize("v", OVERFLOW4, ids=lambda v: v["name"])
def test_overflow_rows_equal_jax(ranks, corpus, v):
    _, stats = jax_run(jnp.asarray(corpus), v)
    assert ranks[v["name"]]["overflow_rows"] == int(stats.overflow_rows) > 0


def test_wire_bytes_follow_the_schedules(ranks, corpus):
    """Bytes rank 0 sent: the ring hops its block p - 1 times, the halfring
    ⌊p/2⌋ times plus a caravan of matches per hop and one home shift."""
    n, m = corpus.shape
    block, caravan = n // 4 * m * 4, n // 4 * (K * 8 + 4)
    sent = {name: ranks[name]["wire_bytes"][0] for name in ranks}
    assert sent["horizontal_ring"]["ppermute"] == 3 * block
    assert sent["horizontal_halfring"]["ppermute"] == 2 * block + 3 * caravan
    assert sent["horizontal_allgather"]["all_gather"] == block
    assert sent["hierarchical"]["ppermute"] == 3 * (block + 4)  # the block and its owner id
    assert sent["vertical_allreduce"]["psum"] == n * n * 4


def _mesh(shape, names, me=0):
    """A stand-in mesh: the entry points check shapes before any collective."""
    return SimpleNamespace(shape=shape, mesh_dim_names=names, get_local_rank=lambda a: me)


@pytest.mark.parametrize("call, exc, match", [
    (lambda D: td.apss_horizontal(D[:127], T, K, _mesh((4,), ("data",)), device="cpu"),
     ValueError, "multiple of 4"),
    (lambda D: td.apss_horizontal(D, T, K, _mesh((2, 2), ("pod", "data")), ("pod", "data"),
                                  schedule="ring", device="cpu"), ValueError, "single axis"),
    (lambda D: td.apss_horizontal(D, T, K, _mesh((4,), ("data",)), schedule="tree",
                                  device="cpu"), ValueError, "unknown horizontal"),
    (lambda D: td.apss_vertical(D, T, K, _mesh((4,), ("model",)), block_rows=48,
                                device="cpu"), ValueError, "block_rows"),
    (lambda D: td.apss_vertical(D, T, K, _mesh((3,), ("model",)), accumulation="scatter",
                                block_rows=32, device="cpu"), ValueError, "block_rows % p"),
    (lambda D: td.apss_vertical(D, T, K, _mesh((3,), ("model",)), accumulation="recursive",
                                block_rows=32, device="cpu"), ValueError, "power-of-two"),
    (lambda D: td.apss_vertical(D, T, K, _mesh((4,), ("model",)), accumulation="tree",
                                block_rows=32, device="cpu"), ValueError, "unknown vertical"),
    (lambda D: td.apss_2d(D, T, K, _mesh((2, 2), ("data", "model")), accumulation="scatter",
                          device="cpu"), ValueError, "unknown 2-D"),
    (lambda D: td.apss(D, T, K, None, distribution="auto"), NotImplementedError, "item 5"),
    (lambda D: td.apss(D, T, K, None, distribution="star"), ValueError, "unknown distribution"),
], ids=["rows", "ring_axes", "schedule", "block_rows", "scatter", "recursive", "accumulation",
        "2d_accumulation", "auto", "distribution"])
def test_entry_points_reject_bad_shapes_and_options(corpus, call, exc, match):
    with pytest.raises(exc, match=match):
        call(corpus)


def test_candidate_capacity_default_matches_reference():
    from repro.core.distributed import default_candidate_capacity

    for k in (1, 8, 16, 100):
        assert td.default_candidate_capacity(k) == default_candidate_capacity(k)
