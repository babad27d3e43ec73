"""The port's numpy data pipelines (``repro_torch.data.pipeline``,
``data.sampler``) against the reference's: every batch equal array for
array, over several seeds and steps, for the LM, recsys (two-tower, seq,
ctr) and graph pipelines, the neighbor sampler and ``sampled_shape``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import sampler as jsampler  # noqa: E402
from repro_torch.data import (  # noqa: E402
    GraphPipeline,
    LMDataPipeline,
    RecsysPipeline,
    neighbor_sample,
    sampled_shape,
)

SEEDS = (0, 3)
STEPS = (0, 1, 7)


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("seed", SEEDS)
def test_lm_pipeline_equals_the_reference(seed):
    for step in STEPS:
        _assert_same(LMDataPipeline(500, 4, 16, seed=seed).get_batch(step),
                     jpipe.LMDataPipeline(500, 4, 16, seed=seed).get_batch(step))


@pytest.mark.parametrize("kind", ["two-tower", "seq", "ctr"])
@pytest.mark.parametrize("seed", SEEDS)
def test_recsys_pipeline_equals_the_reference(kind, seed):
    kw = dict(n_items=1000, batch_size=8, history_len=12, n_user_fields=3, user_vocab=50,
              seed=seed, kind=kind)
    for step in STEPS:
        _assert_same(RecsysPipeline(**kw).get_batch(step),
                     jpipe.RecsysPipeline(**kw).get_batch(step))


@pytest.mark.parametrize("seed", SEEDS)
def test_graph_pipeline_equals_the_reference(seed):
    got, want = GraphPipeline(300, 2000, 16, seed=seed), jpipe.GraphPipeline(300, 2000, 16,
                                                                              seed=seed)
    _assert_same(got.full_graph(), want.full_graph())
    for a, b in zip(got.csr(), want.csr()):
        np.testing.assert_array_equal(a, b)
    for step in STEPS:
        _assert_same(got.batched_small_graphs(4, 10, 20, step),
                     want.batched_small_graphs(4, 10, 20, step))


@pytest.mark.parametrize("seed", SEEDS)
def test_neighbor_sample_equals_the_reference(seed):
    pipe = GraphPipeline(500, 5000, 8, seed=seed)
    indptr, idx = pipe.csr()
    g = pipe.full_graph()
    seeds = np.random.default_rng(seed).choice(500, 16, replace=False)
    args = (indptr, idx, seeds, (5, 3), g["features"], g["labels"])
    got, want = neighbor_sample(*args, seed=seed), jsampler.neighbor_sample(*args, seed=seed)
    _assert_same(got, want)
    assert (got["features"].shape[0], got["edge_src"].shape[0]) == sampled_shape(16, (5, 3))


def test_sampled_shape_equals_the_reference():
    for batch, fanouts in ((1024, (15, 10)), (16, (5, 3)), (7, (2, 2, 2))):
        assert sampled_shape(batch, fanouts) == jsampler.sampled_shape(batch, fanouts)
