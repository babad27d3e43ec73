"""The port's elastic re-mesh (``repro_torch.distributed.elastic``) in 4
gloo ranks on the CPU.

The reference's cases (``tests/test_substrates.py``, reshard to a smaller
mesh and the model axis kept) at 4 ranks in place of 8 devices: a
``(2, 2)`` mesh shrinks to ``(1, 2)`` and 3 ranks still give ``(1, 2)``.
A leaf comes back whole from either mesh, each rank holds its block, and
axis names the mesh lacks, or a dimension the mesh does not divide,
degrade to replication, as the reference's specs do. Also
``mesh_after_eviction`` with nothing evicted (the mesh itself) and with
every rank evicted (``ValueError``). One set of ranks runs every case
(``_torch_dist.elastic_ranks``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_dist import JOIN_TIMEOUT_S, PG_TIMEOUT_S  # noqa: E402
from repro.distributed.elastic import make_elastic_mesh as jmesh  # noqa: E402
from repro.distributed.elastic import reshard_tree as jreshard  # noqa: E402

W = np.arange(32, dtype=np.float32).reshape(8, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    run = tmp_path_factory.mktemp("elastic")
    return spawn("_torch_dist:elastic_ranks", 4, device="cpu", threads=1, run_dir=str(run),
                 pg_timeout=PG_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S)


def test_elastic_mesh_keeps_model_parallel(ranks):
    for out in ranks:
        assert out["big"] == (2, 2) and out["small"] == (1, 2) and out["odd"] == (1, 2)
        assert "cannot host model_parallel=2" in out["too_few"]
        assert out["describe"] == (
            "ElasticPlan(mesh={'data': 1, 'model': 2}, devices=2, reason='lost 2')")
    ref = jmesh(3, model_parallel=2)  # the reference's family at the same count
    assert (ref.shape["data"], ref.shape["model"]) == ranks[0]["odd"]


def test_elastic_reshard_to_smaller_mesh(ranks):
    big = jreshard({"w": W}, {"w": P("data", "model")},
                   jmesh(4, model_parallel=2, devices=jax.devices()[:4]))["w"]
    for rank, out in enumerate(ranks):
        np.testing.assert_array_equal(out["big_full"], W)
        d, m = divmod(rank, 2)  # row-major (data, model) coordinate
        np.testing.assert_array_equal(out["big_local"], W[4 * d:4 * d + 4, 2 * m:2 * m + 2])
        assert out["big_placements"] == ["S(0)", "S(1)"]
        # the reference places the same blocks on its devices
        shard = next(s for s in big.addressable_shards if s.device == jax.devices()[rank])
        np.testing.assert_array_equal(np.asarray(shard.data), out["big_local"])
    for rank, out in enumerate(ranks[:2]):
        np.testing.assert_array_equal(out["small_full"], W)
        np.testing.assert_array_equal(out["small_local"], W[:, 2 * rank:2 * rank + 2])
        assert out["small_devices"] == 2
    assert all("small_full" not in out for out in ranks[2:])


def test_specs_degrade_to_replication(ranks):
    """3 rows do not divide the data axis and 'expert' is no axis of the
    mesh: both leaves are replicated, as the reference's filtered specs."""
    for out in ranks:
        assert out["b_placements"] == [["R", "R"], ["R", "R"]]
        np.testing.assert_array_equal(out["b_full"][0], np.arange(3))
        np.testing.assert_array_equal(out["b_full"][1], np.ones((5, 2)))


def test_mesh_after_eviction_edges(ranks):
    for out in ranks:
        assert out["noop"]
        assert "evicts every rank" in out["all_evicted"]
