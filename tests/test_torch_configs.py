"""The port's ``apss`` architecture (``repro_torch.configs.apss_paper``) and
the cell plumbing of ``configs/base.py`` against the JAX package's.

Every cell, built from the full ``config()`` on a (2, 2) ``("data",
"model")`` mesh description (no ranks) and on a (4,) ``("data",)`` one,
has the reference's argument shapes and dtypes (meta tensors there,
``ShapeDtypeStruct`` here), its filtered input specs and its
``static_info``. Then each cell's ``fn``, cut to n = 512, m = 192, runs in
4 gloo ranks (one spawn, ``_torch_dist.apss_cell_runs``) and equals the
reference's cell ``fn`` on a (2, 2) mesh of virtual CPU devices under the
parity rule (``_torch_parity``): rank 0's global result, which it
gathered from every rank (``launch.apss_mesh.run_cells``); the two ring cells are held
position by position without the (value desc, id asc) check, since a ring
keeps an exact tie between two steps in step order, as the reference does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_dist import apss_cell_config, apss_cell_runs, jax_mesh  # noqa: E402
from _torch_parity import (  # noqa: E402
    VAL_TOL,
    assert_clear_of_threshold,
    assert_same_matches,
    triple,
)
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.matches import Matches  # noqa: E402
from repro_torch.data.synthetic import synthetic_corpus  # noqa: E402

CELLS = ["h_allgather", "h_ring", "v_compressed", "grid_2d"]
MESHES = [((2, 2), ("data", "model")), ((4,), ("data",))]


def _norm(spec) -> tuple:
    """A spec with one-axis tuples written as the axis (JAX normalises
    ``P(("data",), None)`` to ``P("data", None)``; both mean the same)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def test_arch_and_configs_equal_the_reference():
    arch, ref = get_arch("apss"), jget_arch("apss")
    assert (arch.family, arch.source) == (ref.family, ref.source) == ("apss", ref.source)
    assert sorted(arch.shapes) == sorted(ref.shapes) == sorted(CELLS)
    assert arch.make_config() == ref.make_config()
    assert arch.make_smoke_config() == ref.make_smoke_config()
    for name in CELLS:
        assert arch.cell(name).kind == ref.cell(name).kind
        assert arch.cell(name).desc == ref.cell(name).desc


@pytest.mark.parametrize("shape,names", MESHES, ids=["2x2", "4"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_builds_equal_the_reference(name, shape, names):
    desc = dict(zip(names, shape))
    got = get_arch("apss").cell(name).build(get_arch("apss").make_config(), desc)
    want = jget_arch("apss").cell(name).build(jget_arch("apss").make_config(),
                                              jax_mesh(shape, names))
    assert callable(got.fn) and got.out_shardings is want.out_shardings is None
    assert len(got.args) == len(want.args) == 1
    for a, b in zip(got.args, want.args):
        assert a.device.type == "meta"
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    assert [_norm(s) for s in got.in_shardings] == [_norm(s.spec) for s in want.in_shardings]
    assert got.static_info == want.static_info


def test_shardings_for_and_mesh_helpers():
    mesh = {"pod": 2, "data": 2}
    assert base.shardings_for(mesh, {"a": (("pod", "data", "model"), None),
                                     "b": [("model", "data")]}) == \
        {"a": (("pod", "data"), None), "b": [(None, "data")]}
    assert base.data_axes_of(mesh) == ("pod", "data")
    assert base.data_axes_of({"model": 4}) == ()
    x = base.meta((3, 4), torch.bfloat16)
    assert x.device.type == "meta" and x.dtype == torch.bfloat16 and x.shape == (3, 4)
    with pytest.raises(KeyError):
        get_arch("apss").cell("nope")


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    run = tmp_path_factory.mktemp("torch_configs")
    c = apss_cell_config({})["20news"]
    D = synthetic_corpus(c["n"], c["m"], 12.0, seed=16)  # clear of t
    np.save(run / "d.npy", D)
    return D, c["t"], apss_cell_runs(run, str(run / "d.npy"))


@pytest.mark.parametrize("name", CELLS)
def test_cells_in_four_ranks_equal_the_reference(cell_runs, name):
    D, t, ranks = cell_runs
    assert_clear_of_threshold(D, D, t, exclude_self=True)
    assert all(r[name]["matches"] is None for r in ranks[1:])  # rank 0 reports
    ref_arch = jget_arch("apss")
    build = ref_arch.cell(name).build(apss_cell_config(ref_arch.make_config()),
                                      jax_mesh((2, 2), ("data", "model")))
    want = build.fn(jax.device_put(D, build.in_shardings[0]))
    got = Matches(*(torch.from_numpy(a) for a in ranks[0][name]["matches"]))
    if name in ("h_ring", "grid_2d"):
        # A ring merges its steps' lists in step order, so an exact tie
        # between two steps keeps that order, in the reference as here
        # (row 432 of this corpus): hold ids position by position.
        gv, gi, gc = triple(got)
        rv, ri, rc = triple(want)
        np.testing.assert_array_equal(gc, rc)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gv, rv, atol=VAL_TOL)
    else:
        assert_same_matches(got, want)


def test_dense_view_densifies_only_the_cell():
    from repro_torch.core.sparse import DenseView, from_dense, to_dense

    D = synthetic_corpus(40, 70, 6.0, seed=1)
    sp = from_dense(D, device="cpu")
    view = DenseView(sp)
    assert view.shape == (40, 70)
    for rows, cols in [(slice(None), slice(None)), (slice(8, 24), slice(35, 70)),
                       (slice(0, 10), slice(0, 17))]:
        np.testing.assert_array_equal(view.dense_cell(rows, cols, "cpu").numpy(), D[rows, cols])
    np.testing.assert_array_equal(to_dense(sp).numpy(), D)


def test_bulk_zipf_generator_follows_the_row_by_row_law():
    """``sparse_zipfian_bulk`` (the smoke's 20news and wikipedia stand-ins)
    draws the same nnz as ``sparse_zipfian_corpus`` and dims by the same
    law: unique sorted coordinates, unit rows, dim frequencies close."""
    from repro_torch.data.sparse import sparse_zipfian_bulk, sparse_zipfian_corpus

    a = sparse_zipfian_bulk(3000, 5000, 30.0, seed=1, device="cpu")
    b = sparse_zipfian_corpus(3000, 5000, 30.0, seed=1, device="cpu")
    np.testing.assert_array_equal(a.nnz.numpy(), b.nnz.numpy())
    freq = []
    for sp in (a, b):
        idx, val, nnz = sp.indices.numpy(), sp.values.numpy(), sp.nnz.numpy()
        live = np.arange(sp.cap)[None] < nnz[:, None]
        assert ((np.diff(idx, axis=1) > 0) | ~live[:, 1:]).all()
        np.testing.assert_allclose(np.sqrt((val ** 2).sum(1)), 1.0, rtol=1e-5)
        freq.append(np.bincount(idx[live], minlength=5000) / 3000)
    assert np.abs(freq[0][:50] - freq[1][:50]).max() < 0.05
    assert abs(freq[0][1000:].sum() / freq[1][1000:].sum() - 1) < 0.1
