"""Every ``(arch × shape)`` cell of the port against the reference's: the
counterpart of ``tests/test_configs_build.py``.

Each cell of ``ASSIGNED + ["apss"]`` builds from the full config on the
mapping ``{"data": 2, "model": 2}`` (no ranks): its arguments are meta
tensors, one spec per argument, ``fn`` callable, ``layout`` (the port's
own placement) one entry per argument. Against the reference's cell built
on a ``(2, 2)`` mesh of the session's virtual CPU devices (abstract shapes
only): the same cell names, kinds and descriptions, the same global shapes
and dtypes of every batch, cache, token and candidate argument, the same
parameter and optimizer element counts, the same filtered specs of those
arguments, and the same ``static_info``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_dist import jax_mesh  # noqa: E402
from repro.configs import ASSIGNED as JASSIGNED  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro_torch.configs import ASSIGNED, get_arch  # noqa: E402
from repro_torch.configs.base import tensors_of  # noqa: E402

MESH = {"data": 2, "model": 2}
CELLS = [(a, s) for a in ASSIGNED + ["apss"] for s in get_arch(a).shapes]


def _norm(part):
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return part[0] if len(part) == 1 else (part or None)
    return part


def _spec(spec) -> tuple:
    """A spec without trailing ``None``s, one-axis tuples as the axis."""
    out = [_norm(p) for p in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def test_the_port_has_every_reference_cell():
    assert ASSIGNED == JASSIGNED
    for a in ASSIGNED + ["apss"]:
        got, want = get_arch(a).shapes, jget_arch(a).shapes
        assert list(got) == list(want), a
        for s in want:
            assert (got[s].kind, got[s].desc) == (want[s].kind, want[s].desc), (a, s)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("arch_name,shape_name", CELLS)
def test_cell_builds_with_the_reference_shapes(arch_name, shape_name, jmesh):
    arch, jarch = get_arch(arch_name), jget_arch(arch_name)
    build = arch.cell(shape_name).build(arch.make_config(), MESH)
    jbuild = jarch.cell(shape_name).build(jarch.make_config(), jmesh)
    assert callable(build.fn)
    assert len(build.args) == len(build.in_shardings) == len(jbuild.args)
    assert build.layout is None or len(build.layout) == len(build.args)
    for arg in build.args:
        assert all(t.is_meta for _, t in tensors_of(arg))
    assert build.static_info == jbuild.static_info

    for i, (arg, jarg) in enumerate(zip(build.args, jbuild.args)):
        spec, jspec = build.in_shardings[i], jbuild.in_shardings[i]
        if isinstance(arg, torch.nn.Module) or hasattr(arg, "_fields"):
            # parameters and optimizer state: the reference stacks layers and
            # transposes matrices, so counts are compared, not leaf shapes
            got = sum(t.numel() for _, t in tensors_of(arg))
            want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jarg))
            assert got == want, (i, got, want)
            continue
        if isinstance(arg, torch.Tensor):
            arg, jarg, spec, jspec = {"": arg}, {"": jarg}, {"": spec}, {"": jspec}
        assert sorted(arg) == sorted(jarg), i
        for key in jarg:
            assert tuple(arg[key].shape) == tuple(jarg[key].shape), (i, key)
            assert _dtype(arg[key].dtype) == _dtype(jarg[key].dtype), (i, key)
            assert _spec(spec[key]) == _spec(jspec[key].spec), (i, key)


def test_production_mesh():
    from repro_torch.launch.mesh import make_production_mesh

    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
