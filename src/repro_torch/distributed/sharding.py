"""Sharding context: the active mesh and the reference's axis conventions.

The reference's ``distributed/sharding.py`` names the layout every model
follows (its DESIGN.md §5):

  - batch-like dims        → ``("pod", "data")`` (whichever exist)
  - hidden/feature dims    → ``"model"`` (tensor parallel)
  - expert dim             → ``"model"`` (expert parallel)
  - long decode KV cache   → sequence dim over ``"data"`` and ``"model"``

A mesh is a ``DeviceMesh`` of ``launch.mesh.make_mesh`` or, for building
cells without ranks, a mapping ``{axis: size}`` (``configs/base.py``).
:func:`use_mesh` activates one for the calling thread.

JAX's GSPMD is one program over every device: ``shard`` there constrains a
value's placement and the compiler inserts the collectives. Eager PyTorch
has no such compiler: every rank runs its own program on its local
tensors. So :func:`shard` and :func:`shard_batch` return ``x`` unchanged,
and the port splits work only where the reference's own code names a split
that changes the algorithm:

  - the decode cache's sequence (``models.transformer.make_cache(mesh=)``:
    each rank attends over its shard, the ranks combine the partials);
  - the experts (``models.moe.moe_ffn_ep``, the reference's ``shard_map``);
  - the batch over the data axes (``launch.train.train_loop(mesh=)``: each
    rank takes its rows, the gradients are summed over the data axes).

What GSPMD decides by itself in the reference is not done here: tensor
parallelism of the dense GEMMs over ``"model"`` and FSDP over ``("pod",
"data")``. Dense weights are replicated on every rank
(``launch.dryrun`` prices that against the reference's specs per cell).
Specs are the port's tuples (``distributed/elastic.py``).
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.distributed.elastic import _axis_sizes, _filter_spec_for, reshard_tree

_state = threading.local()


def active_mesh():
    """The mesh :func:`use_mesh` activated on this thread, or ``None``."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` (a ``DeviceMesh``, a ``{axis: size}`` mapping or
    ``None``) for the block; the previous one comes back after it."""
    prev = active_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def axis_sizes(mesh=None) -> dict:
    """``{axis: size}`` of ``mesh`` (default: the active one; none: ``{}``)."""
    mesh = active_mesh() if mesh is None else mesh
    return {} if mesh is None else _axis_sizes(mesh)


def _filter_spec(mesh, spec) -> tuple:
    """``spec`` with the axis names ``mesh`` lacks replicated, so one model
    definition runs on ``(data, model)``, ``(pod, data, model)`` and no mesh."""
    return _filter_spec_for(mesh, tuple(spec), None)


def shard(x, *spec_parts):
    """Identity: eager ranks hold their local tensors (see the module doc)."""
    return x


def shard_batch(x, *trailing):
    """Identity, as :func:`shard`."""
    return x


def data_axes() -> tuple:
    """Batch-sharding axes present in the active mesh."""
    sizes = axis_sizes()
    return tuple(a for a in ("pod", "data") if a in sizes)


def model_axis() -> str | None:
    return "model" if "model" in axis_sizes() else None


def batch_spec(*trailing) -> tuple:
    """``(("pod", "data"), *trailing)`` filtered to the active mesh."""
    axes = data_axes()
    return (axes if axes else None, *trailing)


def named_sharding(spec) -> tuple | None:
    """``spec`` filtered to the active mesh (``None`` without one)."""
    mesh = active_mesh()
    if mesh is None:
        return None
    return _filter_spec(mesh, spec)


def shard_params(params, specs):
    """Place a host (numpy or tensor) tree on the active ``DeviceMesh`` as
    DTensors by its specs (``elastic.reshard_tree``); ``params`` itself
    without a mesh. Called by every rank of the mesh."""
    mesh = active_mesh()
    if mesh is None:
        return params
    return reshard_tree(params, specs, mesh)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a tensor of ``shape`` placed by
    ``spec`` on ``mesh``: each dimension divided by the product of its
    axes' sizes (axes the mesh lacks, and sizes that do not divide,
    replicate)."""
    sizes = _axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, _filter_spec_for(mesh, spec, tuple(shape))):
        names = () if part is None else (part if isinstance(part, tuple) else (part,))
        div = 1
        for a in names:
            div *= sizes[a]
        out.append(dim // div)
    return tuple(out)
