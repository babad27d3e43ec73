"""Config/arch registry plumbing: every architecture registers an
``ArchDef`` with its full and its smoke config, and shape cells
(``ShapeCell``) whose builders return a :class:`CellBuild`: the function to
run, its arguments and their placements.

Arguments are tensors on ``torch.device("meta")`` (:func:`meta`): shapes
and dtypes only, so building a cell of a full config allocates nothing. A
placement is the port's own spec (``distributed/elastic.py``): a tuple
with one entry per dimension, each an axis name, a tuple of axis names or
``None``. A builder reads only a mesh's axis names and sizes, so it takes
a ``DeviceMesh`` or a mapping ``{axis: size}`` that describes one (the CPU
tests build every cell that way, with no ranks); running a cell's ``fn``
needs the ranks of a real mesh.

``args`` are the global arguments and ``in_shardings`` the reference's
placement of them. ``fn`` is what one rank runs, on its local arguments
under ``distributed.sharding.use_mesh``: ``layout`` says how the port
itself cuts each argument into those (its batch, cache and candidate
splits, an LM's weights and moments by ``transformer.layout_specs``, a
recsys model's by ``recsys.layout_specs``, a graph's nodes and edges by
``gnn.graph_specs``),
and :func:`local_args` makes a rank's meta arguments from it
(``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed.elastic import _axis_sizes as axis_sizes  # noqa: F401
from repro_torch.distributed.elastic import _filter_spec_for
from repro_torch.distributed.sharding import local_shape


def shardings_for(mesh, specs):
    """A tree of specs (dicts, lists and named tuples of them; a plain tuple
    is a spec) with the axes ``mesh`` lacks replaced by ``None``, leaf by
    leaf."""
    if isinstance(specs, dict):
        return {key: shardings_for(mesh, s) for key, s in specs.items()}
    if isinstance(specs, list):
        return [shardings_for(mesh, s) for s in specs]
    if hasattr(specs, "_fields"):
        return type(specs)(*(shardings_for(mesh, s) for s in specs))
    return _filter_spec_for(mesh, tuple(specs), None)


def tensors_of(arg) -> list:
    """``(path, tensor)`` of every tensor in an argument: a module's
    parameters by name, and the entries of dicts, lists and named tuples."""
    if isinstance(arg, torch.nn.Module):
        return list(arg.named_parameters())
    if isinstance(arg, torch.Tensor):
        return [("", arg)]
    if isinstance(arg, dict):
        items = arg.items()
    elif hasattr(arg, "_fields"):
        items = zip(arg._fields, arg)
    elif isinstance(arg, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(arg))
    else:
        return []
    return [(f"{k}.{p}" if p else str(k), t) for k, v in items for p, t in tensors_of(v)]


def spec_at(specs, path: str):
    """The spec of the tensor at ``path`` (as :func:`tensors_of` names it)
    in a spec tree of the argument's shape: ``()`` (replicated) where the
    tree names none."""
    if specs is None:
        return ()
    if not isinstance(specs, (dict, list)) and not hasattr(specs, "_fields"):
        return tuple(specs)
    if isinstance(specs, dict) and path in specs:
        return tuple(specs[path])
    head, _, rest = path.partition(".")
    if isinstance(specs, dict):
        return spec_at(specs.get(head), rest) if head in specs else ()
    if hasattr(specs, "_fields"):
        return spec_at(getattr(specs, head), rest)
    return spec_at(specs[int(head)], rest)


def arg_bytes(args, specs, mesh) -> int:
    """Bytes one rank holds of ``args`` placed by ``specs`` on ``mesh``."""
    total = 0
    for arg, spec in zip(args, specs):
        for path, t in tensors_of(arg):
            shape = local_shape(tuple(t.shape), spec_at(spec, path), mesh)
            n = 1
            for d in shape:
                n *= d
            total += n * t.element_size()
    return total


def local_args(args, layout, mesh):
    """Meta arguments of one rank's block under ``layout`` (a spec tree per
    argument): each tensor cut to :func:`~repro_torch.distributed.sharding.
    local_shape`; a module laid out by specs is the rank's blocks (an LM's
    ``Transformer(cfg, "meta", mesh)``, a recsys ``ParamTree.rebuild("meta",
    mesh)``), one without keeps its (replicated) parameters. ``mesh`` is the
    ``DeviceMesh`` the cell runs on, whose collectives the module's forward
    calls."""
    from repro_torch.models.layers import ParamTree

    def cut(arg, spec, path=""):
        if isinstance(arg, ParamTree):
            return arg if spec is None else arg.rebuild("meta", mesh)
        if isinstance(arg, torch.nn.Module):
            return arg if spec is None else type(arg)(arg.cfg, "meta", mesh)
        if isinstance(arg, torch.Tensor):
            return meta(local_shape(tuple(arg.shape), spec_at(spec, path), mesh), arg.dtype)
        if isinstance(arg, dict):
            return {k: cut(v, spec, f"{path}.{k}" if path else str(k)) for k, v in arg.items()}
        if hasattr(arg, "_fields"):
            return type(arg)(*(cut(v, spec, f"{path}.{k}" if path else k)
                               for k, v in zip(arg._fields, arg)))
        return arg

    return tuple(cut(a, s) for a, s in zip(args, layout))


def data_axes_of(mesh) -> tuple:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def meta(shape, dtype) -> torch.Tensor:
    """An argument of ``shape`` and ``dtype`` with no storage (the meta device)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class CellBuild:
    """Everything needed to run or check one (arch × shape × mesh)."""

    fn: Callable
    args: tuple                 # meta tensors
    in_shardings: tuple         # one spec per argument
    out_shardings: Any          # specs, or None (the entry point's own layout)
    static_info: dict           # model flops etc. for the roofline
    layout: tuple | None = None  # the port's own placement per argument (None: replicated)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str                   # train | prefill | decode | serve | retrieval | apss
    desc: str
    build: Callable[[Any, Any], CellBuild]   # (full_config, mesh) -> CellBuild


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                 # lm | gnn | recsys | apss
    source: str                 # public-literature citation tag
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict = dataclasses.field(default_factory=dict)

    def cell(self, shape: str) -> ShapeCell:
        return self.shapes[shape]


REGISTRY: dict = {}


def register(arch: ArchDef) -> ArchDef:
    REGISTRY[arch.name] = arch
    return arch


def get_arch(name: str) -> ArchDef:
    if name not in REGISTRY:
        import repro_torch.configs  # noqa: F401  (importing registers)
    if name not in REGISTRY:
        raise KeyError(f"unknown or unported architecture {name!r}; ported: {sorted(REGISTRY)}")
    return REGISTRY[name]


def all_arch_names() -> list:
    import repro_torch.configs  # noqa: F401

    return sorted(REGISTRY)
