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
needs the ranks of a real mesh. The assigned architectures' cells (train,
prefill, decode, serve and retrieval on a mesh) wait for ROADMAP queue 1
item 9.8, after the sharded decode and ``moe_ffn_ep`` of item 9.4.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed.elastic import _axis_sizes as axis_sizes  # noqa: F401
from repro_torch.distributed.elastic import _filter_spec_for


def shardings_for(mesh, specs):
    """A tree of specs (dicts and lists of them; a tuple is a spec) with the
    axes ``mesh`` lacks replaced by ``None``, leaf by leaf."""
    if isinstance(specs, dict):
        return {key: shardings_for(mesh, s) for key, s in specs.items()}
    if isinstance(specs, list):
        return [shardings_for(mesh, s) for s in specs]
    return _filter_spec_for(mesh, tuple(specs), None)


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
