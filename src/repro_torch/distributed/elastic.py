"""Elastic re-mesh: place a checkpointed state on a different rank count.

When a node is lost, a job resumes from its latest checkpoint on a smaller
mesh, and scales back up when capacity returns. Checkpoints hold full
(unsharded) host arrays per leaf (``repro_torch.checkpoint``), so
resharding is a pure placement problem: build the new mesh, filter the
specs against it, and place each leaf.

A spec is this port's own: a tuple with one entry per dimension of its
leaf, each an axis name, a tuple of axis names or ``None`` (the
counterpart of a JAX ``PartitionSpec``), or a :class:`HeadBlocks`: whole
heads laid out over one axis by a list, zero heads padding the blocks to
one size (attention whose heads the axis does not divide). Axis names
missing from the new mesh, and dimensions whose size does not divide the
product of their axes' sizes, degrade to replication, so one spec tree
drives every scale.

:func:`reshard_tree` returns DTensors (``torch.distributed.tensor``) with
``Shard(d)`` / ``Replicate()`` placements. Every rank holds the whole host
state (each read the checkpoint), so each builds its local shard by
slicing (``DTensor.from_local``): placing moves no bytes between ranks.
``.to_local()`` gives the rank's shard, ``.full_tensor()`` the whole leaf.

Meshes are ``torch.distributed`` ``DeviceMesh`` objects over ranks of the
initialised process group. Creating one is collective: every rank of the
group calls :func:`make_elastic_mesh`, those outside the new mesh too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A concrete rescale: old mesh shape → new mesh shape."""

    new_mesh: Any
    reason: str = ""

    def describe(self) -> str:
        shape = dict(zip(self.new_mesh.mesh_dim_names, self.new_mesh.mesh.shape))
        return (
            f"ElasticPlan(mesh={shape}, "
            f"devices={self.new_mesh.mesh.numel()}, reason={self.reason!r})"
        )


def make_elastic_mesh(
    n_devices: int,
    *,
    model_parallel: int,
    axis_names=("data", "model"),
    devices=None,
):
    """Largest mesh of the requested shape family that fits ``n_devices``.

    Keeps the model axis fixed (the TP degree is a property of the model,
    not of cluster capacity) and shrinks the data axis: losing nodes costs
    data parallelism, never model correctness. ``devices`` are global
    ranks (default: every rank of the process group, in order); the mesh
    takes the first ``data · model_parallel`` of the first ``n_devices``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if devices is None:
        devices = list(range(dist.get_world_size()))
    devices = list(devices)[:n_devices]
    data = len(devices) // model_parallel
    if data < 1:
        raise ValueError(
            f"{len(devices)} devices cannot host model_parallel={model_parallel}"
        )
    usable = torch.tensor(devices[: data * model_parallel]).reshape(data, model_parallel)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, usable, mesh_dim_names=tuple(axis_names))


def _axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh``, or of a mapping that is one."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class HeadBlocks:
    """A spec entry for a dimension of whole heads of ``width`` elements
    each, laid out over ``axis`` by a list: the rank at place ``r`` of the
    axis holds the heads ``blocks[r]`` in that order, ``-1`` standing for a
    zero head. Every block holds as many heads, a head may lie in several
    blocks (a kv head the ranks of its group share), and every head of the
    whole dimension lies in one at least. ``GSPMD`` splits such a dimension
    by its size, cutting heads; this keeps them whole."""

    axis: str
    width: int
    blocks: tuple

    def __post_init__(self):
        if len({len(b) for b in self.blocks}) != 1:
            raise ValueError(f"blocks of unequal size: {self.blocks}")
        held = {h for b in self.blocks for h in b if h >= 0}
        if held != set(range(len(held))):
            raise ValueError(f"blocks hold heads {sorted(held)}, not every head from 0")

    @property
    def heads(self) -> int:
        """Heads of the whole dimension."""
        return 1 + max(h for b in self.blocks for h in b)

    @property
    def local(self) -> int:
        """Elements of the dimension one block holds."""
        return len(self.blocks[0]) * self.width

    def rows(self, place: int) -> list:
        """The whole dimension's elements block ``place`` holds, in order;
        ``heads · width`` (one past the end) for a zero head's."""
        zero = self.heads * self.width
        return [h * self.width + i if h >= 0 else zero
                for h in self.blocks[place] for i in range(self.width)]

    def gathered_rows(self) -> list:
        """Where each element of the whole dimension lies in the blocks laid
        side by side in place order: in the first block holding its head."""
        first = {}
        for r, b in enumerate(self.blocks):
            for slot, h in enumerate(b):
                first.setdefault(h, r * len(b) + slot)
        return [first[h] * self.width + i for h in range(self.heads) for i in range(self.width)]

    def repeats(self, place: int) -> bool:
        """Whether every head of block ``place`` lies in an earlier block
        (a shared kv head its group's first rank holds too; zero heads
        count as held)."""
        earlier = {h for b in self.blocks[:place] for h in b}
        return all(h < 0 or h in earlier for h in self.blocks[place])


def _filter_spec_for(mesh, spec, shape) -> tuple:
    """``spec`` with axis names the mesh lacks, and dimensions the mesh does
    not divide, replicated (``None``); ``shape=None`` checks no division. A
    :class:`HeadBlocks` stays where the mesh has its axis at its size."""
    sizes = _axis_sizes(mesh)

    def keep(part, dim):
        if part is None:
            return None
        if isinstance(part, HeadBlocks):
            return part if sizes.get(part.axis) == len(part.blocks) else None
        names = part if isinstance(part, (tuple, list)) else (part,)
        kept = tuple(a for a in names if a in sizes)
        if not kept or (dim is not None and dim % int(np.prod([sizes[a] for a in kept]))):
            return None
        return kept if isinstance(part, (tuple, list)) else kept[0]

    dims = (None,) * len(spec) if shape is None else shape
    return tuple(keep(part, dim) for part, dim in zip(spec, dims))


def _place(x, spec, mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    t = torch.as_tensor(np.asarray(x))
    spec = _filter_spec_for(mesh, tuple(spec) + (None,) * (t.dim() - len(spec)), t.shape)
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh it is asked to place on")
    placements = [Replicate()] * len(names)
    local = t
    for d, part in enumerate(spec):
        if part is None:
            continue
        if isinstance(part, HeadBlocks):
            raise ValueError("a DTensor has no placement for padded or shared heads "
                             "(HeadBlocks); distributed.sharding.cut_tree cuts them")
        for a in (part if isinstance(part, tuple) else (part,)):  # outer axis first
            i = names.index(a)
            placements[i] = Shard(d)
            size = int(mesh.mesh.shape[i])
            step = local.shape[d] // size
            local = local.narrow(d, coord[i] * step, step)
    local = local.contiguous().to(mesh.device_type)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over the containers of ``tree`` (dicts, lists,
    tuples); ``specs`` mirrors them down to each leaf's spec."""
    if isinstance(tree, dict):
        return {key: _map(fn, tree[key], specs[key]) for key in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        out = [_map(fn, x, s) for x, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, specs)


def reshard_tree(host_state: Any, specs: Any, new_mesh) -> Any:
    """Place a host-side (numpy) state tree on a new mesh, as DTensors.

    ``specs`` mirrors the tree with one spec per leaf (a ``None`` spec
    replicates the leaf), the specs used at the original scale; axis names
    missing from the new mesh degrade to replication, so the same spec
    tree drives every scale. Called by every rank of ``new_mesh``.
    """
    return _map(lambda x, spec: _place(x, () if spec is None else spec, new_mesh),
                host_state, specs)


def rescale(
    checkpoint_load: Callable[[], Any],
    specs: Any,
    plan: ElasticPlan,
) -> Any:
    """Full elastic rescale: load the latest checkpoint, place it on the new mesh."""
    state = checkpoint_load()
    return reshard_tree(state, specs, plan.new_mesh)
