"""Sharding context: the active mesh, the reference's axis conventions and
a rank's blocks of a tree.

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
has no such compiler: every rank runs its own program on plain local
tensors, and the port's code names each split and each collective
(``core.distributed``, summed in rank order; no DTensor dispatch). So
:func:`shard` and :func:`shard_batch` return ``x`` unchanged. What is split:

  - an LM's weights (``models.transformer.Transformer(cfg, device, mesh)``
    by ``layout_specs``, the reference's ``param_specs``): attention heads
    (``wq``/``wk``/``wv``/``wq_b``/``wkv_b`` by rows, ``wo`` by columns),
    FFN columns (``w_gate``/``w_up``) and rows (``w_down``), the
    embedding's width and the head's vocab over ``model``; the experts
    over ``model``; with ``cfg.fsdp`` the ``d_model`` dimension of every
    matrix (and the router) over ``("pod", "data")``, gathered before use
    (:func:`weight_for_use`), and the AdamW moments alike;
  - the decode cache's sequence (``models.transformer.make_cache(mesh=)``:
    each rank attends over its shard, the ranks combine the partials);
  - a recsys model's weights (``models.recsys.init_*(mesh=)`` by
    ``recsys.layout_specs``, the reference's ``*_param_specs``): every
    table's rows over ``model`` (a vocab-parallel lookup,
    ``layers.lookup``; BERT4Rec's logits over the rank's rows), the
    two-tower's tower columns, BERT4Rec's and BST's blocks (and BST's
    first MLP pair) as column and row pairs, with their AdamW moments;
  - a graph's nodes and edges over the data axes (``models.gnn.cut_graph``
    by ``gnn.graph_specs``, the reference's ``batch_sh``): each layer
    gathers the nodes' terms, maxes and sums the softmax over the ranks'
    edges and reduce-scatters the aggregation onto the nodes' owners;
  - the batch over the data axes (``launch.train.train_loop(mesh=)``).

A dimension whose size its axes do not divide replicates
(``elastic._filter_spec_for``). Attention splits whole heads only: where
``model`` does not divide them, the heads are zero-padded to a count it
does and each rank holds only the kv heads its q heads read
(:class:`HeadLayout`; the spec entry is an ``elastic.HeadBlocks``), so a
rank holds a little more than GSPMD's even split of the same weight
(``transformer.layout_replications`` and ``recsys.layout_replications``
list it). The padding lives only in a rank's blocks: :func:`cut_tree` cuts
a whole tree (or a ``ParamTree``) to a rank's blocks and :func:`gather_tree`
gathers one back to the whole, unpadded tree. Specs are the port's tuples
(``distributed/elastic.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.distributed.elastic import (
    HeadBlocks,
    _axis_sizes,
    _filter_spec_for,
    reshard_tree,
)

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


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """Attention's ``hq`` q heads in ``hkv`` groups (``hkv = hq`` for MHA and
    MLA) over the ``m`` ranks of an axis, with whole heads only: each group
    zero-padded from ``g = hq / hkv`` to ``g_pad`` q heads and the groups
    from ``hkv`` to ``hkv_pad`` (a zero group's kv heads are zero too), the
    fewest zero heads such that ``m`` divides ``hkv_pad · g_pad`` and a
    rank's ``q_per_rank`` q heads (in padded order, rank ``r`` the ``r``-th
    run) are whole groups or lie inside one group. A rank holds the kv heads
    its q heads read: whole groups' own, or one kv head shared with the
    other ranks of its group. ``m | hq`` with whole groups on a rank needs
    no padding and shares nothing: GSPMD's even split."""

    hq: int
    hkv: int
    m: int
    g_pad: int
    hkv_pad: int

    @classmethod
    def of(cls, hq: int, hkv: int, m: int) -> "HeadLayout":
        g = hq // hkv
        best = None
        for g_pad in ([1] if hq == hkv else range(g, g * m + 1)):
            for hkv_pad in range(hkv, hkv * m + 1):
                n = hkv_pad * g_pad
                per = n // m
                if n % m == 0 and (per % g_pad == 0 or g_pad % per == 0):
                    if best is None or n < best[0]:
                        best = (n, g_pad, hkv_pad)
                    break
        return cls(hq, hkv, m, best[1], best[2])

    @property
    def q_per_rank(self) -> int:
        return self.hkv_pad * self.g_pad // self.m

    @property
    def kv_per_rank(self) -> int:
        return max(1, self.q_per_rank // self.g_pad)

    @property
    def even_q(self) -> bool:
        """Whether a rank's q heads are the even split's (no padding)."""
        return self.hkv_pad * self.g_pad == self.hq

    @property
    def even_kv(self) -> bool:
        """Whether a rank's kv heads are the even split's (no padding, no
        kv head held by two ranks)."""
        return self.even_q and self.q_per_rank >= self.g_pad

    def q_head(self, j: int) -> int:
        """The q head at padded place ``j``; ``-1`` for a zero head."""
        grp, i = divmod(j, self.g_pad)
        g = self.hq // self.hkv
        return grp * g + i if grp < self.hkv and i < g else -1

    def q_heads(self, r: int) -> tuple:
        n = self.q_per_rank
        return tuple(self.q_head(j) for j in range(r * n, (r + 1) * n))

    def kv_heads(self, r: int) -> tuple:
        first = r * self.q_per_rank // self.g_pad
        return tuple(k if k < self.hkv else -1 for k in range(first, first + self.kv_per_rank))

    def sharers(self, r: int) -> tuple:
        """The ranks holding rank ``r``'s kv heads, in rank order (``(r,)``
        when it alone does)."""
        return tuple(s for s in range(self.m) if self.kv_heads(s) == self.kv_heads(r))

    def q_blocks(self, width: int) -> HeadBlocks:
        """The q heads' spec entry over ``model``, ``width`` elements a head."""
        return HeadBlocks("model", width, tuple(self.q_heads(r) for r in range(self.m)))

    def kv_blocks(self, width: int) -> HeadBlocks:
        """The kv heads' spec entry over ``model``, ``width`` elements a head."""
        return HeadBlocks("model", width, tuple(self.kv_heads(r) for r in range(self.m)))


def on_axis(part, axis: str) -> bool:
    """Whether a spec entry splits its dimension over ``axis``."""
    if isinstance(part, HeadBlocks):
        return part.axis == axis
    return part == axis or (isinstance(part, tuple) and axis in part)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a tensor of ``shape`` placed by
    ``spec`` on ``mesh``: each dimension divided by the product of its
    axes' sizes (axes the mesh lacks, and sizes that do not divide,
    replicate); a :class:`HeadBlocks` dimension its block's heads."""
    sizes = _axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, _filter_spec_for(mesh, spec, tuple(shape))):
        if isinstance(part, HeadBlocks):
            out.append(part.local)
            continue
        names = () if part is None else (part if isinstance(part, tuple) else (part,))
        div = 1
        for a in names:
            div *= sizes[a]
        out.append(dim // div)
    return tuple(out)


def _parts(spec, ndim: int) -> list:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [() if part is None else (tuple(part) if isinstance(part, (tuple, list)) else
                                     (part.axis,) if isinstance(part, HeadBlocks) else (part,))
            for part in spec]


def _take_heads(x, dim: int, part: HeadBlocks, place: int):
    """Block ``place`` of a :class:`HeadBlocks` dimension of ``x`` (numpy or
    tensor): its heads' elements in order, zeros for a zero head."""
    rows = part.rows(place)
    if isinstance(x, torch.Tensor):
        pad = x.new_zeros((*x.shape[:dim], 1, *x.shape[dim + 1:]))
        return torch.cat([x, pad], dim).index_select(
            dim, torch.tensor(rows, dtype=torch.long, device=x.device))
    pad = np.zeros((*x.shape[:dim], 1, *x.shape[dim + 1:]), dtype=x.dtype)
    return np.take(np.concatenate([x, pad], axis=dim), rows, axis=dim)


def repeats_block(p) -> bool:
    """Whether a rank's block ``p`` (tagged ``.spec``/``.mesh``) holds only
    heads a lower rank of its axis holds too (a shared kv head): a sum over
    the ranks that should count each head once leaves it out."""
    from repro_torch.core.distributed import _axis_index

    spec = getattr(p, "spec", None)
    for part in () if spec is None else spec:
        if isinstance(part, HeadBlocks) and part.repeats(_axis_index(p.mesh, part.axis)):
            return True
    return False


def _is_spec(node) -> bool:
    return node is None or (isinstance(node, tuple) and not hasattr(node, "_fields"))


def _map_with_specs(fn, tree, specs):
    if _is_spec(specs):
        return fn(tree, () if specs is None else specs)
    if isinstance(tree, dict):
        return {k: _map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_specs(fn, v, s) for v, s in zip(tree, specs)))
    return type(tree)(_map_with_specs(fn, v, s) for v, s in zip(tree, specs))


def block_of(x, spec, mesh):
    """This rank's block of the whole ``x`` (numpy array or tensor) placed by
    ``spec`` on ``mesh`` (a ``DeviceMesh``): along each split dimension the
    ``r``-th of ``q`` equal parts, ``r`` the rank's row-major place over
    the dimension's axes. Axes the mesh lacks and sizes they do not divide
    replicate, as in :func:`local_shape`. A view (no copy), but for a
    :class:`HeadBlocks` dimension: its block's heads, copied, zero heads
    as zeros."""
    from repro_torch.core.distributed import _axis_index

    shape = tuple(x.shape)
    spec = _filter_spec_for(mesh, tuple(spec) + (None,) * (len(shape) - len(spec)), shape)
    local = local_shape(shape, spec, mesh)
    index, heads = [], []
    for dim, (part, axes) in enumerate(zip(spec, _parts(spec, len(shape)))):
        r = _axis_index(mesh, axes) if axes else 0
        if isinstance(part, HeadBlocks):
            index.append(slice(None))
            heads.append((dim, part, r))
        else:
            index.append(slice(r * local[dim], (r + 1) * local[dim]))
    out = x[tuple(index)]
    for dim, part, r in heads:
        out = _take_heads(out, dim, part, r)
    return out


def cut_tree(tree, specs, mesh):
    """A whole tree (dicts, lists and named tuples of numpy arrays or
    tensors) cut to this rank's blocks by a spec tree of its structure
    (:func:`block_of` leaf by leaf; a ``None`` or ``()`` spec keeps the
    leaf whole). A ``ParamTree`` takes its specs by parameter name and
    becomes the rank's tagged blocks (``layers.cut_param_tree``)."""
    from repro_torch.models.layers import ParamTree, cut_param_tree

    if isinstance(tree, ParamTree):
        return cut_param_tree(tree, specs, mesh)
    return _map_with_specs(lambda x, spec: block_of(x, spec, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """The inverse of :func:`cut_tree` on tensors: each leaf's blocks
    all-gathered over the axes of each split dimension, in row-major rank
    order (every rank of ``mesh`` calls this and gets the whole tree). A
    ``ParamTree`` of blocks is gathered by its own tags
    (``layers.gather_param_tree``; ``specs`` and ``mesh`` unused)."""
    from repro_torch.core.distributed import _all_gather
    from repro_torch.models.layers import ParamTree, gather_param_tree

    if isinstance(tree, ParamTree):
        return gather_param_tree(tree)

    def gather(x, spec):
        x = x.detach()
        spec = _filter_spec_for(mesh, tuple(spec) + (None,) * (x.dim() - len(spec)), None)
        for dim, (part, axes) in enumerate(zip(spec, _parts(spec, x.dim()))):
            if axes:
                x = _all_gather(x.contiguous(), mesh, axes if len(axes) > 1 else axes[0], dim)
            if isinstance(part, HeadBlocks):  # the whole heads, each from its first block
                x = x.index_select(dim, torch.tensor(part.gathered_rows(), dtype=torch.long,
                                                     device=x.device))
        return x

    return _map_with_specs(gather, tree, specs)


def split_axes(spec) -> tuple:
    """Every mesh axis that splits a dimension of a leaf placed by ``spec``
    (its filtered layout spec), in the order the spec names them."""
    return tuple(a for part in _parts(spec, len(tuple(spec))) for a in part)


def weight_for_use(p):
    """A parameter as a rank multiplies by it: a block tagged by
    ``Transformer(mesh=)`` (``p.spec``, ``p.mesh``) gathered over the data
    axes that FSDP splits it on (``core.distributed.gather_for_use``: the
    backward reduce-scatters its gradient in rank order); its ``model``
    block stays. An untagged tensor as it is."""
    spec = getattr(p, "spec", None)
    if spec is None:
        return p
    from repro_torch.core.distributed import gather_for_use

    out = p
    for dim, axes in enumerate(_parts(spec, p.dim())):
        fsdp = tuple(a for a in axes if a in ("pod", "data"))
        if fsdp:
            out = gather_for_use(out, p.mesh, fsdp, dim)
    return out
