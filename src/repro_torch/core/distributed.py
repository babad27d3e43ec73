"""Distributed APSS: the paper's 1-D and 2-D data distributions over
``torch.distributed`` (PyTorch).

Every rank runs the same program on a ``DeviceMesh`` with named axes
(``launch.mesh``); the JAX reference runs one ``shard_map`` body per device.
Each entry point takes the global corpus on every rank (numpy, tensor or
``SparseCorpus``), moves only this rank's shard to ``device`` and returns
what the reference's shard at this rank's mesh coordinate holds:

- **1-D horizontal** (paper Alg. 6, rows distributed): ``schedule=
  "allgather"`` gathers the corpus and matches the local rows; ``"ring"``
  rotates row blocks (``p - 1`` hops); ``"halfring"`` uses S = Sᵀ: ``⌊p/2⌋``
  block hops, with a caravan of backward matches that rides along and is
  shifted home at the end. ``use_kernel=True`` scores each block pair with
  K1 through ``similarity_topk`` at the step's runtime row and column
  offsets. Returns this rank's rows.
- **Hierarchical**: a nested ring over several axes; the innermost rings
  most often, and the travelling block carries its owner id.
- **1-D vertical** (paper Algs. 3-5, dimensions distributed): partial scores
  per dimension slice, then ``accumulation="allreduce"`` (all scores),
  ``"scatter"`` (reduced and partitioned: returns the stacked
  ``(n / block_rows, block_rows / p)`` row slices), ``"compressed"`` (Lemma 1:
  top-C candidates at ``t/p``, gathered ids, one small psum) or
  ``"recursive"`` (hypercube, upper-bound tracking). The other three return
  the whole, replicated ``Matches``.
- **2-D** (paper Alg. 7): a ring over ``row_axis`` composed with the
  vertical accumulation over ``col_axis``. Returns this rank's rows.

Sparse corpora take the same schedules, with the CSR triple (or pair) as the
travelling block, scored by ``gather_dot``; there is no kernel on that path,
as in the reference. :func:`gather_matches` assembles the global result.

Every collective goes through the helpers below, named after the lax ops.
With a gloo group they stage CUDA tensors through host memory (NCCL refuses
two ranks on one card, so ranks that share a card run gloo). They count the
bytes this rank sends (the logical payload: the tensor a ``_ppermute`` sends,
the input of the other collectives) in :data:`WIRE_BYTES` and the
host-clock seconds spent inside them in :data:`WIRE_SECONDS`. With an op
census active (``launch.op_analysis``) they report each collective under
the reference's HLO name (collective-permute, all-reduce, reduce-scatter,
all-gather) from the same tensors, at the reference's payload convention
(the result of an all-gather or a reduce-scatter, else the operand).

With a telemetry log active (``planner.telemetry.CommLog``) every entry
point records one ``ApssStats`` on each rank, with the reference's variant
string, hop formulas and FLOP model; the 2-D and hierarchical sweeps then
attach a ``StepTicker`` (the caller's ``ticker=``, else one created on the
rank's device) that takes one tick per (rank, step). A record's
``ppermute`` bytes equal this rank's ``WIRE_BYTES["ppermute"]`` for the
call; its ``all_gather`` and ``psum`` bytes price what a rank receives,
``p - 1`` and ``2·(p-1)/p`` times the input ``WIRE_BYTES`` counts.
``distribution="auto"`` hands the choice to the planner
(``planner.plan_apss``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.apss import similarity_topk
from repro_torch.core.matches import (
    NEG_INF,
    Matches,
    empty_matches,
    extract_matches,
    matches_from_candidates,
    merge_matches,
    stable_topk,
)
from repro_torch.core.precision import dot_f32
from repro_torch.core.pruning import local_threshold
from repro_torch.core.sparse import (
    DenseView,
    SparseCorpus,
    densify_rows,
    gather_dot,
    shard_dims,
    sparse_similarity_topk,
)
from repro_torch.interop import as_corpus, device_of
from repro_torch.launch import op_analysis
from repro_torch.obs import trace
from repro_torch.planner import telemetry

WIRE_BYTES = {"ppermute": 0, "psum": 0, "psum_scatter": 0, "all_gather": 0, "pmax": 0,
              "reduce_scatter": 0, "gather_heads": 0}
WIRE_SECONDS = {op: 0.0 for op in WIRE_BYTES}

_SPARSE_KERNEL = (
    "sparse use_kernel is the self-join worklist path "
    "(kernels.apss_block.sparse); distributed sparse schedules "
    "score with the gather-dot primitive"
)


class ApssStats(NamedTuple):
    """Exactness accounting for capacity-bounded candidate sets."""

    overflow_rows: torch.Tensor  # i32 scalar: rows whose candidate set was truncated


def default_candidate_capacity(k: int) -> int:
    """Candidate capacity of the compressed and recursive accumulations."""
    return max(4 * k, 32)


# ---------------------------------------------------------------------------
# Mesh axes and the collective layer
# ---------------------------------------------------------------------------


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        return int(np.prod([_axis_size(mesh, a) for a in axis]))
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def _axis_index(mesh, axis) -> int:
    """This rank's row-major place over one axis or a tuple of axes."""
    if isinstance(axis, tuple):
        flat = 0
        for a in axis:
            flat = flat * _axis_size(mesh, a) + mesh.get_local_rank(a)
        return flat
    return mesh.get_local_rank(axis)


def _ring_perm(p: int) -> list[tuple[int, int]]:
    return [(i, (i + 1) % p) for i in range(p)]


def _shift_perm(p: int, s: int) -> list[tuple[int, int]]:
    return [(i, (i - s) % p) for i in range(p)]


def _block_clamp(block_rows: int, n_loc: int) -> int:
    """Largest divisor of ``n_loc`` not exceeding ``block_rows``."""
    bs = min(block_rows, n_loc)
    while n_loc % bs:
        bs -= 1
    return bs


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_wire(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """The tensor as it travels: on the host under gloo, bf16 as int16."""
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.cpu() if staged and x.is_cuda else x


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        w = w.view(torch.bfloat16)
    return w.to(like.device)


class _Timed:
    """Adds the host-clock seconds of its block to ``WIRE_SECONDS[op]``.
    Staged CUDA tensors are waited for first, so the block's time is the
    wire's, not the device work queued before it."""

    def __init__(self, op: str, xs=(), staged: bool = False):
        self.op, self.xs, self.staged = op, xs, staged

    def __enter__(self):
        for x in self.xs:
            if self.staged and x.is_cuda:
                torch.cuda.current_stream(x.device).synchronize()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        WIRE_SECONDS[self.op] += time.perf_counter() - self.t0


def _on_meta(kind: str, x: torch.Tensor, out_shape, payload_shape, group: int):
    """A collective on a meta tensor (a dry run: ``launch.dryrun``): report
    it to the census at the payload convention and return a meta tensor of
    the result's shape, without touching the process group."""
    if op_analysis.CENSUS is not None:
        op_analysis.report_collective(kind, int(np.prod(payload_shape)) * x.element_size(),
                                      group)
    return x.new_empty(out_shape)


def _ppermute(xs: Sequence[torch.Tensor], mesh, axis, perm) -> tuple[torch.Tensor, ...]:
    """``lax.ppermute`` of each tensor of ``xs`` over ``axis``, in one batch.

    ``perm`` holds ``(source, destination)`` places on the axis. This rank
    sends to its destination and receives from its source; with no source
    the result is zeros, as in the reference.
    """
    if xs and xs[0].is_meta:
        return tuple(_on_meta("collective-permute", x, x.shape, x.shape,
                              _axis_size(mesh, axis)) for x in xs)
    group = mesh.get_group(axis)
    me = mesh.get_local_rank(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    staged = _staged(group)
    with _Timed("ppermute", xs, staged):
        wires = [_to_wire(x, staged) for x in xs]
        outs = [torch.zeros_like(w) for w in wires]
        ops = []
        for tag, (w, o) in enumerate(zip(wires, outs)):
            if dst:
                ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(group, dst[0]),
                                      group, tag))
                WIRE_BYTES["ppermute"] += w.numel() * w.element_size()
                if op_analysis.CENSUS is not None:
                    op_analysis.report_collective("collective-permute",
                                                  w.numel() * w.element_size(),
                                                  dist.get_world_size(group))
            if src:
                ops.append(dist.P2POp(dist.irecv, o, dist.get_global_rank(group, src[0]),
                                      group, tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return tuple(_from_wire(o, x) for o, x in zip(outs, xs))


def _all_reduce(x: torch.Tensor, mesh, axis, op, name: str) -> torch.Tensor:
    if x.is_meta:
        return _on_meta("all-reduce", x, x.shape, x.shape, _axis_size(mesh, axis))
    group = mesh.get_group(axis)
    staged = _staged(group)
    with _Timed(name, (x,), staged):
        w = _to_wire(x, staged)
        if w.data_ptr() == x.data_ptr():  # reduced in place: not the caller's
            w = w.clone()
        WIRE_BYTES[name] += w.numel() * w.element_size()
        if op_analysis.CENSUS is not None:
            op_analysis.report_collective("all-reduce", w.numel() * w.element_size(),
                                          dist.get_world_size(group))
        dist.all_reduce(w, op=op, group=group)
        return _from_wire(w, x)


def _psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``lax.psum`` over ``axis``."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM, "psum")


def _pmax(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``lax.pmax`` over ``axis``."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX, "pmax")


def _psum_scatter(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``lax.psum_scatter(scatter_dimension=0, tiled=True)`` over ``axis``."""
    p = _axis_size(mesh, axis)
    if x.is_meta:
        out = (x.shape[0] // p, *x.shape[1:])
        return _on_meta("reduce-scatter", x, out, out, p)
    group = mesh.get_group(axis)
    staged = _staged(group)
    with _Timed("psum_scatter", (x,), staged):
        w = _to_wire(x, staged)
        out = w.new_empty((w.shape[0] // p, *w.shape[1:]))
        WIRE_BYTES["psum_scatter"] += w.numel() * w.element_size()
        if op_analysis.CENSUS is not None:
            op_analysis.report_collective("reduce-scatter", out.numel() * out.element_size(), p)
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(out, w, op=dist.ReduceOp.SUM, group=group)
        return _from_wire(out, x)


def _all_gather(x: torch.Tensor, mesh, axis, dim: int = 0, *,
                op: str = "all_gather") -> torch.Tensor:
    """``lax.all_gather(axis=dim, tiled=True)`` over one axis or, row-major,
    a tuple of axes (the innermost gathered first). The wire's seconds go
    to ``WIRE_SECONDS[op]``; another ``op`` than ``"all_gather"`` leaves the
    bytes to the caller (which counts them as its own collective)."""
    if isinstance(axis, tuple):
        for a in reversed(axis):
            x = _all_gather(x, mesh, a, dim, op=op)
        return x
    p = _axis_size(mesh, axis)
    if x.is_meta:
        out = (*x.shape[:dim], p * x.shape[dim], *x.shape[dim + 1:])
        return _on_meta("all-gather", x, out, out, p)
    group = mesh.get_group(axis)
    staged = _staged(group)
    with _Timed(op, (x,), staged):
        w = _to_wire(x, staged)
        if w.dtype == torch.int16:  # bf16 bits: gloo gathers no int16, bytes travel alike
            w = w.view(torch.uint8)
        out = w.new_empty((p * w.shape[0], *w.shape[1:]))
        if op == "all_gather":
            WIRE_BYTES["all_gather"] += w.numel() * w.element_size()
            if op_analysis.CENSUS is not None:
                op_analysis.report_collective("all-gather", out.numel() * out.element_size(),
                                              p)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, w, group=group)
        if out.dtype == torch.uint8:
            out = out.view(torch.int16)
        # (p, ...) → the p pieces side by side along `dim`
        out = _from_wire(out, x).view(p, *x.shape)
        return out.movedim(0, dim).flatten(dim, dim + 1)


def psum_in_order(x: torch.Tensor, mesh, axes, *, places: tuple | None = None) -> torch.Tensor:
    """``lax.psum`` over an axis or a row-major tuple of axes, summed in
    rank order in ``x``'s dtype: the ranks' tensors are all-gathered and
    added one after another, so every rank gets the same bits on every
    run, whatever the timing and the backend's reduction order. With
    ``places`` only the ranks at those places (row-major over ``axes``, in
    order) are added: a sum over a group inside the axes. Reported to the
    census as one all-reduce of ``x``; ``WIRE_BYTES["psum"]`` and
    ``WIRE_SECONDS["psum"]`` count the bytes this rank sends and the time."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    p = _axis_size(mesh, axes) if axes else 1
    if p == 1:
        return x
    if x.is_meta:
        return _on_meta("all-reduce", x, x.shape, x.shape, p)
    parts = _all_gather(x.reshape(1, *x.shape), mesh, axes, op="psum")
    WIRE_BYTES["psum"] += x.numel() * x.element_size()
    if op_analysis.CENSUS is not None:
        op_analysis.report_collective("all-reduce", x.numel() * x.element_size(), p)
    order = range(p) if places is None else places
    out = parts[order[0]]
    for i in order[1:]:
        out = out + parts[i]
    return out


class _EnterReplicated(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``axes`` (or
    over the ranks at ``places`` of them) in rank order: ``shard_map``'s
    transpose of an input replicated over those ranks (each rank's
    gradient is its share of the whole)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, places):
        ctx.mesh, ctx.axes, ctx.places = mesh, axes, places
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (psum_in_order(g.contiguous(), ctx.mesh, ctx.axes, places=ctx.places),
                None, None, None)


class _PsumReplicatedOut(torch.autograd.Function):
    """``lax.psum`` over ``axes`` whose result every rank then uses alike:
    the backward passes the gradient through (``shard_map`` divides a
    replicated output's cotangent by the axes' size and the psum's
    transpose sums it back)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum_in_order(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pmean(torch.autograd.Function):
    """``lax.pmean`` over ``axes`` with the gradient scaled by ``grad_scale``
    (the caller's share of a value every rank of the mesh computes)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, grad_scale):
        ctx.grad_scale = grad_scale
        p = _axis_size(mesh, tuple(axes)) if axes else 1
        return psum_in_order(x, mesh, axes) / p if p > 1 else x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None, None


def enter_replicated(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` (the same on every rank of ``axes``) entering a region whose
    ranks each use a part of it: the gradient is summed over ``axes``."""
    return _EnterReplicated.apply(x, mesh, tuple(axes), None)


def enter_shared(x: torch.Tensor, mesh, axes, places: tuple) -> torch.Tensor:
    """``x`` held alike by the ranks at ``places`` of ``axes`` and used by
    each in its own way: the gradient is summed over those ranks only."""
    if len(places) < 2:
        return x
    return _EnterReplicated.apply(x, mesh, tuple(axes), tuple(places))


def psum_replicated(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:func:`psum_in_order` with autograd: the gradient passes through."""
    return _PsumReplicatedOut.apply(x, mesh, tuple(axes))


def pmean(x: torch.Tensor, mesh, axes, *, grad_scale: float) -> torch.Tensor:
    """Mean over ``axes`` in rank order; the backward scales the gradient
    by ``grad_scale``."""
    return _Pmean.apply(x, mesh, tuple(axes), grad_scale)


def reduce_scatter_in_order(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``lax.psum_scatter(scatter_dimension=dim, tiled=True)`` over an axis
    or a row-major tuple of axes, summed in rank order: over each axis,
    innermost first, an all-to-all hands every rank the other ranks' part
    of its block, which it adds one rank after another in f32 (a bf16
    input widens; the sum rounds once), so every run gives the same bits.
    The traffic is a ring reduce-scatter's. Reported to the census as one
    reduce-scatter of the output; ``WIRE_BYTES["reduce_scatter"]`` counts
    the bytes this rank hands over."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    p = _axis_size(mesh, axes) if axes else 1
    if p == 1:
        return x
    n = x.shape[dim] // p
    out_shape = (*x.shape[:dim], n, *x.shape[dim + 1:])
    if x.is_meta:
        return _on_meta("reduce-scatter", x, out_shape, out_shape, p)
    if op_analysis.CENSUS is not None:
        op_analysis.report_collective("reduce-scatter", n * x.numel() // x.shape[dim]
                                      * x.element_size(), p)
    y = x.unflatten(dim, (*(_axis_size(mesh, a) for a in axes), n)).float()
    for i in reversed(range(len(axes))):
        y = _sum_my_block(y, mesh, axes[i], dim + i)
    return y.to(x.dtype)


def _sum_my_block(y: torch.Tensor, mesh, axis, d: int) -> torch.Tensor:
    """One axis of :func:`reduce_scatter_in_order`: dim ``d`` of ``y``
    indexes that axis's ranks; each rank gets every rank's slice of its
    own index (an all-to-all) and adds them in rank order."""
    group = mesh.get_group(axis)
    staged = _staged(group)
    with _Timed("reduce_scatter", (y,), staged):
        parts = _to_wire(y.movedim(d, 0), staged)          # (p, ...), slice j to rank j
        WIRE_BYTES["reduce_scatter"] += parts.numel() * parts.element_size()
        got = torch.empty_like(parts)
        dist.all_to_all_single(got, parts, group=group)
        got = got.to(y.device)
    acc = got[0]
    for i in range(1, got.shape[0]):
        acc = acc + got[i]
    return acc


class _GatherForUse(torch.autograd.Function):
    """All-gather along ``dim`` whose backward is :func:`reduce_scatter_in_order`:
    FSDP's gather of a weight block before use. Each rank's gradient of the
    gathered weight covers its own rows of data, so the block's gradient
    is the sum over the ranks."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_in_order(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` whose result every rank then uses alike: the
    backward keeps the rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        me = _axis_index(ctx.mesh, ctx.axes)
        return g.narrow(ctx.dim, me * ctx.n, ctx.n), None, None, None


class _ReduceScatterOwned(torch.autograd.Function):
    """:func:`reduce_scatter_in_order` whose backward all-gathers: each
    rank's partial sum covers every block, and the owner of a block uses
    the sum, so a partial's gradient is the owner's gradient of its block."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter_in_order(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim), None, None, None


def reduce_scatter_owned(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's partial sums ``x`` over ``axes`` added in rank order in
    f32 onto the rank that owns each block of ``dim`` (row-major); the
    gradient of a partial is its block owners' gradients, all-gathered."""
    axes = tuple(axes)
    if _axis_size(mesh, axes) == 1:
        return x
    return _ReduceScatterOwned.apply(x, mesh, axes, dim)


def psum_shared(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:func:`psum_in_order` over ``axes`` of partials that every rank then
    uses in its own way (its own edges, its own rows): the backward sums
    the ranks' gradients in rank order too (``psum``'s transpose)."""
    axes = tuple(axes)
    if _axis_size(mesh, axes) == 1:
        return x
    return enter_replicated(psum_replicated(x, mesh, axes), mesh, axes)


def pmax_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.pmax`` over an axis or a tuple of axes, one axis after another
    (a max is exact in any order). No gradient."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    x = x.detach()
    for a in axes:
        if _axis_size(mesh, a) > 1:
            x = _pmax(x, mesh, a)
    return x


def gather_heads(x: torch.Tensor, mesh, axis, dim: int = 1) -> torch.Tensor:
    """Every rank's heads ``(…, H_loc, …)`` all-gathered along ``dim`` over
    ``axis`` (a decode step's q heads and new k/v rows under tensor
    parallelism), counted apart in ``WIRE_BYTES["gather_heads"]`` and
    reported to the census as an all-gather. No gradient."""
    p = _axis_size(mesh, axis)
    if p == 1:
        return x
    if x.is_meta:
        return _all_gather(x, mesh, axis, dim)
    out = _all_gather(x.contiguous(), mesh, axis, dim, op="gather_heads")
    WIRE_BYTES["gather_heads"] += x.numel() * x.element_size()
    if op_analysis.CENSUS is not None:
        op_analysis.report_collective("all-gather", out.numel() * out.element_size(), p)
    return out


def gather_for_use(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``x``'s blocks over ``axes`` gathered along ``dim`` (row-major rank
    order); the gradient is reduce-scattered back in rank order (FSDP)."""
    axes = tuple(axes)
    if _axis_size(mesh, axes) == 1:
        return x
    return _GatherForUse.apply(x, mesh, axes, dim)


def gather_replicated(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``x``'s blocks over ``axes`` gathered along ``dim``, for a result
    every rank uses alike (an embedding's width, a vocab-split logit row):
    the gradient of a rank's block is its slice of the whole."""
    axes = tuple(axes)
    if _axis_size(mesh, axes) == 1:
        return x
    return _GatherReplicated.apply(x, mesh, axes, dim)


def vocab_parallel_logsumexp(logits: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``logsumexp`` over the last dim of logits whose vocab is split over
    ``axis``: the max over the ranks (no gradient: it cancels), then the
    sum of ``exp(logit − max)`` in rank order with its gradient passed
    through (every rank uses the sum alike)."""
    m = logits.detach().amax(dim=-1)
    if _axis_size(mesh, axis) > 1:
        m = _pmax(m, mesh, axis)
    s = psum_replicated(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, (axis,))
    return m + torch.log(s)


def vocab_parallel_pick(logits: torch.Tensor, labels: torch.Tensor, mesh, axis,
                        vocab_lo: int) -> torch.Tensor:
    """``logits[..., labels]`` where the vocab is split over ``axis`` and this
    rank holds ids ``[vocab_lo, vocab_lo + V_loc)``: the owner's logit,
    zeros elsewhere, summed over the ranks (gradient passed through)."""
    local = labels - vocab_lo
    own = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return psum_replicated(torch.where(own, picked, 0.0), mesh, (axis,))


def gather_matches(m: Matches, mesh, axes=None, *, scatter: bool = False) -> Matches:
    """The global ``Matches`` on every rank, from each rank's result.

    ``axes`` names the axis (or row-major tuple of axes) the rows are
    sharded over: ``axis_name`` for horizontal, ``axes`` for hierarchical,
    ``row_axis`` for 2-D. ``None`` returns a replicated result (vertical
    allreduce, compressed, recursive) as it is. ``scatter=True`` takes the
    stacked ``(nb, rows_per_dev)`` slices of the scatter accumulation over
    ``axes`` and returns them in global row order.
    """
    if axes is None:
        return m
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else axes
    if scatter:
        return Matches(*(_all_gather(x, mesh, axes, dim=1).flatten(0, 1) for x in m))
    return Matches(*(_all_gather(x, mesh, axes) for x in m))


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------


def _dense_cell(D, rows: slice, cols: slice, dev: torch.device) -> torch.Tensor:
    """``D[rows, cols]`` of a global numpy array, tensor or
    ``core.sparse.DenseView`` (which densifies only the cell), on ``dev``."""
    if isinstance(D, np.ndarray):  # a copy: a memory-mapped corpus is read-only
        return as_corpus(np.array(D[rows, cols]), dev)
    if isinstance(D, DenseView):
        return D.dense_cell(rows, cols, dev)
    return as_corpus(torch.as_tensor(D)[rows, cols], dev)


def _sparse_rows(D: SparseCorpus, rows: slice, dev: torch.device) -> SparseCorpus:
    return SparseCorpus(D.indices[rows], D.values[rows], D.nnz[rows], D.m).to(dev)


def _split(n: int, parts: int, me: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what}={n} must be a multiple of {parts}")
    size = n // parts
    return slice(me * size, (me + 1) * size)


def _check_sparse_kernel(D, use_kernel: bool) -> None:
    if isinstance(D, SparseCorpus) and use_kernel:
        raise ValueError(_SPARSE_KERNEL)


def _wire_itemsize(D) -> int:
    """Bytes/element of a dense block on the wire: bf16 travels as 2 bytes,
    every other dtype as the float32 ``as_corpus`` makes of it."""
    return 2 if isinstance(D, torch.Tensor) and D.dtype == torch.bfloat16 else 4


def _axis_label(axis_name) -> str:
    if isinstance(axis_name, (tuple, list)):
        return "+".join(axis_name)
    return str(axis_name)


def _block_bytes(D, n_loc: int) -> tuple[int, str]:
    """Bytes and payload name of a travelling row block of ``n_loc`` rows."""
    if isinstance(D, SparseCorpus):
        return telemetry.csr_block_bytes(n_loc, D.cap), "csr_block"
    return telemetry.dense_block_bytes(n_loc, D.shape[1], _wire_itemsize(D)), "dense_block"


def _telemetry_ticker(ticker, dev):
    """The caller's ticker, else one created for the record when telemetry
    is on (the reference's sweeps create theirs the same way)."""
    if ticker is None and telemetry.enabled():
        from repro_torch.distributed.straggler import StepTicker

        return StepTicker(dev)
    return ticker


# ---------------------------------------------------------------------------
# 1-D horizontal (paper Alg. 6): rows distributed over `axis_name`
# ---------------------------------------------------------------------------


def apss_horizontal(
    D,
    threshold: float,
    k: int,
    mesh,
    axis_name: str | tuple[str, ...] = "data",
    *,
    schedule: str = "ring",
    block_rows: int = 512,
    use_kernel: bool = False,
    device: str | torch.device = "cuda",
) -> Matches:
    """Distributed APSS with row sharding; returns this rank's rows.

    ``axis_name`` may be a tuple of axes (taken jointly, row-major) for the
    allgather schedule. ``use_kernel=True`` scores every block pair with K1
    at the step's row and column offsets. ``D`` may be a ``SparseCorpus``
    (all three schedules): the CSR triple shards and travels, and every
    block pair is scored with the gather-dot join.
    """
    dev = device_of(device)
    _check_sparse_kernel(D, use_kernel)
    if schedule not in ("allgather", "ring", "halfring"):
        raise ValueError(f"unknown horizontal schedule: {schedule}")
    if isinstance(axis_name, (tuple, list)):
        axis_name = tuple(axis_name)
        if isinstance(D, SparseCorpus):
            raise ValueError("sparse horizontal needs a single axis name")
        if schedule != "allgather":
            raise ValueError(
                "ring/halfring need a single axis; use "
                "apss_horizontal_hierarchical for multi-axis row sharding"
            )
    p = _axis_size(mesh, axis_name)
    me = _axis_index(mesh, axis_name)
    rows = _split(D.shape[0], p, me, "n")
    n_loc = rows.stop - rows.start
    if telemetry.enabled():
        n, m = D.shape
        sparse = isinstance(D, SparseCorpus)
        block, payload = _block_bytes(D, n_loc)
        telemetry.record(telemetry.ApssStats(
            variant=f"horizontal/{schedule}",
            n=n, m=m, devices=p, block_rows=block_rows, sparse=sparse,
            hops=telemetry.horizontal_hops(
                schedule, p, _axis_label(axis_name), block,
                telemetry.matches_bytes(n_loc, k), payload=payload,
            ),
            flops=telemetry.sparse_join_flops(n_loc, n, D.cap) if sparse
            else telemetry.dense_join_flops(n_loc, n, m)
            * (0.55 if schedule == "halfring" and not use_kernel else 1.0),
            extra={"cap": D.cap} if sparse else {"use_kernel": use_kernel},
        ))
    if isinstance(D, SparseCorpus):
        loc = _sparse_rows(D, rows, dev)
        buf = (loc.indices, loc.values, loc.nnz)

        def join(Q, C, row_o, col_o):
            return sparse_similarity_topk(
                Q, C, threshold, k, block_rows=min(block_rows, n_loc),
                exclude_self=True, row_offset=row_o, col_offset=col_o,
            )

        def travelling(b):
            return SparseCorpus(*b, D.m)
    else:
        loc = _dense_cell(D, rows, slice(None), dev)
        buf = (loc,)

        def join(Q, C, row_o, col_o):
            return similarity_topk(
                Q, C, threshold, k, block_rows=min(block_rows, n_loc),
                exclude_self=True, row_offset=row_o, col_offset=col_o,
                use_kernel=use_kernel, device=dev,
            )

        def travelling(b):
            return b[0]

    if schedule == "allgather":
        every = tuple(_all_gather(x, mesh, axis_name) for x in buf)
        return join(loc, travelling(every), me * n_loc, 0)
    if schedule == "ring":
        return _horizontal_ring(buf, travelling, join, loc, mesh, axis_name, p, me, n_loc, k)
    return _horizontal_halfring(
        buf, travelling, join, loc, mesh, axis_name, p, me, n_loc, k,
        threshold=threshold, use_kernel=use_kernel,
    )


def _horizontal_ring(buf, travelling, join, loc, mesh, axis, p, me, n_loc, k):
    """Ring schedule: ``p - 1`` hops of the row block."""
    matches = empty_matches(n_loc, k, loc.device)
    for s in range(p):
        # Send the block onward before using it (the reference's order).
        nxt = _ppermute(buf, mesh, axis, _ring_perm(p)) if s < p - 1 else None
        src = (me - s) % p
        matches = merge_matches(
            matches, join(loc, travelling(buf), me * n_loc, src * n_loc))
        buf = nxt
    return matches


def _horizontal_halfring(buf, travelling, join, loc, mesh, axis, p, me, n_loc, k, *,
                         threshold, use_kernel):
    """Half-ring: S = Sᵀ, so only ``⌊p/2⌋`` block hops.

    At offset ``s`` the visitor scores the cross tile once, keeps the
    forward matches (its own rows) and folds the backward matches (the
    owner's rows) into the caravan that hops with the block. For even ``p``
    the last offset is the antipodal pair, whose both orientations are
    covered forward: its backward join is skipped, else pairs would count
    twice. One shift by ``⌊p/2⌋`` then takes the caravan home. The dense
    plain path reads one score tile both ways; the kernel and sparse paths
    run two joins with swapped offsets.
    """
    row_off = me * n_loc
    half = p // 2
    matches = join(loc, loc, row_off, row_off)
    if p == 1:
        return matches
    dense_plain = not use_kernel and isinstance(loc, torch.Tensor)

    def cross_tile(cur, col_off, need_bwd):
        if dense_plain:
            S = dot_f32(loc, cur)
            fwd = extract_matches(S, threshold, k, row_offset=row_off,
                                  col_offset=col_off, exclude_self=True)
            if not need_bwd:
                return fwd, None
            return fwd, extract_matches(S.T, threshold, k, row_offset=col_off,
                                        col_offset=row_off, exclude_self=True)
        fwd = join(loc, cur, row_off, col_off)
        return fwd, (join(cur, loc, col_off, row_off) if need_bwd else None)

    caravan = empty_matches(n_loc, k, loc.device)
    for s in range(1, half + 1):
        moved = _ppermute((*buf, *caravan), mesh, axis, _ring_perm(p))
        buf, caravan = moved[:len(buf)], Matches(*moved[len(buf):])
        need_bwd = p % 2 == 1 or s < half
        fwd, bwd = cross_tile(travelling(buf), ((me - s) % p) * n_loc, need_bwd)
        if bwd is not None:
            caravan = merge_matches(caravan, bwd)
        matches = merge_matches(matches, fwd)
    # The caravan holds the rows of rank (me - half): send it home.
    home = Matches(*_ppermute(tuple(caravan), mesh, axis, _shift_perm(p, half)))
    return merge_matches(matches, home)


# ---------------------------------------------------------------------------
# Hierarchical horizontal: a nested ring over several axes
# ---------------------------------------------------------------------------


def _nested_ring_sweep(mesh, axes, buf, owner, matches, join, *, ticker=None,
                       rank=None):
    """The nested-ring sweep of dense blocks and CSR triples alike.

    ``buf`` (a tuple of tensors) hops with its one-element int32 ``owner``;
    ``join(buf, owner, matches)`` scores the local rows against the
    travelling block. The innermost axis rings most often; each outer axis
    hops once per full inner sweep. Every rank issues the same hops in the
    same order. ``ticker`` (with ``rank``, the caller's flat rank) takes
    one tick per compute: ``∏ sizes`` ticks per rank for a full sweep.
    """
    step = [0]

    def compute(buf, owner, matches):
        matches = join(buf, owner, matches)
        if ticker is not None:
            ticker.emit(step[0], rank, matches.counts.sum())
        step[0] += 1
        return matches

    def sweep(level, buf, owner, matches):
        if level == len(axes):
            return buf, owner, compute(buf, owner, matches)
        axis = axes[level]
        for _ in range(_axis_size(mesh, axis) - 1):
            buf, owner, matches = sweep(level + 1, buf, owner, matches)
            *buf, owner = _ppermute((*buf, owner), mesh, axis,
                                    _ring_perm(_axis_size(mesh, axis)))
            buf = tuple(buf)
        return sweep(level + 1, buf, owner, matches)  # last sub-sweep: no hop

    return sweep(0, buf, owner, matches)[2]


def apss_horizontal_hierarchical(
    D,
    threshold: float,
    k: int,
    mesh,
    axes: Sequence[str] = ("pod", "data"),
    *,
    block_rows: int = 512,
    use_kernel: bool = False,
    device: str | torch.device = "cuda",
    ticker=None,
) -> Matches:
    """N-level nested ring for hierarchical interconnects; returns this
    rank's rows.

    Rows shard over ``axes`` jointly (row-major). The travelling block
    carries its owner id, so the column offset of the current block is
    ``owner · n_loc``. ``use_kernel=True`` scores each block pair with K1.
    ``D`` may be a ``SparseCorpus``: the CSR triple rides the same rings.
    ``ticker`` (a ``distributed.straggler.StepTicker``) takes one tick per
    rank per compute.
    """
    dev = device_of(device)
    _check_sparse_kernel(D, use_kernel)
    axes = tuple(axes)
    p = _axis_size(mesh, axes)
    flat = _axis_index(mesh, axes)
    rows = _split(D.shape[0], p, flat, "n")
    n_loc = rows.stop - rows.start
    bs = min(block_rows, n_loc)
    ticker = _telemetry_ticker(ticker, dev)
    if telemetry.enabled():
        n = D.shape[0]
        sparse = isinstance(D, SparseCorpus)
        sizes = tuple(_axis_size(mesh, a) for a in axes)
        block, payload = _block_bytes(D, n_loc)
        telemetry.record(telemetry.ApssStats(
            variant="hierarchical",
            n=n, m=D.shape[1], devices=p, block_rows=block_rows, sparse=sparse,
            hops=telemetry.hierarchical_hops(sizes, axes, block, payload=payload),
            flops=telemetry.sparse_join_flops(n_loc, n, D.cap) if sparse
            else telemetry.dense_join_flops(n_loc, n, D.shape[1]),
            extra={"axes": dict(zip(axes, sizes)), "use_kernel": use_kernel},
            step_ticker=ticker,
        ))
    if isinstance(D, SparseCorpus):
        loc = _sparse_rows(D, rows, dev)
        buf = (loc.indices, loc.values, loc.nnz)

        def score(b, col_off):
            return sparse_similarity_topk(
                loc, SparseCorpus(*b, D.m), threshold, k, block_rows=bs,
                exclude_self=True, row_offset=flat * n_loc, col_offset=col_off,
            )
    else:
        loc = _dense_cell(D, rows, slice(None), dev)
        buf = (loc,)

        def score(b, col_off):
            return similarity_topk(
                loc, b[0], threshold, k, block_rows=bs, exclude_self=True,
                row_offset=flat * n_loc, col_offset=col_off,
                use_kernel=use_kernel, device=dev,
            )

    def join(b, owner, matches):
        return merge_matches(matches, score(b, int(owner[0]) * n_loc))

    owner = torch.tensor([flat], dtype=torch.int32, device=dev)
    return _nested_ring_sweep(mesh, axes, buf, owner, empty_matches(n_loc, k, dev), join,
                              ticker=ticker, rank=flat)


# ---------------------------------------------------------------------------
# 1-D vertical (paper Algs. 3-5): dimensions distributed over `axis_name`
# ---------------------------------------------------------------------------


def apss_vertical(
    D,
    threshold: float,
    k: int,
    mesh,
    axis_name: str = "model",
    *,
    accumulation: str = "compressed",
    block_rows: int = 512,
    candidate_capacity: int | None = None,
    return_stats: bool = False,
    device: str | torch.device = "cuda",
) -> Matches | tuple[Matches, ApssStats]:
    """Distributed APSS with dimension (feature) sharding.

    Every rank sees all rows in an ``m/p`` dimension slice and computes
    partial scores, which the ``accumulation`` sums (module docstring). ``D``
    may be a ``SparseCorpus``: the dimension split then cuts the inverted
    index on the host (``shard_dims``), and partials come from the sparse
    gather-dot primitive; the accumulations are the same.
    """
    dev = device_of(device)
    p = _axis_size(mesh, axis_name)
    me = mesh.get_local_rank(axis_name)
    n = D.shape[0]
    if isinstance(D, SparseCorpus):
        idx_s, val_s, _, m_loc = shard_dims(D, p)  # host split
        cap_loc = idx_s.shape[-1]
        idx = torch.from_numpy(idx_s[me]).to(dev)
        val = torch.from_numpy(val_s[me]).to(dev)
        partials_fn = _sparse_partials(idx, val, m_loc, n, block_rows)
    else:
        D_loc = _dense_cell(D, slice(None), _split(D.shape[1], p, me, "m"), dev)

        def partials_fn(blk):
            return dot_f32(D_loc[blk * block_rows:(blk + 1) * block_rows], D_loc)

    out = _vertical_dispatch(
        partials_fn, n, threshold, k, mesh, axis_name, accumulation=accumulation,
        block_rows=block_rows, candidate_capacity=candidate_capacity,
        return_stats=return_stats, device=dev,
    )
    if telemetry.enabled():
        sparse = isinstance(D, SparseCorpus)
        C = candidate_capacity or default_candidate_capacity(k)
        telemetry.record(telemetry.ApssStats(
            variant=f"vertical/{accumulation}",
            n=n, m=D.shape[1], devices=p, block_rows=block_rows, sparse=sparse,
            hops=telemetry.vertical_hops(accumulation, str(axis_name), p, n, block_rows, C),
            flops=telemetry.sparse_join_flops(n, n, cap_loc) if sparse
            else telemetry.dense_join_flops(n, n, D.shape[1]) / p,
            extra={"capacity": C, "cap_loc": cap_loc} if sparse else {"capacity": C},
        ))
    return out


def _sparse_partials(idx, val, m_loc, n, block_rows):
    """Partial scores of query block ``blk`` against every row, from this
    rank's posting-list slice ``(n, cap_loc)``."""
    sp_loc = SparseCorpus(idx, val, torch.zeros_like(idx[:, 0]), m_loc)

    def partials(blk):
        qd = densify_rows(sp_loc, blk * block_rows, block_rows)
        return torch.cat([
            gather_dot(qd, idx[c:c + block_rows], val[c:c + block_rows])
            for c in range(0, n, block_rows)
        ], dim=1)

    return partials


def _vertical_dispatch(
    partials_fn, n, threshold, k, mesh, axis_name, *, accumulation, block_rows,
    candidate_capacity, return_stats, device,
):
    """The accumulations of dense and sparse vertical inputs alike:
    ``partials_fn(blk) -> (block_rows, n)`` partial scores of query block
    ``blk`` in this rank's dimension slice."""
    p = _axis_size(mesh, axis_name)
    C = candidate_capacity or default_candidate_capacity(k)
    if n % block_rows != 0:
        raise ValueError(f"n={n} must be a multiple of block_rows={block_rows}")
    nb = n // block_rows
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    parts = []
    if accumulation == "allreduce":
        for blk in range(nb):
            S = _psum(partials_fn(blk), mesh, axis_name)
            parts.append(extract_matches(S, threshold, k, row_offset=blk * block_rows,
                                         exclude_self=True))
    elif accumulation == "scatter":
        if block_rows % p != 0:
            raise ValueError("scatter accumulation needs block_rows % p == 0")
        rows_per_dev = block_rows // p
        me = mesh.get_local_rank(axis_name)
        for blk in range(nb):
            S_slice = _psum_scatter(partials_fn(blk), mesh, axis_name)
            parts.append(extract_matches(
                S_slice, threshold, k,
                row_offset=blk * block_rows + me * rows_per_dev, exclude_self=True,
            ))
        out = Matches(*(torch.stack(f) for f in zip(*parts)))  # (nb, rows_per_dev, ...)
        stats = ApssStats(overflow_rows=overflow)
        return (out, stats) if return_stats else out
    elif accumulation in ("compressed", "recursive"):
        if accumulation == "recursive" and p & (p - 1):
            raise ValueError("recursive accumulation needs power-of-two shards")
        reduce = _compressed_block if accumulation == "compressed" else _recursive_block
        for blk in range(nb):
            m, ov = reduce(partials_fn(blk), mesh, axis_name, p, threshold, k, C,
                           row_offset=blk * block_rows)
            parts.append(m)
            overflow = overflow + ov
        # Overflow counts are per rank; any truncation anywhere invalidates
        # the exactness of the affected rows, so expose the largest.
        overflow = _pmax(overflow, mesh, axis_name)
    else:
        raise ValueError(f"unknown vertical accumulation: {accumulation}")
    out = Matches(*(torch.cat(f) for f in zip(*parts)))
    stats = ApssStats(overflow_rows=overflow)
    return (out, stats) if return_stats else out


def _local_candidates(A, t_local, capacity):
    """Top-``capacity`` local candidates at the Lemma-1 threshold ``t/p``:
    ``(values, ids, overflowed rows)``, ties to the lower id."""
    masked = torch.where(A >= float(t_local), A, NEG_INF)
    c_val, c_idx = stable_topk(masked, capacity)
    c_idx = torch.where(c_val > NEG_INF, c_idx, -1).to(torch.int32)
    n_cand = (masked > NEG_INF).sum(dim=-1)
    overflow = (n_cand > c_val.shape[-1]).sum(dtype=torch.int32)
    return c_val, c_idx, overflow


def _rescore(A, c_idx, mesh, axis, col_offset=0):
    """Exact scores at the union of every rank's candidate ids: gather the
    ids, take this rank's partial at each, and sum over ``axis``."""
    all_idx = _all_gather(c_idx, mesh, axis, dim=1)  # (b, p·C)
    mine = torch.gather(A, 1, all_idx.clamp_min(0).long())
    total = _psum(torch.where(all_idx >= 0, mine, 0.0), mesh, axis)
    return total, torch.where(all_idx >= 0, all_idx + col_offset, -1)


def _compressed_block(A, mesh, axis, p, threshold, k, capacity, *, row_offset,
                      col_offset=0):
    """Local pruning (Lemma 1) and candidate compaction (paper §5.1.3-5.1.4)
    of one block's partials: threshold at ``t/p``, keep the top C, gather the
    candidate ids (volume p·C per row, not n), psum this rank's partials at
    the union, and filter exactly at ``t``."""
    _, c_idx, overflow = _local_candidates(A, local_threshold(threshold, p), capacity)
    total, gidx = _rescore(A, c_idx, mesh, axis, col_offset)
    m = matches_from_candidates(total, gidx, threshold, k, row_offset=row_offset,
                                exclude_self=True, dedupe=True)
    return m, overflow


def _pairwise_merge_candidates(idx_a, val_a, ub_a, idx_b, val_b, ub_b, capacity):
    """Merge two per-row candidate lists, summing values on shared ids.

    Inputs are ``(rows, C)`` each; at most two copies of an id exist, so a
    stable sort by id and an adjacent combine are exact. Keeps the top
    ``capacity`` by upper bound (ties to the lower position).
    """
    idx = torch.cat([idx_a, idx_b], dim=-1)
    val = torch.cat([val_a, val_b], dim=-1)
    ub = torch.cat([ub_a, ub_b], dim=-1)
    order = torch.argsort(idx, dim=-1, stable=True)
    idx = torch.gather(idx, -1, order)
    val = torch.gather(val, -1, order)
    ub = torch.gather(ub, -1, order)
    same = idx[:, 1:] == idx[:, :-1]
    no = torch.zeros_like(same[:, :1])
    nxt_same = torch.cat([same, no], dim=-1)
    prv_same = torch.cat([no, same], dim=-1)
    # Push a duplicate's contribution into the second copy; drop the first.
    val = torch.where(prv_same, val + torch.cat([torch.zeros_like(val[:, :1]), val[:, :-1]], -1),
                      val)
    ub = torch.where(prv_same, ub + torch.cat([torch.zeros_like(ub[:, :1]), ub[:, :-1]], -1), ub)
    dead = nxt_same | (idx < 0)
    ub = torch.where(dead, NEG_INF, ub)
    sel_ub, sel = stable_topk(ub, capacity)
    out_idx = torch.gather(idx, -1, sel)
    out_val = torch.gather(val, -1, sel)
    live = sel_ub > NEG_INF
    # Capacity truncation breaks the exactness argument (an absent candidate
    # no longer implies it was below the level threshold): count it.
    n_live = (~dead).sum(dim=-1)
    overflow = (n_live > capacity).sum(dtype=torch.int32)
    return (
        torch.where(live, out_idx, -1),
        torch.where(live, out_val, 0.0),
        torch.where(live, sel_ub, NEG_INF),
        overflow,
    )


def _recursive_block(A, mesh, axis, p, threshold, k, capacity, *, row_offset):
    """Recursive local pruning on a hypercube (paper §5.1.5-5.1.6, Alg. 5) of
    one block's partials.

    ``log₂ p`` pairwise exchanges; at level ℓ (a subcube of s = 2^(ℓ+1)
    shards) candidates are filtered at ``t·s/p`` on an upper bound ``ub =
    val + (the missing half's threshold)``, which keeps the filter exact with
    one-sided knowledge. The top level's candidates are rescored exactly.
    """
    t = torch.tensor(threshold, dtype=torch.float32)
    c_val, c_idx, overflow = _local_candidates(A, local_threshold(threshold, p), capacity)
    c_ub = torch.where(c_idx >= 0, c_val, NEG_INF)
    for lvl in range(p.bit_length() - 1):
        bit = 1 << lvl
        sub_t = float(t * (2.0 * bit) / p)  # threshold of the merged subcube
        half_t = float(t * float(bit) / p)  # bound of the missing half
        o_idx, o_val, o_ub = _ppermute(
            (c_idx, c_val, c_ub), mesh, axis, [(i, i ^ bit) for i in range(p)])
        # One-sided candidates get the partner half's headroom added to ub;
        # a summed pair then counts it twice, which is looser but sound.
        c_ub_adj = torch.where(c_idx >= 0, c_ub + half_t, NEG_INF)
        o_ub_adj = torch.where(o_idx >= 0, o_ub + half_t, NEG_INF)
        m_idx, m_val, m_ub, merge_ovf = _pairwise_merge_candidates(
            c_idx, c_val, c_ub_adj, o_idx, o_val, o_ub_adj, capacity)
        overflow = overflow + merge_ovf
        keep = m_ub >= sub_t
        c_idx = torch.where(keep, m_idx, -1)
        c_val = torch.where(keep, m_val, 0.0)
        c_ub = torch.where(keep, m_ub, NEG_INF)
    # Top level: candidate ids may still differ per rank (capacity effects):
    # take the union once, then rescore exactly.
    total, gidx = _rescore(A, c_idx, mesh, axis)
    m = matches_from_candidates(total, gidx, threshold, k, row_offset=row_offset,
                                exclude_self=True, dedupe=True)
    return m, overflow


# ---------------------------------------------------------------------------
# 2-D checkerboard (paper Alg. 7)
# ---------------------------------------------------------------------------


def apss_2d(
    D,
    threshold: float,
    k: int,
    mesh,
    row_axis: str = "data",
    col_axis: str = "model",
    *,
    accumulation: str = "compressed",
    block_rows: int = 512,
    candidate_capacity: int | None = None,
    return_stats: bool = False,
    device: str | torch.device = "cuda",
    ticker=None,
) -> Matches | tuple[Matches, ApssStats]:
    """2-D distribution: rows over ``row_axis``, dimensions over
    ``col_axis``; returns this rank's rows.

    A ring over the row axis composed with the vertical accumulation over
    the column axis at every ring step (paper Alg. 7). ``D`` may be a
    ``SparseCorpus``: cell ``(i, j)`` holds row shard ``i`` restricted to
    posting-list slice ``j`` (a host ``shard_dims`` split), and its CSR pair
    rides the row ring. ``ticker`` (a ``distributed.straggler.StepTicker``)
    takes one tick per rank per ring step; with telemetry on and no
    ``ticker``, one is created on ``device`` and attached to the record.
    """
    dev = device_of(device)
    if accumulation not in ("allreduce", "compressed"):
        raise ValueError(f"unknown 2-D accumulation: {accumulation}")
    q = _axis_size(mesh, row_axis)
    r = _axis_size(mesh, col_axis)
    me_r = mesh.get_local_rank(row_axis)
    me_c = mesh.get_local_rank(col_axis)
    rows = _split(D.shape[0], q, me_r, "n")
    n_loc = rows.stop - rows.start
    bs = _block_clamp(block_rows, n_loc)
    C = candidate_capacity or default_candidate_capacity(k)
    ticker = _telemetry_ticker(ticker, dev)
    cap_loc = None
    if isinstance(D, SparseCorpus):
        idx_s, val_s, nnz_s, m_loc = shard_dims(D, r)  # host split
        cap_loc = idx_s.shape[-1]
        idx = torch.from_numpy(idx_s[me_c, rows]).to(dev)
        val = torch.from_numpy(val_s[me_c, rows]).to(dev)
        sp_loc = SparseCorpus(idx, val, torch.from_numpy(nnz_s[me_c, rows]).to(dev), m_loc)
        buf0 = (idx, val)  # scoring sums every slot: nnz need not travel

        def partials(buf, blk):
            return gather_dot(densify_rows(sp_loc, blk * bs, bs), *buf)
    else:
        D_loc = _dense_cell(D, rows, _split(D.shape[1], r, me_c, "m"), dev)
        buf0 = (D_loc,)

        def partials(buf, blk):
            return dot_f32(D_loc[blk * bs:(blk + 1) * bs], buf[0])

    if telemetry.enabled():
        n, m = D.shape
        extra = {"mesh": {str(row_axis): q, str(col_axis): r}}
        if cap_loc is not None:
            extra["cap_loc"] = cap_loc
        telemetry.record(telemetry.ApssStats(
            variant=f"2d/{accumulation}",
            n=n, m=m, devices=q * r, block_rows=bs, sparse=cap_loc is not None,
            hops=telemetry.twod_hops(
                q, r, str(row_axis), str(col_axis), n_loc, m,
                4 if cap_loc is not None else _wire_itemsize(D), bs, C, accumulation,
                cap_loc=cap_loc,
            ),
            flops=telemetry.dense_join_flops(n_loc, n, m) / r if cap_loc is None
            else telemetry.sparse_join_flops(n_loc, n, cap_loc),
            extra=extra, step_ticker=ticker,
        ))
    out, stats = _checkerboard_sweep(
        partials, buf0, n_loc, threshold=threshold, k=k, mesh=mesh, row_axis=row_axis,
        col_axis=col_axis, bs=bs, capacity=C, accumulation=accumulation, device=dev,
        ticker=ticker,
    )
    return (out, stats) if return_stats else out


def _checkerboard_sweep(partials_fn, buf0, n_loc, *, threshold, k, mesh, row_axis,
                        col_axis, bs, capacity, accumulation, device, ticker=None):
    """The 2-D sweep of both representations: a ring of ``buf0`` over
    ``row_axis``; at each step ``partials_fn(buf, blk) -> (bs, n_loc)`` scores
    local query block ``blk`` against the travelling cell in this rank's
    dimension slice, and the block's scores are accumulated over
    ``col_axis``. ``ticker`` takes one tick per ring step from this rank
    (``row · r + column``), on the step's merged counts."""
    q = _axis_size(mesh, row_axis)
    r = _axis_size(mesh, col_axis)
    me_r = mesh.get_local_rank(row_axis)
    rank = me_r * r + mesh.get_local_rank(col_axis)
    row_off = me_r * n_loc
    matches = empty_matches(n_loc, k, device)
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    buf = buf0
    for s in range(q):
        nxt = _ppermute(buf, mesh, row_axis, _ring_perm(q)) if s < q - 1 else None
        col_off = ((me_r - s) % q) * n_loc
        parts = []
        for blk in range(n_loc // bs):
            A = partials_fn(buf, blk)
            if accumulation == "allreduce":
                S = _psum(A, mesh, col_axis)
                parts.append(extract_matches(S, threshold, k, row_offset=row_off + blk * bs,
                                             col_offset=col_off, exclude_self=True))
            else:
                m, ov = _compressed_block(A, mesh, col_axis, r, threshold, k, capacity,
                                          row_offset=row_off + blk * bs, col_offset=col_off)
                parts.append(m)
                overflow = overflow + ov
        matches = merge_matches(matches, Matches(*(torch.cat(f) for f in zip(*parts))))
        if ticker is not None:
            ticker.emit(s, rank, matches.counts.sum())
        buf = nxt
    overflow = _pmax(_pmax(overflow, mesh, col_axis), mesh, row_axis)
    return matches, ApssStats(overflow_rows=overflow)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def apss(
    D,
    threshold: float,
    k: int,
    mesh,
    *,
    distribution: str = "2d",
    **kwargs,
) -> Matches | tuple[Matches, ApssStats]:
    """Top-level entry: pick a data distribution (the paper finds the best
    one dataset-dependent, so all are first-class). ``kwargs`` go to the
    entry point (``device=`` among them).

    ``distribution="auto"`` hands the choice to the execution planner
    (``planner.plan_apss``, on every rank): corpus statistics are sampled,
    every valid ``(variant, block_rows, use_kernel)`` configuration is
    priced by the calibrated cost models, and the cheapest one runs. Extra
    ``kwargs`` (``profile=``, ``autotune=``, ``block_rows_choices=``,
    ``device=`` …) go to the planner. The result's layout is the chosen
    variant's (``Plan.result_layout``). The dispatch runs in an ``apss``
    span (attribute ``distribution``): the entry point's record, and the
    ring steps of its ``StepTicker``, land in it."""
    with trace.span("apss", distribution=distribution):
        if distribution == "auto":
            from repro_torch.planner.plan import plan_apss

            return plan_apss(D, threshold, k, mesh, **kwargs).run()
        if distribution == "horizontal":
            return apss_horizontal(D, threshold, k, mesh, **kwargs)
        if distribution == "vertical":
            return apss_vertical(D, threshold, k, mesh, **kwargs)
        if distribution == "2d":
            return apss_2d(D, threshold, k, mesh, **kwargs)
        if distribution == "hierarchical":
            return apss_horizontal_hierarchical(D, threshold, k, mesh, **kwargs)
        raise ValueError(f"unknown distribution: {distribution}")
