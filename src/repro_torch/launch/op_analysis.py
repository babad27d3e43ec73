"""Op census of one eager call: FLOPs, device-memory bytes, collectives and
kernel launches, counted while the call runs.

The port's counterpart of the reference's ``launch/hlo_analysis.py``, which
parses optimized post-SPMD HLO text, multiplies loop bodies by their trip
counts and bills the ops a TPU does not fuse. Eager PyTorch builds no HLO;
it dispatches every op as it runs. So :func:`analyze` runs the call once
and counts three feeds:

- a ``TorchDispatchMode`` sees every aten op the call dispatches. FLOPs come
  from ``torch.utils.flop_counter``'s registry, per op (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``; ``einsum`` and a batched ``matmul`` reach
  ``bmm``). HBM bytes are the inputs plus outputs of every op that moves
  memory; views and metadata ops (``view``, ``permute``, ``detach``,
  ``empty``, ``item``...) are not billed. A gather bills its output twice
  and its indices, an in-place indexed write its sources twice, and a
  write-only op (``copy_``, ``fill_``, an ``out=`` overload) does not read
  its destination. A copy between two devices is not HBM traffic: it goes
  to ``host_copy_bytes`` (the gloo staging copies of
  ``core.distributed._to_wire``/``_from_wire``, and any other transfer
  between host and card). The ``c10d`` ops are skipped: collectives are
  billed at the collective layer;
- the collective helpers of ``core.distributed`` report each collective
  (:func:`report_collective`) with the reference's op names and ring
  factors, from the same tensors they count in ``WIRE_BYTES``;
- a kernel launch is opaque to the dispatcher, so each kernel wrapper
  reports its launch's work (:func:`report_kernel`) at the padded shapes
  the card computes. Work that only the launch decides (K5's skipped
  tiles, a mask's live tiles, K9's cache lengths) is reported as a
  callable and read when the census closes, never in the hot path.

With no census active every hook costs its caller one ``is None`` check
of :data:`CENSUS`: nothing reads a tensor or waits for the card.

Differences from the reference, by design: there is no trip-count logic
(every loop iteration dispatches its own ops, so the census multiplies
them by construction), and elementwise ops are billed (eager PyTorch fuses
nothing, where the reference's TPU fusion model leaves them out). Host
numpy stages (worklist compaction, support gathers) are not device work
and are not billed. ``n_ops`` (ops dispatched) takes the place of the
HLO-only ``n_computations`` and ``max_multiplier``. All numbers are this
process's: under a mesh, one rank's, as the reference's are one device's.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# Not billed: views (``OpOverload.is_view``) and these metadata,
# allocation and scalar-read ops.
_FREE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_unsafe_view", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "resize_", "set_", "record_stream", "_reshape_alias", "clone_preserve_strides",
})
# Read their output's worth of the source, not the whole source.
_GATHERS = frozenset({"index", "index_select", "gather", "embedding", "take"})
# In-place writes into a subset of their destination.
_INDEXED_WRITES = frozenset({
    "index_put_", "_index_put_impl_", "scatter_", "scatter_add_", "scatter_reduce_",
    "index_add_", "index_copy_", "index_fill_", "masked_fill_", "masked_scatter_",
})
# Write their output only: the input gives a shape, not data.
_LIKE = frozenset({
    "zeros_like", "ones_like", "full_like", "rand_like", "randn_like", "randint_like",
})
# In-place ops that do not read their destination.
_WRITE_ONLY = frozenset({
    "copy_", "fill_", "zero_", "normal_", "uniform_", "random_", "bernoulli_",
    "exponential_",
})

Work = Union[float, Callable[[], float]]

# The innermost active census (None: no census). Every hook checks it first.
CENSUS: Optional["Census"] = None
_STACK: list = []


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a tensor's elements span: its logical size, capped by its
    storage (an expanded tensor reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _tensors(x, out=None) -> list:
    """The tensors in an op's argument or result (nested tuples, lists and
    dicts)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _shapes(x):
    """``x`` with each tensor replaced by its shape (the flop formulas' input)."""
    if isinstance(x, torch.Tensor):
        return x.shape
    if isinstance(x, (tuple, list)):
        return type(x)(_shapes(v) for v in x)
    return x


class _OpInfo:
    """What the census needs of an op overload, worked out once."""

    __slots__ = ("name", "aten", "free", "flops", "args", "writes", "write_only")

    def __init__(self, func):
        from torch.utils.flop_counter import flop_registry

        self.name = func._schema.name.split("::")[-1]
        self.aten = func.namespace == "aten"
        self.free = func.is_view or self.name in _FREE
        count = flop_registry.get(func._overloadpacket)
        # The registry's formulas take shapes (its wrapper maps tensors to
        # shapes through pytree, which costs more than the formula).
        self.flops = getattr(count, "__wrapped__", count)
        self.args = [a.name for a in func._schema.arguments]
        self.writes = {a.name for a in func._schema.arguments
                       if a.alias_info is not None and a.alias_info.is_write}
        self.write_only = self.name in _WRITE_ONLY or func._overloadname.startswith("out")


_INFO: dict = {}


def link_bytes(kind: str, payload: float, group: int) -> float:
    """Per-device link bytes of one collective: the reference's ring factors
    (``hlo_analysis._collective_link_bytes``) on its payload convention
    (the result for all-gather and reduce-scatter, the operand otherwise)."""
    g = max(int(group), 1)
    if kind == "all-gather":
        return payload * (g - 1) / g
    if kind == "all-reduce":
        return 2 * payload * (g - 1) / g
    if kind == "reduce-scatter":
        return payload * (g - 1)
    if kind == "all-to-all":
        return payload * (g - 1) / g
    if kind == "collective-permute":
        return payload
    raise ValueError(f"unknown collective: {kind}")


class Census:
    """The counts of one :func:`analyze` call (see the module doc)."""

    def __init__(self, track_live: bool = False) -> None:
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.host_copy_bytes = 0.0
        self.n_ops = 0
        self.collectives = {
            k: {"count": 0, "payload_bytes": 0.0, "link_bytes": 0.0} for k in COLLECTIVES
        }
        self.link_by_group: dict[int, float] = {}
        self.kernels: dict[str, dict] = {}
        self.libraries: set[str] = set()
        self._pending: list = []
        self.track_live = track_live
        self.live_bytes = 0.0
        self.peak_live_bytes = 0.0
        self._live: dict = {}     # storage key -> (storage, bytes)

    # -- feeds -----------------------------------------------------------

    def op(self, func, args, kwargs, out) -> None:
        self.n_ops += 1
        if self.track_live:
            self._track(_tensors(out))
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _OpInfo(func)
        if not info.aten:
            return  # c10d: billed at the collective layer
        if info.flops is not None:
            self.flops += float(info.flops(*_shapes(args), out_shape=_shapes(out),
                                           **{k: _shapes(v) for k, v in kwargs.items()}))
        if info.free:
            return
        moved = self._bytes(info, args, kwargs, out)
        if moved is not None:
            self.hbm_bytes += moved

    def _bytes(self, info: _OpInfo, args, kwargs, out) -> Optional[float]:
        """HBM bytes of one op, or None after billing a cross-device copy
        to ``host_copy_bytes``."""
        name = info.name
        outs = _tensors(out)
        ins = _tensors(kwargs, _tensors(args))
        if name in ("_to_copy", "copy_") and len({t.device for t in ins + outs}) > 1:
            self.host_copy_bytes += _nbytes(args[1] if name == "copy_" else args[0])
            return None
        if name in _LIKE:
            return float(sum(map(_nbytes, outs)))
        if name in _GATHERS:
            return 2.0 * sum(map(_nbytes, outs)) + sum(map(_nbytes, ins[1:]))  # + indices
        if not info.writes:
            return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        mutated, read = [], []
        given = list(zip(info.args, args)) + list(kwargs.items())
        for a, v in given:
            (mutated if a in info.writes else read).extend(_tensors(v))
        if name in _INDEXED_WRITES:
            return 2.0 * sum(map(_nbytes, read))
        written = sum(map(_nbytes, mutated))
        return float(sum(map(_nbytes, read)) + (0 if info.write_only else written) + written)

    def _track(self, outs: list) -> None:
        """Add the storages ``outs`` create to the live set; before a new
        peak, drop those that nothing but the census holds any longer."""
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in self._live:
                continue
            n = st.nbytes()
            if self.live_bytes + n > self.peak_live_bytes:
                self._sweep()
            self._live[st._cdata] = (st, n)
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _sweep(self) -> None:
        for key, (st, n) in list(self._live.items()):
            if torch._C._storage_Use_Count(key) <= 1:   # only the census holds it
                del self._live[key]
                self.live_bytes -= n

    def kernel(self, name: str, library: str, flops: Work, nbytes: Work) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        self.libraries.add(library)
        self._pending.append((k, flops, nbytes))

    def collective(self, kind: str, payload: float, group: int) -> None:
        c = self.collectives[kind]
        c["count"] += 1
        c["payload_bytes"] += float(payload)
        link = link_bytes(kind, payload, group)
        c["link_bytes"] += link
        self.link_by_group[int(group)] = self.link_by_group.get(int(group), 0.0) + link

    # -- result ----------------------------------------------------------

    def resolve(self) -> None:
        """Read the kernels' deferred work (may wait for the card)."""
        for k, flops, nbytes in self._pending:
            f = float(flops() if callable(flops) else flops)
            b = float(nbytes() if callable(nbytes) else nbytes)
            k["flops"] += f
            k["bytes"] += b
            self.flops += f
            self.hbm_bytes += b
        self._pending.clear()

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "link_bytes": sum(v["link_bytes"] for v in self.collectives.values()),
            "link_bytes_by_group": {str(g): b for g, b in sorted(self.link_by_group.items())},
            "host_copy_bytes": self.host_copy_bytes,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "libraries": sorted(self.libraries),
            "n_ops": self.n_ops,
            **({"peak_live_bytes": self.peak_live_bytes} if self.track_live else {}),
        }


def report_kernel(name: str, library: str, flops: Work, nbytes: Work) -> None:
    """One launch of kernel ``name`` (from library ``library``) with its
    work: numbers, or callables read when the census closes. Callers check
    ``CENSUS is not None`` first."""
    for c in _STACK:
        c.kernel(name, library, flops, nbytes)


def report_collective(kind: str, payload_bytes: float, group: int) -> None:
    """One collective of ``kind`` (:data:`COLLECTIVES`) over ``group``
    ranks, ``payload_bytes`` by the reference's convention (see
    :func:`link_bytes`). Callers check ``CENSUS is not None`` first."""
    for c in _STACK:
        c.collective(kind, payload_bytes, group)


def _mode(census: Census):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Census(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            census.op(func, args, kwargs, out)
            return out

    return _Census()


def analyze_live(fn, *args, resident: float = 0.0):
    """:func:`analyze` that also tracks the storages the call's ops create:
    ``peak_live_bytes`` is the largest sum of live storages during the call
    on top of ``resident`` (the arguments' bytes). An estimate: no
    allocator rounding, no workspaces, and a storage counts from the op
    that makes it until the census sees nothing else holding it."""
    census = Census(track_live=True)
    census.live_bytes = census.peak_live_bytes = float(resident)
    for t in _tensors([list(a.parameters()) if isinstance(a, torch.nn.Module) else a
                       for a in args]):
        st = t.untyped_storage()   # in ``resident`` already: an op's view of it adds nothing
        census._live[st._cdata] = (st, 0)
    try:
        return _run(census, fn, args, {})
    finally:
        census._live.clear()


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a census: ``(result, counts)``,
    with the reference's keys ``flops``, ``hbm_bytes``, ``collectives``
    (``{kind: {count, payload_bytes, link_bytes}}``) and ``link_bytes``,
    and the port's ``link_bytes_by_group`` (``{group size: link bytes}``),
    ``host_copy_bytes``, ``kernels`` (``{name: {launches, flops,
    bytes}}``), ``libraries`` (the kernel libraries launched) and
    ``n_ops``. Censuses nest: an outer one counts
    what an inner one counts."""
    return _run(Census(), fn, args, kwargs)


def _run(census: Census, fn, args, kwargs):
    global CENSUS
    _STACK.append(census)
    CENSUS = census
    try:
        with _mode(census):
            result = fn(*args, **kwargs)
        census.resolve()
    finally:
        _STACK.remove(census)
        CENSUS = _STACK[-1] if _STACK else None
    return result, census.as_dict()
