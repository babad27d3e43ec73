"""Atomic, verified, async checkpointing with keep-last-k and auto-resume.

Fault-tolerance contract, the reference's (``repro.checkpoint``):

- **Atomic**: a checkpoint is written to ``step_XXXXXXXXXX.tmp/`` and
  renamed to ``step_XXXXXXXXXX/`` only after every leaf and the manifest
  are fsync'd, so a crash mid-write never corrupts the restore path.
- **Verified**: every leaf carries a blake2b digest in the manifest;
  ``load_checkpoint`` re-hashes on read, so a truncated or bit-flipped
  leaf raises :class:`CheckpointCorruptionError` instead of reshaping
  garbage into the restored state. Pre-digest checkpoints (no ``blake2b``
  key) still load.
- **Async, never silent**: ``CheckpointManager.save(..., blocking=False)``
  copies the state to host memory on the caller's thread and writes on a
  background thread. A failed background write (disk full, permissions)
  is captured and re-raised on the NEXT ``wait()``/``save()`` call.
- **Keep-last-k** with monotonic step directories; ``latest_step()`` +
  ``restore()`` give crash auto-resume. ``restore(fallback=True)`` walks
  back to the newest intact kept step.
- **Preemption**: ``install_preemption_handler`` checkpoints on
  SIGTERM/SIGINT.

State is a tree of dicts, lists and tuples (named tuples by field) whose
leaves are numpy arrays, tensors or scalars. :func:`_flatten_with_names`
names each leaf as JAX's ``tree_flatten_with_path`` does (dict keys sorted,
path parts ``/``-joined, ``None`` an empty subtree), and tensors go to the
host by ``.cpu().numpy()``. The on-disk format (manifest, leaf file names,
dtype names, digests) is the reference's byte for byte, so a directory
either package writes, the other reads; leaves are read back as numpy
arrays. A ``bfloat16`` leaf, which numpy cannot hold without
``ml_dtypes``, is written as its raw bytes under the dtype name
``bfloat16`` (the reference's format) by way of an ``int16`` view, and
read back as a CPU ``torch.bfloat16`` tensor.

A mesh run whose ranks hold blocks of the state (``save``/``restore`` with
``specs`` and ``mesh``: a rank's ``Transformer(mesh=)`` and its moments)
writes whole tensors, each leaf gathered in rank order to the host
(``distributed.sharding.gather_tree``), as the reference writes its global
arrays: the directory is the one a single process writes, and it restores
onto the same mesh bit for bit (every rank cuts its blocks) or onto one
process.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import signal
import threading
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.obs import recorder as _recorder
from repro_torch.obs import trace as _trace

_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d{10})$")


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint leaf failed its integrity check (digest/shape/read)."""


def _children(node):
    """``(path part, child)`` pairs of an inner node, None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten_with_names(tree) -> list[tuple[str, Any]]:
    """Leaves of ``tree`` with their ``/``-joined path names, in JAX's
    flattening order."""
    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append(("/".join(str(p) for p in path), node))
            return
        for part, child in kids:
            walk(child, path + (part,))

    walk(tree, ())
    return out


def _unflatten_like(like, leaves: dict, path=()):
    """``like``'s structure with each leaf replaced by ``leaves[name]``."""
    kids = _children(like)
    if kids is None:
        return leaves["/".join(str(p) for p in path)]
    if like is None:
        return None
    vals = [_unflatten_like(child, leaves, path + (part,)) for part, child in kids]
    if isinstance(like, dict):
        return {part: v for (part, _), v in zip(kids, vals)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def _is_bf16(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def _host_copy(leaf):
    """A host copy of a leaf: a numpy array, or a CPU tensor for bf16."""
    if _is_bf16(leaf):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def _raw(leaf) -> tuple[bytes, list, str]:
    """``(payload, shape, dtype name)`` of a leaf in the on-disk format."""
    if _is_bf16(leaf):
        t = leaf.detach().cpu().contiguous()
        return t.view(torch.int16).numpy().tobytes(), list(t.shape), "bfloat16"
    arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return np.ascontiguousarray(arr).tobytes(), list(arr.shape), str(arr.dtype)


def _from_raw(payload: bytes, shape: list, dtype_name: str):
    if dtype_name == "bfloat16":
        a = np.frombuffer(payload, np.int16).reshape(shape).copy()
        return torch.from_numpy(a).view(torch.bfloat16)
    return np.frombuffer(payload, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _itemsize(dtype_name: str) -> int:
    return 2 if dtype_name == "bfloat16" else np.dtype(dtype_name).itemsize


def save_checkpoint(state, directory: str, step: int) -> str:
    """Write one atomic checkpoint; returns the final directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = _flatten_with_names(state)
    manifest = {"step": step, "leaves": []}
    for name, leaf in leaves:
        fname = name.replace("/", "__") + ".npy"
        # Raw-byte serialization, the true dtype recorded beside it (the
        # reference's format, which also holds dtypes np.save cannot).
        payload, shape, dtype_name = _raw(leaf)
        raw = np.frombuffer(payload, np.uint8)
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, raw)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": shape,
             "dtype": dtype_name,
             "blake2b": hashlib.blake2b(payload, digest_size=16).hexdigest()}
        )
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_checkpoint(directory: str, step: int, like=None):
    """Load a checkpoint as a pytree of numpy arrays (bf16 leaves as CPU
    ``torch.bfloat16`` tensors).

    With ``like`` (a tree of the same structure), the result is
    unflattened into that structure; otherwise a flat ``{name: array}``
    dict is returned.

    Every leaf is verified against its manifest blake2b digest before
    reshaping; a digest mismatch, unreadable file, or byte-count mismatch
    raises :class:`CheckpointCorruptionError` naming the offending leaf.
    """
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {}
    for leaf in manifest["leaves"]:
        fpath = os.path.join(path, leaf["file"])
        try:
            raw = np.load(fpath)
            payload = raw.tobytes()
        except Exception as e:
            raise CheckpointCorruptionError(
                f"unreadable checkpoint leaf {fpath}: {e}"
            ) from e
        digest = leaf.get("blake2b")  # absent in pre-digest checkpoints
        if digest is not None:
            got = hashlib.blake2b(payload, digest_size=16).hexdigest()
            if got != digest:
                raise CheckpointCorruptionError(
                    f"checksum mismatch for leaf {fpath}: "
                    f"manifest {digest}, file {got}"
                )
        expect = int(np.prod(leaf["shape"])) * _itemsize(leaf["dtype"])
        if len(payload) != expect:
            raise CheckpointCorruptionError(
                f"truncated checkpoint leaf {fpath}: "
                f"{len(payload)} bytes, expected {expect}"
            )
        by_name[leaf["name"]] = _from_raw(payload, leaf["shape"], leaf["dtype"])
    if like is None:
        return by_name
    names = {n for n, _ in _flatten_with_names(like)}
    if names != set(by_name):
        raise ValueError(f"checkpoint/tree mismatch: {names ^ set(by_name)}")
    return _unflatten_like(like, by_name)


def _gather_to_host(state, specs, mesh):
    """``state`` with each leaf's blocks gathered over ``mesh`` in rank order
    and copied to the host, one leaf at a time (the card holds one whole
    leaf at most)."""
    from repro_torch.distributed.sharding import _map_with_specs, gather_tree

    return _map_with_specs(lambda x, spec: _host_copy(gather_tree(x, spec, mesh)),
                           state, specs)


class CheckpointManager:
    """keep-last-k manager with async writes and preemption handling."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._writer: threading.Thread | None = None
        self._async_error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # -- discovery ---------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save/restore ------------------------------------------------------

    def save(self, state, step: int, *, blocking: bool = True, specs=None,
             mesh=None) -> None:
        """Write ``state`` as ``step`` (keep-last-k). With ``specs`` and a
        ``mesh`` every rank calls this: the leaves are gathered whole to
        the host (collectives on every rank), then the mesh's first rank
        writes them and the others return."""
        if mesh is not None:
            state = _gather_to_host(state, specs, mesh)
            if any(c != 0 for c in mesh.get_coordinate()):
                return
        # Serialize against any in-flight async writer (same-step collisions
        # would otherwise race on the .tmp directory). wait() also re-raises
        # any captured async-write failure, so a silent disk-full/permission
        # error from a previous background write surfaces here.
        self.wait()
        if step in self.all_steps():
            return
        if blocking:
            with _trace.span("checkpoint/save", step=step):
                save_checkpoint(state, self.directory, step)
            self._gc()
            return
        # Copy to the host on the caller's thread (the caller may mutate its
        # tensors next), then write in the background.
        host_state = _unflatten_like(state, {
            name: _host_copy(leaf) for name, leaf in _flatten_with_names(state)})
        self._writer = threading.Thread(
            target=self._write_and_gc, args=(host_state, step), daemon=True
        )
        self._writer.start()

    def _write_and_gc(self, host_state, step: int) -> None:
        # Capture, never swallow: a daemon thread's uncaught exception is
        # lost forever, so stash it for the next wait()/save() to re-raise.
        try:
            save_checkpoint(host_state, self.directory, step)
            self._gc()
        except BaseException as e:  # noqa: BLE001 — re-raised on wait()
            self._async_error = e

    def wait(self) -> None:
        """Join any in-flight async write; re-raise a captured write error."""
        if self._writer is not None and self._writer.is_alive():
            self._writer.join()
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise err

    def restore(self, like=None, step: int | None = None, *,
                fallback: bool = False, specs=None, mesh=None):
        """Load ``step`` (default: latest). Returns ``(state, step)``; with
        ``specs`` and a ``mesh``, each leaf cut to this rank's block
        (``distributed.sharding.cut_tree``).

        With ``fallback=True``, a step that fails integrity checks
        (:class:`CheckpointCorruptionError`) is skipped with a warning and
        the next-older kept step is tried — resume costs one checkpoint
        window instead of the job. Raises only when every kept step is
        corrupt; returns ``(None, None)`` when none exist at all.
        """
        self.wait()
        if step is not None:
            candidates = [step]
        else:
            candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            return None, None
        last_err: Exception | None = None
        with _trace.span("checkpoint/restore", directory=self.directory):
            for s in candidates:
                try:
                    state = load_checkpoint(self.directory, s, like=like)
                    if mesh is not None:
                        from repro_torch.distributed.sharding import cut_tree

                        state = cut_tree(state, specs, mesh)
                    return state, s
                except CheckpointCorruptionError as e:
                    if not fallback:
                        raise
                    warnings.warn(
                        f"checkpoint step {s} corrupt ({e}); "
                        f"falling back to previous kept step",
                        stacklevel=2,
                    )
                    _trace.event("corruption_fallback", step=s)
                    _recorder.trigger(
                        "checkpoint.corruption_fallback", step=s,
                        error=str(e),
                    )
                    last_err = e
        raise CheckpointCorruptionError(
            f"every kept checkpoint in {self.directory} is corrupt"
        ) from last_err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:010d}"),
                ignore_errors=True,
            )

    # -- preemption --------------------------------------------------------

    def install_preemption_handler(
        self, get_state: Callable[[], tuple[Any, int]]
    ) -> None:
        """Checkpoint on SIGTERM/SIGINT (cluster preemption notice)."""

        def handler(signum, frame):
            state, step = get_state()
            save_checkpoint(state, self.directory, step)
            self._gc()
            raise SystemExit(128 + signum)

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
