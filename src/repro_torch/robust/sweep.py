"""Resumable APSS sweeps: a checkpointed block ring with elastic resume.

The ring schedules of ``core.distributed`` run a whole sweep in one call:
fast, but a lost rank late in an n²-scale job loses everything. This
module steps the same block-pair schedule from the host instead, and
checkpoints the accumulated ``Matches`` partials and the sweep cursor at
step boundaries.

Schedule (the paper's ring, globalized): ``D`` is padded to ``B`` row
blocks of ``bn`` rows; step ``s`` scores every block pair
``(i, (i - s) mod B)``. Over ``s ∈ [0, B)`` every ordered tile is scored
exactly once, so merging each step's ``Matches`` into the partials with
``merge_matches`` (disjoint column ranges, ties to the partials) is exact.

A step is one launch of K4's masked entry
(``kernels.apss_block.fused.rect_tile_candidates_kernel``) with the padded
corpus as both operands, a ``(2, T)`` worklist of row blocks ``i`` and
their partners, ``qpos`` = each row's global id (−1 on padded rows: the
self-exclusion) and ``col_live`` = column < n (the reference's
``col_valid``). Each row block has exactly one tile per step, so a tile's
packet is that step's ``Matches`` for its rows, with no fold. On the card
a 256-row block goes to K4 as two query blocks of 128 against one corpus
block of 256, and ``block_rows`` must be 64, 128 or 256. On a CPU tensor
the wrapper runs its plain version (any power of two), one
``(bn × m)·(m × bn)`` product per tile.

Why the result is bit for bit the same on any placement and after any
resume: each tile is one product of one shape, its scores do not depend
on which other tiles share the launch, and the merge is an exact stable
sort per row. With a ``DeviceMesh`` (``launch.mesh``) each rank holds the
whole padded corpus on its device and scores only its own contiguous row
blocks when ``B % p == 0``, every block otherwise (the reference's
degradation to replication); its partials are placed by
``distributed.elastic.reshard_tree``. No collective runs inside a step.
At a checkpoint boundary rank 0 of the mesh gathers the partials, writes
the full ``(n_pad, k)`` arrays, and a barrier releases the others; the
ranks also exchange their step times there, so that every rank's
``StepTimer`` holds every rank's ledger. Every rank restores from the
shared directory. ``run()`` returns the full ``Matches`` on every rank.

Fault hooks (``robust.faults``): a kill fault at a step raises
:class:`~repro_torch.robust.faults.SweepKilled` on every rank at that step,
before any collective; ``delay`` faults (matched on the rank's place in the
mesh) stretch a step inside its timed span, so that the slow rank shows in
the ledger; ``corrupt`` faults damage the partials caravan. Recovery from
an evicted straggler: :func:`mesh_after_eviction`, then
:meth:`ResumableSweep.resume_on` over the same directory.

The directory's format (``sweep_meta.json``, the step directories) is the
reference's byte for byte: either package resumes a sweep the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.matches import NEG_INF, Matches, merge_matches
from repro_torch.interop import device_of
from repro_torch.kernels.apss_block.fused import _TK, rect_tile_candidates_kernel
from repro_torch.obs import trace
from repro_torch.planner import telemetry

_META = "sweep_meta.json"
_K4_BLOCKS = (64, 128, 256)  # K4's corpus blocks (fused.rect_work_split)
_K4_MAX_Q = 128              # K4's largest query block
_COPY_ROWS = 1024            # rows of D copied to the device at a time


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sweep_step(Dd: torch.Tensor, blocks: np.ndarray, s: int, *, B: int, bn: int,
               n: int, threshold: float, k: int, col_live: torch.Tensor,
               qpos: torch.Tensor) -> Matches:
    """Step ``s``'s ``Matches`` for the row blocks ``blocks`` (ascending):
    one K4 launch over the tiles ``(i, (i - s) mod B)`` of the padded corpus
    ``Dd`` on its device, rows in block order."""
    ij = np.stack([blocks, (blocks - s) % B]).astype(np.int32)
    bq = bn
    if Dd.device.type == "cuda" and bn > _K4_MAX_Q:  # two query blocks of 128 per tile
        f, bq = bn // _K4_MAX_Q, _K4_MAX_Q
        ij = np.stack([(ij[0][:, None] * f + np.arange(f)).ravel(),
                       np.repeat(ij[1], f)]).astype(np.int32)
    fv, fi, fc = rect_tile_candidates_kernel(
        Dd, Dd, torch.from_numpy(ij), threshold, k, block_q=bq, block_c=bn,
        nc_valid=n, col_live=col_live, qpos=qpos,
    )
    rows = len(blocks) * bn
    fi = fi.reshape(rows, k)
    return Matches(values=torch.where(fi >= 0, fv.reshape(rows, k), NEG_INF),
                   indices=fi, counts=fc.reshape(rows))


class ResumableSweep:
    """Checkpointed APSS self-join over a fixed dense corpus.

    ::

        sweep = ResumableSweep(D, threshold=0.35, k=16, directory=ckpt_dir)
        matches = sweep.run()            # may raise SweepKilled under faults
        ...
        matches = ResumableSweep(D, threshold=0.35, k=16,
                                 directory=ckpt_dir, mesh=smaller).run()
        # ^ resumes from the cursor, bit-identical to the uninterrupted run

    ``D`` is a numpy array. The directory holds keep-last-k step
    directories (the step number is the sweep cursor) and
    ``sweep_meta.json`` pinning (n, m, k, threshold, block size, corpus
    digest): resuming a different problem raises ``ValueError``. Restore
    uses ``fallback=True``: a corrupt newest checkpoint costs one
    checkpoint window, not the job.

    ``device`` (default ``"cuda"``, which raises without a card) is where
    the corpus and partials live; with a ``mesh`` each rank uses
    ``launch.mesh.rank_device(device, rank)``. Every rank of the mesh
    constructs and runs the sweep; a rank outside ``mesh`` takes no part
    (``run()`` returns ``None`` there).
    """

    def __init__(
        self,
        D,
        *,
        threshold: float,
        k: int = 16,
        block_rows: int = 128,
        directory: str,
        mesh=None,
        axis_name: str = "data",
        keep: int = 3,
        checkpoint_every: int = 1,
        fault_plan=None,
        timer=None,
        device: str | torch.device = "cuda",
    ):
        bn = int(block_rows)
        if bn < 1 or bn & (bn - 1):
            raise ValueError(f"block_rows must be a power of two: {bn}")
        dev = device_of(device)
        if dev.type == "cuda" and bn not in _K4_BLOCKS:
            raise ValueError(
                f"block_rows must be one of {_K4_BLOCKS} on the card (K4's corpus "
                f"blocks): {bn}"
            )
        self._setup(np.ascontiguousarray(D, dtype=np.float32), threshold=threshold, k=k,
                    bn=bn, directory=directory, mesh=mesh, axis_name=axis_name, keep=keep,
                    checkpoint_every=checkpoint_every, fault_plan=fault_plan, timer=timer,
                    device=dev)

    def _setup(self, D: np.ndarray, *, threshold, k, bn, directory, mesh, axis_name, keep,
               checkpoint_every, fault_plan, timer, device, digest=None, Dd=None):
        self._D = D  # the caller's rows, never copied on the host
        self.n, self.m = D.shape
        self.threshold = float(threshold)
        self.k = int(k)
        self.bn = bn
        self.n_pad = -(-self.n // bn) * bn
        self.B = self.n_pad // bn
        self.directory = directory
        self.mesh = mesh
        self.axis_name = axis_name
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.fault_plan = fault_plan
        self.timer = timer
        self.resumed_from: int | None = None
        self._device = device
        self._digest = digest
        self.member = mesh is None or mesh.get_coordinate() is not None
        self.manager = CheckpointManager(directory, keep=keep)
        if not self.member:
            return
        if mesh is None:
            self.rank, self.p, self.device = 0, 1, device
        else:
            import torch.distributed as dist

            from repro_torch.launch.mesh import rank_device

            self.rank = mesh.get_local_rank(axis_name)
            self.p = mesh.size(list(mesh.mesh_dim_names).index(axis_name))
            self.device = rank_device(str(device), dist.get_rank())
        self.sharded = self.p > 1 and self.B % self.p == 0
        if self.sharded:
            per = self.B // self.p
            self.blocks = np.arange(self.rank * per, (self.rank + 1) * per)
        else:
            self.blocks = np.arange(self.B)
        self._write_or_check_meta()
        if Dd is None or Dd.device != self.device:
            wide = -(-self.m // _TK) * _TK  # K4's feature stage; zero columns add nothing
            Dd = torch.zeros((self.n_pad, wide), dtype=torch.float32, device=self.device)
            for a in range(0, self.n, _COPY_ROWS):  # in pieces: D may be memory-mapped
                b = min(a + _COPY_ROWS, self.n)
                Dd[a:b, :self.m] = torch.from_numpy(np.array(D[a:b]))
        self._Dd = Dd
        ids = torch.arange(self.n_pad, dtype=torch.int32, device=self.device)
        self._col_live = ids < self.n
        self._qpos = torch.where(self._col_live, ids, -1)

    # -- meta --------------------------------------------------------------

    def _meta(self) -> dict:
        if self._digest is None:  # over the row-padded f32 array, as the reference hashes it
            h = hashlib.blake2b(digest_size=16)
            h.update(self._D)
            h.update(bytes(4 * self.m * (self.n_pad - self.n)))
            self._digest = h.hexdigest()
        return {
            "n": self.n, "m": self.m, "k": self.k,
            "threshold": self.threshold, "block_rows": self.bn,
            "digest": self._digest,
        }

    def _write_or_check_meta(self) -> None:
        """Rank 0 writes the meta if the directory has none; after a barrier
        every rank checks it, so that every rank raises on a mismatch."""
        path = os.path.join(self.directory, _META)
        meta = self._meta()
        if self.rank == 0 and not os.path.exists(path):
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, path)
            self._barrier()
            return
        self._barrier()
        with open(path) as f:
            on_disk = json.load(f)
        if on_disk != meta:
            diff = {key for key in meta if on_disk.get(key) != meta[key]}
            raise ValueError(
                f"sweep meta mismatch in {self.directory}: {sorted(diff)} "
                f"differ — refusing to resume a different problem"
            )

    # -- placement and the mesh's collectives -------------------------------

    def _group(self):
        return self.mesh.get_group(self.axis_name)

    def _barrier(self) -> None:
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier(group=self._group())

    def _match_specs(self) -> dict:
        """Specs of the partials (row-sharded with the blocks, else
        replicated: the same spec family at every scale)."""
        ax = self.axis_name if self.sharded else None
        return {"values": (ax, None), "indices": (ax, None), "counts": (ax,)}

    def _place_partials(self, host: dict) -> Matches:
        if self.mesh is not None:
            from repro_torch.distributed.elastic import reshard_tree

            host = {key: x.to_local() for key, x in
                    reshard_tree(host, self._match_specs(), self.mesh).items()}
        return Matches(**{key: torch.as_tensor(host[key]).to(self.device)
                          for key in ("values", "indices", "counts")})

    def _fresh_host(self) -> dict:
        return {
            "values": np.full((self.n_pad, self.k), -np.inf, np.float32),
            "indices": np.full((self.n_pad, self.k), -1, np.int32),
            "counts": np.zeros((self.n_pad,), np.int32),
        }

    def _gathered(self, state: Matches, *, everywhere: bool) -> dict | None:
        """The full partials as host arrays: on rank 0 (every rank with
        ``everywhere``) of a sharded mesh, else this rank's own; ``None`` on
        the ranks that receive nothing."""
        local = {key: getattr(state, key).cpu().numpy()
                 for key in ("values", "indices", "counts")}
        if not self.sharded:
            return local
        import torch.distributed as dist

        group = self._group()
        parts = [None] * self.p
        if everywhere:
            dist.all_gather_object(parts, local, group=group)
        else:
            dist.gather_object(local, parts if self.rank == 0 else None,
                               dst=dist.get_global_rank(group, 0), group=group)
            if self.rank != 0:
                return None
        return {key: np.concatenate([part[key] for part in parts]) for key in local}

    def _share_step_times(self) -> None:
        """Every rank's step times since the last boundary into every
        rank's ``StepTimer`` (its own are already there)."""
        if self.timer is None or self.mesh is None:
            return
        import torch.distributed as dist

        mine, self._pending = self._pending, []
        every = [None] * self.p
        dist.all_gather_object(every, (self.rank, mine), group=self._group())
        for rank, times in every:
            if rank != self.rank:
                for dt in times:
                    self.timer.record(rank, dt)

    # -- the sweep ---------------------------------------------------------

    def run(self, *, resume: bool = True) -> Optional[Matches]:
        """Run (or resume) the sweep to completion; returns global Matches
        on this rank's device (``None`` on a rank outside the mesh).

        Under an armed kill fault this raises ``SweepKilled`` part-way —
        every completed checkpoint boundary is already durable, so a fresh
        ``ResumableSweep`` over the same directory (any mesh) continues.
        """
        if not self.member:
            return None
        start = 0
        host = None
        if resume:
            host, step = self.manager.restore(like=self._fresh_host(), fallback=True)
            if host is not None:
                start = int(step)
                self.resumed_from = start
                telemetry.incr("sweep.resumed_steps", start)
        if host is None:
            host = self._fresh_host()
        state = self._place_partials(host)
        del host
        self._barrier()  # every rank has read the directory before rank 0 writes to it
        self._pending: list[float] = []
        plan = self.fault_plan
        kw = dict(B=self.B, bn=self.bn, n=self.n, threshold=self.threshold, k=self.k,
                  col_live=self._col_live, qpos=self._qpos)

        for s in range(start, self.B):
            with trace.span("sweep/step", i=s):
                if plan is not None:
                    plan.kill_point(s)
                if self.timer is not None:
                    self.timer.start()
                if plan is not None:
                    plan.delay("sweep", step=s, rank=self.rank if self.mesh is not None else None)
                state = merge_matches(state, sweep_step(self._Dd, self.blocks, s, **kw))
                _sync(self.device)
                if self.timer is not None:
                    self._pending.append(self.timer.stop(rank=self.rank))
                if plan is not None and plan.armed("corrupt", "sweep.caravan"):
                    state = state._replace(values=torch.from_numpy(
                        plan.corrupt_array(state.values.cpu().numpy(), step=s)
                    ).to(self.device))
                if (s + 1) % self.checkpoint_every == 0 or s + 1 == self.B:
                    full = self._gathered(state, everywhere=False)
                    if self.rank == 0:
                        self.manager.save(full, step=s + 1)
                    self._barrier()
                    self._share_step_times()
                    telemetry.incr("sweep.checkpoints")

        if self.sharded:
            state = Matches(**{key: torch.from_numpy(x).to(self.device) for key, x in
                               self._gathered(state, everywhere=True).items()})
        return Matches(values=state.values[: self.n], indices=state.indices[: self.n],
                       counts=state.counts[: self.n])

    def resume_on(self, new_mesh) -> "ResumableSweep":
        """A sweep over the same directory and problem placed on ``new_mesh``
        (``None``: one process), the elastic recovery path after rank loss or
        straggler eviction. Every rank of the old mesh calls it; a rank
        outside ``new_mesh`` gets a sweep that takes no part."""
        out = ResumableSweep.__new__(ResumableSweep)
        out._setup(
            self._D, threshold=self.threshold, k=self.k, bn=self.bn,
            directory=self.directory, mesh=new_mesh, axis_name=self.axis_name,
            keep=self.manager.keep, checkpoint_every=self.checkpoint_every,
            fault_plan=self.fault_plan, timer=self.timer, device=self._device,
            digest=self._digest, Dd=getattr(self, "_Dd", None),
        )
        return out


def mesh_after_eviction(mesh, report, *, axis_name: str = "data"):
    """Shrink a mesh by dropping evicted ranks (``StragglerReport.evict``,
    places in the mesh).

    Losing ranks costs parallelism, never correctness: the survivors form a
    1-D ``DeviceMesh`` named ``axis_name`` and the resumed sweep's partials
    are placed on it (or replicated when the block count stops dividing).
    Returns ``mesh`` itself when nothing is evicted, and raises
    ``ValueError`` when every rank is. Every rank of the process group
    calls it (creating the survivors' group is collective); every rank
    takes the verdict of the mesh's rank 0, so that all build one mesh.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    box = [list(report.evict)]
    dist.broadcast_object_list(box, src=int(mesh.mesh.reshape(-1)[0]))
    evict = box[0]
    if not evict:
        return mesh
    ranks = mesh.mesh.reshape(-1).tolist()
    bad = set(evict)
    keep = [r for i, r in enumerate(ranks) if i not in bad]
    if not keep:
        raise ValueError("straggler report evicts every rank — cannot shrink")
    return DeviceMesh(mesh.device_type, torch.tensor(keep), mesh_dim_names=(axis_name,))
