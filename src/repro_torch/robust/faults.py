"""Deterministic fault injection for APSS sweeps, serving and the live index.

The paper's schedules are fully synchronous: one lost or slow rank stalls an
entire n²-scale sweep. To *test* the recovery machinery (resumable sweeps,
checkpoint fallback, serving degradation) we need faults that are

- **deterministic** — a seeded :class:`FaultPlan` fires the same faults at
  the same points on every run, so a recovery test is reproducible and a
  chaos-bench lane is comparable across commits;
- **injected at seams, not monkeypatched** — production code calls the
  plan's hook methods (:meth:`FaultPlan.kill_point`, :meth:`FaultPlan.delay`,
  :meth:`FaultPlan.fail_point`, :meth:`FaultPlan.corrupt_array`) which are
  all no-ops when no matching fault is armed, so the instrumented paths ARE
  the tested paths.

Fault kinds and what real-world failure each models:

- ``kill`` — the process dies between checkpoint steps (preemption, OOM
  kill, a dropped rank taking down the SPMD sweep). Raises
  :class:`SweepKilled`; recovery = resume from the last checkpoint, on the
  same mesh or — for a genuinely lost rank — a smaller one
  (:func:`repro_torch.robust.sweep.mesh_after_eviction`).
- ``delay`` — a slow shard / straggling rank: sleeps ``seconds`` at the
  matching step. Drives straggler detection and serving-deadline tests.
- ``error`` — a transient failure of one execution tier (e.g. the CUDA
  kernel tier): raises :class:`InjectedFault` for the first ``times``
  matching calls, then stops. Drives retry-with-backoff and the serving
  degradation ladder.
- ``corrupt`` — bit-rot in flight or at rest: :meth:`corrupt_array`
  perturbs a traveling packet (e.g. a Matches caravan) deterministically;
  :meth:`corrupt_file` flips a byte of a checkpoint leaf on disk to
  exercise ``CheckpointCorruptionError`` + fallback.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from repro_torch.obs import recorder as _recorder


class InjectedFault(RuntimeError):
    """A planned fault fired — raised only by fault-injection hooks."""


class SweepKilled(InjectedFault):
    """The sweep 'process' died between checkpoint steps (kill fault)."""


@dataclasses.dataclass
class Fault:
    """One armed fault. ``step``/``rank`` of None match any step/rank;
    ``times`` bounds firings (<= 0 means unlimited)."""

    kind: str                 # "kill" | "delay" | "error" | "corrupt"
    scope: str = "sweep"      # seam name, e.g. "serving.kernel", "sweep.caravan"
    step: int | None = None
    rank: int | None = None
    seconds: float = 0.0      # delay duration
    times: int = 1


class FaultPlan:
    """A seeded, consumable set of faults; all hooks no-op when nothing arms.

    ``fired`` counts firings per ``"kind:scope"`` key so tests can assert a
    fault actually triggered (a recovery test that never faulted proves
    nothing).
    """

    def __init__(self, faults=(), *, seed: int = 0):
        self.faults: list[Fault] = list(faults)
        self.seed = int(seed)
        self.fired: collections.Counter = collections.Counter()
        self._remaining = [f.times for f in self.faults]

    # -- matching ----------------------------------------------------------

    def _take(self, kind: str, scope: str, step=None, rank=None) -> Fault | None:
        for i, f in enumerate(self.faults):
            if f.kind != kind or f.scope != scope:
                continue
            if f.step is not None and f.step != step:
                continue
            if f.rank is not None and rank is not None and f.rank != rank:
                continue
            if self._remaining[i] == 0:
                continue
            if self._remaining[i] > 0:
                self._remaining[i] -= 1
            self.fired[f"{kind}:{scope}"] += 1
            # Flight-recorder seam: a firing fault is exactly the moment a
            # postmortem wants the recent-event buffer frozen.
            if _recorder.enabled():
                _recorder.trigger(
                    f"fault:{kind}:{scope}", step=step, rank=rank,
                )
            return f
        return None

    # -- hooks (called from production seams) ------------------------------

    def kill_point(self, step: int, scope: str = "sweep") -> None:
        """Die here if a kill fault matches (models preemption mid-sweep)."""
        if self._take("kill", scope, step=step) is not None:
            raise SweepKilled(f"injected kill at {scope} step {step}")

    def delay(self, scope: str, step=None, rank=None) -> float:
        """Sleep out a matching delay fault; returns seconds slept."""
        f = self._take("delay", scope, step=step, rank=rank)
        if f is None:
            return 0.0
        time.sleep(f.seconds)
        return f.seconds

    def fail_point(self, scope: str, step=None) -> None:
        """Raise a transient :class:`InjectedFault` if an error fault matches."""
        f = self._take("error", scope, step=step)
        if f is not None:
            raise InjectedFault(f"injected transient error in {scope}")

    def corrupt_array(self, x, step=None, scope: str = "sweep.caravan"):
        """Deterministically perturb one element of a traveling packet.

        Returns ``x`` untouched when no corrupt fault matches; otherwise a
        numpy copy with a single element overwritten — seeded from
        ``(plan.seed, step)`` so the damage is identical across runs.
        """
        f = self._take("corrupt", scope, step=step)
        if f is None:
            return x
        out = np.array(x)
        rng = np.random.default_rng((self.seed, 0 if step is None else int(step)))
        flat = out.reshape(-1)
        i = int(rng.integers(flat.size))
        if np.issubdtype(out.dtype, np.floating):
            flat[i] = np.float64(rng.uniform(2.0, 4.0))  # out-of-range cosine
        else:
            flat[i] = flat[i] ^ np.asarray(0x5A5A, dtype=out.dtype)
        return out

    def corrupt_file(self, path: str) -> int:
        """Flip one mid-file byte in place (bit-rot at rest); returns offset.

        Always fires — disk corruption is injected by tests directly, not
        gated on an armed fault — but the flipped offset is seed-stable.
        """
        rng = np.random.default_rng(self.seed)
        with open(path, "r+b") as f:
            f.seek(0, 2)
            size = f.tell()
            # Stay clear of the .npy header so the file still *parses* and
            # corruption must be caught by the digest, not a parse error.
            lo = min(size - 1, 128)
            off = int(rng.integers(lo, size))
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
        return off

    # -- convenience -------------------------------------------------------

    def armed(self, kind: str, scope: str) -> bool:
        """True iff a matching fault could still fire (cheap pre-check so
        hot paths skip host round-trips when nothing is armed)."""
        return any(
            f.kind == kind and f.scope == scope and r != 0
            for f, r in zip(self.faults, self._remaining)
        )

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    @classmethod
    def chaos(
        cls,
        seed: int,
        *,
        steps: int,
        delay_prob: float = 0.3,
        max_delay: float = 0.003,
        kernel_errors: int = 1,
        kill: bool = False,
        scope: str = "sweep",
        error_scope: str = "serving.kernel",
    ) -> "FaultPlan":
        """A random-but-seeded plan for the chaos bench lane / ``--chaos``.

        Sprinkles sub-millisecond shard delays across the steps of ``scope``
        (``"sweep"`` or ``"serving"``), arms ``kernel_errors`` transient
        scoring-tier failures at ``error_scope``, and (with ``kill=True``)
        one mid-sweep kill at a seeded step — everything derived from
        ``seed`` only.
        """
        rng = np.random.default_rng(seed)
        faults: list[Fault] = []
        for s in range(steps):
            if rng.random() < delay_prob:
                faults.append(
                    Fault("delay", scope=scope, step=s,
                          seconds=float(rng.uniform(0.0, max_delay)))
                )
        if kernel_errors:
            faults.append(
                Fault("error", scope=error_scope, times=kernel_errors)
            )
        if kill and steps > 1:
            faults.append(
                Fault("kill", scope="sweep", step=int(rng.integers(1, steps)))
            )
        return cls(faults, seed=seed)
