"""Self-joins back to back: one caller, one join in flight.

The corpus is densified on the device and handed over as an ``(n, m)``
float32 tensor. Each step is one ``repro_torch.apss_blocked(corpus, t, k,
use_kernel=True)`` that ends in a ``synchronize()``; its ``Matches`` are
then copied to the host, so that what the window keeps for the check, every
row of every join, holds no card memory. The check's numbers
(``judge``): ``value_gap`` and ``rows_wrong`` of ``apssbench.reference``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apssbench.gen import densify
from apssbench.reference import control_matches, judge, join_scores


class Answer(NamedTuple):
    values: torch.Tensor
    indices: torch.Tensor
    counts: torch.Tensor


class Driver:
    def __init__(self, run):
        self.run = run
        self.outs = []

    def prepare(self) -> None:
        self.corpus = densify(self.run.csr)

    def _join(self):
        from repro_torch import apss_blocked

        cfg = self.run.config
        with torch.profiler.record_function("apssbench.join"):
            out = apss_blocked(self.corpus, cfg["t"], cfg["k"],
                               use_kernel=True, device=self.run.device)
            self.run.sync()
        return out

    def setup(self) -> None:
        self._join()  # the port's set-up: kernel libraries loaded, buffers cached

    def warm(self) -> None:
        self._join()

    def step(self, i: int) -> tuple[int, int]:
        self.outs.append(Answer(*(x.cpu() for x in self._join())))
        return 1, 0

    def free(self) -> None:
        del self.corpus

    def control(self) -> None:
        """Put the control's answer (``reference.control_matches``) in place
        of the window's joins, as one join."""
        csr, cfg = self.run.csr, self.run.config
        self.outs = [Answer(*control_matches(csr.indices, csr.values, csr.indices, csr.values,
                                             csr.m, t=cfg["t"], k=cfg["k"], exclude_self=True))]
        self.run.step_keys = [0]

    def judge(self, limits: dict):
        """``({"value_gap": ..., "rows_wrong": ...}, failed joins)`` over
        every row of every join, at the margin ``limits["value_gap"]``."""
        csr, cfg = self.run.csr, self.run.config
        mu = float(limits["value_gap"])
        S = join_scores(csr.indices, csr.values, csr.m)
        J, n = len(self.outs), csr.n
        v = torch.cat([o.values for o in self.outs])
        i = torch.cat([o.indices for o in self.outs])
        c = torch.cat([o.counts for o in self.outs])
        rows = torch.arange(n, device=S.device).repeat(J)
        verdict = judge(v, i, c, S, rows, t=cfg["t"], k=cfg["k"], mu=mu)
        bad = verdict.row_wrong.view(J, n).any(1) | (verdict.row_gap.view(J, n).amax(1) > mu)
        return {"value_gap": verdict.value_gap, "rows_wrong": verdict.rows_wrong}, int(bad.sum())
