"""Query batches against a prebuilt index: one caller, one batch in flight.

Traffic keys: ``batch`` (queries a batch), ``pool_batches`` (distinct
batches, made in set-up and cycled through in order), ``rows`` (a batch's
corpus rows, ``contiguous`` or ``scattered``: ``apssbench.gen.query_pool``)
and ``noise`` (the jitter of a query's nonzeros). The corpus is densified on the device and
handed over as an ``(n, m)`` float32 tensor. Set-up is one
``repro_torch.serving.index.build_index`` of the whole corpus (timed on the
host clock to a ``synchronize()``: ``index_build_s``); each step is one
``query_topk(index, Q, t, k, use_kernel=True)`` whose ``Matches`` are copied
to the host, the end of the step. The check judges every row of every
batch of the window: ``value_gap`` and ``rows_wrong`` of
``apssbench.reference``.
"""

from __future__ import annotations

import time

import torch

from apssbench.gen import densify, query_pool
from apssbench.reference import control_matches, judge, query_scores


class Driver:
    def __init__(self, run):
        self.run = run
        self.outs = []

    def prepare(self) -> None:
        run, tr = self.run, self.run.traffic
        self.pool = run.pool = query_pool(run.csr, tr["pool_batches"], tr["batch"], tr["noise"],
                                          run.gen, tr["rows"])
        self.corpus = densify(run.csr)

    def setup(self) -> None:
        from repro_torch.serving.index import build_index, index_nbytes

        run, tr = self.run, self.run.traffic
        t0 = time.perf_counter()
        self.index = build_index(self.corpus, device=run.device)
        run.sync()
        run.counters["index_build_s"] = time.perf_counter() - t0
        run.counters["index_bytes"] = index_nbytes(self.index)
        del self.corpus
        # The dense batches are made once the index stands, so that the
        # corpus handed over is freed first.
        self.Q = densify(self.pool).view(tr["pool_batches"], tr["batch"], run.csr.m)

    def _query(self, b: int):
        from repro_torch.serving.query import query_topk

        cfg = self.run.config
        with torch.profiler.record_function("apssbench.query"):
            m = query_topk(self.index, self.Q[b], cfg["t"], cfg["k"],
                           use_kernel=True)
            return m.values.cpu(), m.indices.cpu(), m.counts.cpu()

    def warm(self) -> None:
        for b in range(self.Q.shape[0]):  # every batch's shapes, as the window sees them
            self._query(b)

    def step(self, i: int) -> tuple[int, int]:
        b = i % self.Q.shape[0]
        self.outs.append(self._query(b))
        return self.Q.shape[1], b

    def free(self) -> None:
        del self.index, self.Q

    def control(self) -> None:
        """Put the control's answers (``reference.control_matches``) in
        place of the window's batches, one for each pool batch."""
        csr, pool, cfg = self.run.csr, self.pool, self.run.config
        B = self.run.traffic["batch"]
        self.outs = [control_matches(pool.indices[b * B:(b + 1) * B], pool.values[b * B:(b + 1) * B],
                                     csr.indices, csr.values, csr.m, t=cfg["t"], k=cfg["k"],
                                     exclude_self=False)
                     for b in range(pool.n // B)]
        self.run.step_keys = list(range(len(self.outs)))

    def judge(self, limits: dict):
        """``({"value_gap": ..., "rows_wrong": ...}, failed batches)`` over
        every query of every batch, at the margin ``limits["value_gap"]``."""
        run, cfg = self.run, self.run.config
        mu = float(limits["value_gap"])
        csr, pool = run.csr, self.pool
        S = query_scores(pool.indices, pool.values, csr.indices, csr.values, csr.m)
        B = run.traffic["batch"]
        keys = torch.tensor(run.step_keys, dtype=torch.int64)
        rows = (keys[:, None] * B + torch.arange(B)[None, :]).reshape(-1)
        v, i, c = (torch.cat(x) for x in zip(*self.outs))
        verdict = judge(v, i, c, S, rows, t=cfg["t"], k=cfg["k"], mu=mu)
        N = len(self.outs)
        bad = verdict.row_wrong.view(N, B).any(1) | (verdict.row_gap.view(N, B).amax(1) > mu)
        return {"value_gap": verdict.value_gap, "rows_wrong": verdict.rows_wrong}, int(bad.sum())
