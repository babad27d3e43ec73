"""Deterministic, resumable, shardable batch pipelines.

Every pipeline is a pure function of ``(seed, step)`` — resuming from a
checkpoint at step ``s`` regenerates exactly the batch stream from ``s``
with no iterator state to persist (the checkpoint only stores the step).
Batches are produced as host numpy; the trainer (``launch/train.py``)
moves them to the model's device. A numpy copy of the reference's
``data/pipeline.py``: the same ``SeedSequence`` streams, so every batch
equals the reference's array for array.

Real deployments swap the synthesis for file readers behind the same
``get_batch(step)`` contract; determinism-by-construction (counter-based
RNG) is the production property this module demonstrates.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _rng(seed: int, step: int, stream: int = 0) -> np.random.Generator:
    # Counter-based: an independent stream per (seed, step, stream) triple.
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, stream))
    )


@dataclasses.dataclass
class LMDataPipeline:
    vocab_size: int
    batch_size: int          # GLOBAL batch
    seq_len: int
    seed: int = 0

    def get_batch(self, step: int) -> dict:
        rng = _rng(self.seed, step)
        tokens = rng.integers(
            0, self.vocab_size, size=(self.batch_size, self.seq_len),
            dtype=np.int32,
        )
        return {"tokens": tokens}


@dataclasses.dataclass
class RecsysPipeline:
    n_items: int
    batch_size: int
    history_len: int = 50
    n_user_fields: int = 8
    user_vocab: int = 1_000_000
    seed: int = 0
    kind: str = "two-tower"   # "two-tower" | "seq" | "ctr"

    def get_batch(self, step: int) -> dict:
        rng = _rng(self.seed, step)
        b = self.batch_size
        hist = rng.integers(
            -1, self.n_items, size=(b, self.history_len), dtype=np.int32
        )
        items = rng.integers(0, self.n_items, size=(b,), dtype=np.int32)
        if self.kind == "two-tower":
            return {
                "user_fields": rng.integers(
                    0, self.user_vocab, size=(b, self.n_user_fields), dtype=np.int32
                ),
                "history": hist,
                "item_ids": items,
            }
        if self.kind == "seq":  # bert4rec masked cloze
            ids = rng.integers(
                0, self.n_items, size=(b, self.history_len), dtype=np.int32
            )
            mask = rng.random((b, self.history_len)) < 0.15
            labels = ids.copy()
            masked = ids.copy()
            masked[mask] = self.n_items  # [MASK] token row
            return {"item_ids": masked, "labels": labels, "mask": mask}
        if self.kind == "ctr":  # din / bst
            return {
                "history": hist,
                "item_ids": items,
                "click": rng.integers(0, 2, size=(b,), dtype=np.int32),
            }
        raise ValueError(self.kind)


@dataclasses.dataclass
class GraphPipeline:
    """Synthetic graphs with power-law degree (GNN shapes, incl. sampled)."""

    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 7
    seed: int = 0

    def full_graph(self) -> dict:
        rng = _rng(self.seed, 0)
        # Power-law-ish degree: preferential attachment approximation.
        src = rng.zipf(1.3, size=self.n_edges) % self.n_nodes
        dst = rng.integers(0, self.n_nodes, size=self.n_edges)
        feats = rng.standard_normal((self.n_nodes, self.d_feat)).astype(np.float32)
        labels = rng.integers(0, self.n_classes, size=(self.n_nodes,), dtype=np.int32)
        return {
            "features": feats,
            "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32),
            "edge_mask": np.ones(self.n_edges, np.float32),
            "labels": labels,
            "label_mask": (rng.random(self.n_nodes) < 0.1).astype(np.float32),
        }

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """CSR adjacency (indptr, indices) for the neighbor sampler."""
        g = self.full_graph()
        order = np.argsort(g["edge_src"], kind="stable")
        dst = g["edge_dst"][order]
        counts = np.bincount(g["edge_src"], minlength=self.n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return indptr, dst

    def batched_small_graphs(
        self, batch: int, nodes: int, edges: int, step: int
    ) -> dict:
        """`molecule` shape: a batch of small graphs, block-diagonal packed."""
        rng = _rng(self.seed, step, stream=2)
        N, E = batch * nodes, batch * edges
        offs = np.repeat(np.arange(batch) * nodes, edges)
        src = rng.integers(0, nodes, size=E) + offs
        dst = rng.integers(0, nodes, size=E) + offs
        return {
            "features": rng.standard_normal((N, self.d_feat)).astype(np.float32),
            "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32),
            "edge_mask": np.ones(E, np.float32),
            "labels": rng.integers(0, self.n_classes, size=(N,), dtype=np.int32),
            "label_mask": np.ones(N, np.float32),
        }
