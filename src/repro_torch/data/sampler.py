"""Neighbor sampling for mini-batch GNN training (GraphSAGE-style fanout).

``minibatch_lg`` (232k nodes / 114M edges / fanout 15-10) cannot train
full-batch; this sampler draws a fixed-fanout k-hop subgraph around the seed
nodes and emits *statically shaped* padded arrays (a batch's shape depends
only on the seed count and the fanouts). A numpy copy of the reference's
``data/sampler.py``: the same draws, array for array.

Output layout matches the GAT batch dict: local node ids are
``[seeds | hop-1 samples | hop-2 samples]`` with edges pointing sample →
parent (message flows toward the seeds). Padding edges carry mask 0.
"""

from __future__ import annotations

import numpy as np


def neighbor_sample(
    indptr: np.ndarray,       # CSR (n+1,)
    indices: np.ndarray,      # CSR (nnz,)
    seeds: np.ndarray,        # (B,) seed node ids
    fanouts: tuple,           # e.g. (15, 10)
    features: np.ndarray,     # (n, F) global features
    labels: np.ndarray,       # (n,)
    *,
    seed: int = 0,
) -> dict:
    rng = np.random.default_rng(seed)
    B = len(seeds)

    layers = [seeds.astype(np.int64)]
    edge_src_l, edge_dst_l, edge_mask_l = [], [], []

    # Local index bookkeeping: node k of layer L sits at offset(L) + k.
    offsets = [0]
    total = B
    frontier = seeds.astype(np.int64)
    for hop, fanout in enumerate(fanouts):
        n_par = len(frontier)
        samples = np.empty((n_par, fanout), np.int64)
        mask = np.zeros((n_par, fanout), np.float32)
        for i, node in enumerate(frontier):
            lo, hi = int(indptr[node]), int(indptr[node + 1])
            deg = hi - lo
            if deg == 0:
                samples[i] = node  # self-fallback, masked out
                continue
            take = rng.integers(lo, hi, size=fanout)
            samples[i] = indices[take]
            mask[i] = 1.0
        flat = samples.reshape(-1)
        layers.append(flat)
        offsets.append(total)
        # edges: sampled child (this layer) → parent (previous layer)
        child_local = total + np.arange(len(flat))
        parent_local = offsets[hop] + np.repeat(np.arange(n_par), fanout)
        edge_src_l.append(child_local)
        edge_dst_l.append(parent_local)
        edge_mask_l.append(mask.reshape(-1))
        total += len(flat)
        frontier = flat

    all_nodes = np.concatenate(layers)
    # self-loops so every node sees itself
    loops = np.arange(total, dtype=np.int64)
    edge_src = np.concatenate(edge_src_l + [loops]).astype(np.int32)
    edge_dst = np.concatenate(edge_dst_l + [loops]).astype(np.int32)
    edge_mask = np.concatenate(edge_mask_l + [np.ones(total, np.float32)])

    label_mask = np.zeros(total, np.float32)
    label_mask[:B] = 1.0
    return {
        "features": features[all_nodes].astype(np.float32),
        "edge_src": edge_src,
        "edge_dst": edge_dst,
        "edge_mask": edge_mask.astype(np.float32),
        "labels": labels[all_nodes].astype(np.int32),
        "label_mask": label_mask,
        "node_ids": all_nodes.astype(np.int64),
    }


def sampled_shape(batch: int, fanouts: tuple) -> tuple[int, int]:
    """Static (n_nodes, n_edges) of a sampled batch (excl. nothing)."""
    total, frontier, edges = batch, batch, 0
    for f in fanouts:
        frontier = frontier * f
        total += frontier
        edges += frontier
    edges += total  # self loops
    return total, edges
