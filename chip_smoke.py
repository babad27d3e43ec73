#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing one JSON line (with ``t_s``, seconds since the start):

1. ``device``: fails unless CUDA is available; the card's name and the
   ``nvidia-smi`` name and power limit.
2. ``build``: compiles every kernel source (one ``nvcc`` per source, all
   started together) into ``build/repro_torch/``; build seconds, each
   kernel's registers, shared memory and spills from ``-Xptxas -v``, and
   the tensor-core instructions in K8's and K7's SASS (``cuobjdump -sass``):
   it fails if either library holds no ``HGMMA``, or if K1, K3, K4, K6, K7
   or K9 spill registers.
3. ``edge_probes``: n=130 m=100; t=-0.1 with padded zero columns; k > n;
   bf16 input; an all-pruned mask (t=1.5), through both dense kernel
   paths, against the port's oracle on the card.
4. ``sparse_edge_probes``: the sparse path (``apss_blocked`` on a
   ``SparseCorpus``, K3) on n=130 m=100 via ``from_dense``, t=-0.1 with
   padded rows, k > n, duplicate coordinates concentrated in one dimension
   across two blocks, and t=1.5 (all pruned); K7 with an explicit mask
   holding dead tiles, whose output must be zeros.
5. ``serving_edge_probes`` (not timed): ``query_topk`` on a dense and a
   sparse index of n=130 m=100, B=5 queries at block_q=8 through K4, K5
   and K6: t=0.35; t=-0.1 against padded corpus rows; k > n; t=1.5 (empty);
   an all-zero query; and the tie probe of the strict early-exit test (a
   tile whose bound equals every row's k-th value must be scored), against
   the rectangular oracle ``extract_matches(Q·Cᵀ, t, k, exclude_self=False)``.
   Then ``f1_probe``: a bf16 dense index (4096 × 2560) scores 64 f32
   queries unrounded through K4's and K5's f32 × bf16 entries: counts equal
   to the plain path's and to the float64 count on the bf16 corpus in every
   row clear of t.
6. ``clustered_65k``: ``clustered_corpus(65536, 768, 8)``, t=0.5, k=32: the
   pruning-friendly regime (most tiles provably dead), K1 and K2.
7. ``radikal_full``: the paper's radikal dataset at full scale
   (n=6883, m=136447, 155.8 nnz/row), t=0.2, k=32: nearly every tile live,
   the unpruned worst case with a 267-chunk feature loop, K1 and K2.
8. ``k7_radikal_full``: ``apss_block_matmul`` (K7) with the auto mask on the
   same corpus, held against ``apss_block_plain`` element by element, and
   K7 on the corpus's first 1,024 rows against the float64 product (f32:
   within 2e-6).
9. ``serve_radikal_full``: a dense index (K4 at B=64 and B=8, K5) and a
   sparse index (K6) of the same corpus, 64 ``perturbed_queries``, t=0.2,
   k=32, held against the plain path on the card and the oracle. Then
   ``serve_sharded_radikal_full``: the corpus as a dense index in 4
   row-block shards (``devices``, all on the one card), rows padded to
   7,168, so the last block is all padding and pruned: the same 64
   queries launch K4 once per shard with live tiles (7/7/7/6), at global
   ids, and the result must equal phase 9's unsharded K4 result bit for
   bit and agree with the oracle and the sharded plain path; a
   ``RetrievalServer(use_kernel=True)`` on the shards answers the 64
   queries with no retry or degradation, each equal to the one-shot call;
   the corpus in 4 CSR shards runs the plain gather-dot path against the
   oracle and refuses ``use_kernel`` and ``early_exit``. The wall (median
   of 5), one call under ``torch.profiler`` (host ops, device busy time,
   idle share), each shard's K4 time and their sum, build seconds and
   bytes of both sharded indexes.
    Then ``planner_auto`` (``planner_auto_phase``): the execution planner
    calibrated on the card (the profile printed beside the card's name and
    power limit), ``plan_apss`` on ``radikal_full`` (dense input) and
    ``clustered_65k`` with the card's kernel candidates: the ranking, the
    best candidate of each (kind, representation, kernel) timed through
    the planner's ``execute`` (K1 and K3 launch in their candidates),
    predicted against measured, whether the choice lands within 2x of the
    best measured (printed, not gated); ``plan.run()`` held to the phase's
    plain result, with its telemetry records (live fraction, modeled
    FLOPs, FLOPs per measured second), under an ``obs.Tracer`` whose drift
    residuals feed phase 14b; ``query_topk(plan="auto")`` on
    phase 9's dense index at B = 64 and 8 and on its CSR index: the
    kernel chosen, K4 or K6 launched, the fixed K4 or K6 result equalled.
    Then ``audit_radikal_full`` (``audit_phase``): the model-vs-program
    audit (``obs.audit.run_audit``) on the same corpus, t = 0.2, k = 32:
    the blocked families (dense, CSR) on their plain paths and, beside
    them, the kernel candidates (K1, K3), the serving families at B = 64
    (K4 on a dense index, K6 on a CSR one) and the live index's delta join
    (K4's masked entry), each run once under the op census
    (``launch.op_analysis``): per family the FLOP, link and HBM ratios
    (model against census) and the census's kernel work. A warmed
    ``query_topk`` (K4) under ``obs.compile.assert_no_retrace`` builds and
    loads nothing, and its K4 launch's census FLOPs equal ``rect_work``'s.
10. ``sparse_radikal_full``: the same corpus in CSR (``from_dense``) through
    ``apss_blocked(sp, use_kernel=True)`` (K3), held against the plain
    sparse path and against phase 7's K2 result (counts exactly equal: both
    sum the same nonzero products in the same order).
11. ``sparse_clustered_65k``: ``sparse_clustered_corpus(65536, 8192, 16,
    n_clusters=32)``, t=0.5, k=32 (the serving benchmark's corpus), K3.
12. ``serve_sparse_clustered_65k``: the same corpus as a serving index
    (``benchmarks/bench_serve.py``'s corpus and traffic): ``query_topk`` at
    B = 1, 8 and 64 through K6, sparse early exit, and the step and
    continuous servers at max_batch 8 and 64 (192 closed-loop requests, no
    cache): QPS and host-clock p50/p99 of submit → ``result()``; every
    request "ok", no degradation or retry, each equal to its one-shot call.
13. ``serve_early_exit_overlap``: ``bench_serve.measure_early_exit``'s
    corpus (8192 × 2048, overlap_dims=8), t=0.01, k=8, B=64: densified
    through K5 and sparse through the plain scan with K6 tiles; both skip
    tiles and equal their full scans; scored tiles of the kernel and of the
    plain scan side by side. Then ``live_corpus``, the live index
    (``serving.MutableAPSSIndex``) on the card in three parts, each op
    (setup, append, delete, queries, compact, reopen, rebuild) run on its
    own with the launch counts set to 0 before it, its host-clock wall and
    the time of its ``checkpoint/save`` spans (WAL entry and snapshot)
    under an ``obs.Tracer``: ``live_clustered_65k``
    (``clustered_corpus(65536, 768, 8)``, t=0.5, k=32, block_rows 128, a
    WAL under ``build/live/``; four rounds of an append of 256 rows of
    seed 1, a delete of 128 random live ids and 64 queries through a
    ``RetrievalServer(use_kernel=True)``, whose LRU must miss after each
    mutation and hit within a version and whose K4 lane must equal the
    index's masked-K4 lane; then compact, a reopen from the WAL and a
    fresh rebuild), ``live_radikal_full`` (phase 7's corpus as the first
    append, one delta join over every live tile, block_rows 256, no WAL;
    two appends of 64 perturbed rows, two deletes of 32, 64 queries through
    ``query(use_kernel=True)`` equal to the masked-K4 lane and the oracle;
    a fresh rebuild) and ``live_sparse_clustered_65k``
    (``sparse_clustered_corpus(65536, 8192, 16)``, t=0.5, its ELL width
    pinned at the corpus's, 36 (the generator's rows hold up to 36
    nonzeros, so 16 would not fit); two rounds of an append of 256 and a
    delete of 128 on the plain slot-order scorer, a fresh rebuild;
    ``query(use_kernel=True)`` must raise). Each mutated graph must equal
    its rebuild's bit for bit (and the reopened one the one before) and
    agree with the port's oracle on the survivors; the masked K4 must
    launch in the dense parts, and the masked calls of one delta join
    (forward and reverse, captured with their inputs) are held to the
    plain version and timed for the ``kernels`` line. Cut to fit: the
    sparse part runs two rounds, not four.
14. ``distributed_radikal_full``: the paper's 1-D and 2-D distributions
    (``core.distributed.apss``) in 4 ranks on the one card over gloo
    (``launch.mesh.spawn``; NCCL takes no two ranks on one card), on the
    radikal corpus of phase 7 padded with zeros to 7,168 × 136,448 (kept
    on the host since phase 7; written once to ``build/distributed/``,
    each rank reads its shard memory-mapped): horizontal allgather, ring
    and halfring on a (4,) ``data`` mesh and hierarchical on (2, 2) (pod,
    data), dense through K1 at each step's runtime offsets; vertical
    allreduce, scatter, compressed and recursive on (4,) ``model``; 2-D
    allreduce and compressed on (2, 2); the same on the corpus's CSR form
    (gather-dot, no kernel), and ``distribution="auto"`` on the CSR form
    (``calibrate(mesh)`` in the ranks, then ``plan_apss`` on each rank:
    one config chosen on all ranks, each rank's record's ppermute bytes
    equal to the bytes it sent). Compressed and recursive run at the
    candidate capacity that truncates no row (computed from the partial
    scores on the card). Per variant: the wall (median of 2 runs, rank
    0's host clock between barriers and synchronizes), each rank's
    device time in the first run (under ``torch.profiler``) with its
    memcpy and K1 parts, each rank's time inside the collective helpers
    (median of the 2 runs), the bytes each
    rank sent (equal to the schedule's count, or the phase fails), K1's
    launches on each rank (each K1 variant launches it on every rank);
    rows below 6,883 equal phase 7's plain result and its K1 result by
    the comparison rule below, padded rows empty, no row overflowed. Then K1 alone at a ring step's shape (rank 2's 1,792
    rows against rank 1's, offsets 3,584 and 1,792) against its plain
    version, for the ``kernels`` line. Each variant's first run runs under
    an ``obs.Tracer`` in the ranks too: rank 0's drift residuals against
    ``planner_auto``'s profile (as ``plan.run()``'s there) feed phase 14b.
    After the variants the same ranks run the 4-rank audit (``AUDIT_RANKS``:
    ``synthetic_corpus`` n = m = 512, t = 0.2, k = 32, meshes (4,) and
    (2, 2), rank 0 also serving and the live index): the gated families
    within 1.5x of the model, the ring's link ratio within 0.5-2.
14b. ``sweep_radikal_full`` (``sweep_phase``): the resumable sweep
    (``robust.ResumableSweep``, block_rows 128, checkpoints under
    ``build/sweep/``) on phase 7's corpus, t=0.2, k=32: 54 steps, each one
    launch of K4's masked entry over 54 tiles of 128 × 128. (a) The
    uninterrupted sweep: 54 launches, against phase 7's plain and K1
    results, K4's CUDA-event ms per step (median, min, max), the wall and
    the ``checkpoint/save`` spans. (b) Killed at step 27 and resumed by a
    new sweep over the directory (``resumed_from`` 27). (c) A copy of the
    killed directory with its newest step's leaf corrupted: the restore
    warns and falls back to step 26. (d) 4 ranks on the card over gloo
    (``launch.sweep.run_ranks``; 54 % 4 ≠ 0, so every rank scores every
    block), a 0.2 s delay fault on rank 1 at every step and a kill at step
    27: the gathered ledger evicts rank 1 on every rank and 3 survivors
    resume with 18 blocks each. (b)-(d) must equal (a) bit for bit. (e)
    ``obs.drift.drift_report`` of phase 9's and 14's traced runs against
    the calibrated profile, per variant (printed, not gated). (f)
    ``launch/serve.py --mode retrieval --chaos --trace-out --metrics-out``
    in this process: the injected kernel-tier errors fire, every answer
    equals one-shot ``query_topk``, the trace holds ``serving/query``
    spans and the metrics ``serving.live_tile_fraction``. K4 at step 27's
    shape against its plain version and one ``torch.bmm`` of the same
    tiles (partners gathered beforehand) with a stable-sort top-k, for
    the ``kernels`` line.
14c. ``dedup_radikal_full`` (``dedup_phase``): ``data.dedup_corpus`` (K1,
    one launch) on phase 7's corpus plus 512 planted rows, copies of random
    rows with each nonzero scaled by 1 + 0.01 · U[0, 1), at t = 0.95, k =
    64, against ``use_kernel=False``: ``keep`` and ``duplicate_of`` equal,
    every planted row dropped for a kept row; K1 at the join's shapes
    against its plain version.
14d. ``apss_paper_20news`` (``apss_paper_phase``): the paper's cells
    (``configs.apss_paper``) in 4 ranks on the card over gloo
    (``launch.apss_mesh.run_cells``): ``v_compressed`` at the full 20news
    scale (20,480 × 315,392 f32, 25.8 GB in four 6.45 GB column slices;
    the corpus from ``data.sparse.sparse_zipfian_bulk`` at
    ``PAPER_DATASETS["20-newsgroups"]``' n, m and nnz per row, zero-padded,
    handed over in CSR, each rank densifying its own slice on the card;
    256 near-duplicate rows planted after the generated 20,001), then
    ``h_allgather``, ``h_ring`` and ``grid_2d`` at wikipedia's m =
    1,351,680 with n cut to 1,024 (5.5 GB; 64 rows planted near duplicates).
    Each result equals, under the comparison rule, a single-device
    ``apss_blocked`` on the card run after the ranks exit (the plain path,
    as the cells pass no ``use_kernel``: no kernel runs in this phase). The
    four full configs (wikipedia 388 GB) are built on the meta device and
    their argument shapes, specs and ``static_info`` printed.
15. ``lm_edge_probes`` (not timed): K8 (flash attention, through
    ``kernels.flash_attention.flash_attention``) and K9 (flash-decode
    partials) against their plain versions, in f32 and bf16: S = 1, S not a
    multiple of the tile, q heads per kv head of 1, 2 and 8, head dims 16,
    64 and 128, non-causal at a divisible S, and the non-causal
    ``ValueError``; cache lengths 0, 1 and L with L not a multiple of a tile.
    Then ``r1_probe`` (ROADMAP R1): K8 and K9 in bf16 with V from 4 · (1 +
    |N(0, 1)|), every output ≥ 4, against their plain versions and the f32
    references: largest |Δ|, in bf16 ulps too; K8 within 2 ulps, K9 within
    a relative 1e-5.
16. ``lm_prefill_qwen3_1_7b``: the full qwen3-1.7b config in bf16, weights
    from ``torch.Generator`` seed 0 on the card, tokens (2, 4096) from numpy
    seed 0. ``prefill`` (K8 in every layer) against ``use_kernel=False``;
    ``transformer_logits`` on both paths over all 8,192 positions (largest
    |Δlogit|, top-1 agreement), in bf16 and with the same weights in f32:
    top-1 agreement ≥ 99 % in f32, and in bf16 the kernel path no farther
    from the f32 model's top-1 than the plain path (within 1 % of the
    positions). The top-2 margins of this random-weight model are often
    below bf16's rounding noise, so each bf16 path parts from the f32 model
    at a few percent of the positions and bf16 agreement is printed, not
    held to 99 %. K8 at one layer's shapes against its plain version in
    bf16 and f32.
17. ``lm_decode_qwen3_1_7b_32k``: the same model and a seeded random KV
    cache of 8 sequences × 32,768 positions (30.1 GB), lengths from numpy
    seed 0 in [1, 32767] with one at 32767: ``decode_step`` (K9 in every
    layer, lengths restored between repeats, the update being in place)
    against the plain path (largest |Δlogit|, top-1 agreement); K9 at one
    layer's shapes against its plain version.
18. ``lm_server_qwen3_1_7b``: the port's ``LMServer`` (max_batch 8, max_len
    512) on the same model, 4 requests of a 16-token prompt (numpy seed 1)
    and 32 generated tokens: tokens/s, ms per step, K9 launches (28 per
    step). Its token streams must equal the plain path's server; where they
    part, the plain path's top-2 logit margin at that step must be at most
    phase 17's largest |Δlogit|.
18b. The MLA and MoE families and qwen3-8b at full width (bf16, weights
    from seed 0 on the card), one model on the card at a time
    (``lm_zoo_phases``). Each prefill (2 × 4096; ``zoo_prefill_phase``) is
    counted (K8 once a layer: 62 for minicpm3-4b, through its padded call,
    28 for deepseek-moe-16b, 36 for qwen3-8b), printed against
    ``use_kernel=False`` in bf16 (each MoE layer's ``dropped_frac`` on both
    paths, and one MoE layer's ``moe_ffn`` timed alone at the prefill's
    8,192 tokens: its share of the wall; the profiler's K8 records held
    equal to the counted launches), and held against it at ``CUT_LAYERS``
    layers of the same widths in f32: ``transformer_logits`` top-1 equal on
    all but 2 of the 8,192 positions with |Δlogit| ≤ 1e-4, on 99 % for an
    MoE model (a router near-tie may flip on an f32 last bit); K8 at one
    layer's shapes against its plain version (for MLA, q and k of width 96
    and v of 64 zero-padded to 128 and scaled by 1/√96; the bound counts
    the unpadded work).
    ``lm_decode_minicpm3_4b_32k``: the absorbed latent decode (plain torch,
    no kernel by design: none may launch) over a seeded random latent cache
    of 8 × 32,768 positions (9.4 GB); then decode fed step by step from an
    empty cache against ``transformer_logits`` (padded K8) over the same 32
    tokens, printed at full depth in bf16 and held at ``CUT_LAYERS`` layers
    in f32 (atol 5e-4, rtol 5e-3, top-1 equal everywhere).
    ``lm_decode_deepseek_moe_16b_8k``: phase 17 on deepseek-moe-16b with
    its cache cut to 8 × 8,192 positions (15 GB beside 32.8 GB of weights;
    32k would take 60 GB), K9 28 times a step, an MoE step routing the 8
    tokens of the batch (capacity 1). ``lm_server_deepseek_moe_16b`` and
    ``lm_server_qwen3_8b``: phase 18 with 2 requests of an 8-token prompt
    and 16 generated tokens; qwen3-8b's tie bound is one K9 decode step's
    largest |Δlogit| against the plain path over a random 512-position
    cache (``decode_dlogit``).
19. ``kernels``: per kernel and main-path shape, launches on the main path,
    median kernel / plain / library time from CUDA events, the bound (f32
    FMA peak; K7's row and K8's bf16 row the tensor-core peak), and the largest
    value difference from the plain version, and ``nvidia-smi``'s SM clock,
    its maximum, power draw and temperature just before and after the
    kernel's timed runs (``clocks``; one such line also comes before the
    first and after the last timed row); K1's rows add its grid (row tiles
    × segments) and segment count, K3's its work items and grid (scoring
    items, selection blocks), K7's its tensor-core passes, output tile, the
    f32 FMA bound beside the tensor-core one (``bound_ms_fma``) and the
    float64 slice error, K4's and K6's their work items, grid,
    passes and scratch bytes (K6's also its support width ``support_S``),
    K5's its cooperative grid (``grid_blocks``) and feature chunks, the
    masked K4's its calls (query rows, blocks, tiles and passes of the
    forward and the reverse join), K9's its
    split, ``n_splits``, grid and live split blocks (``live_blocks``), K8's
    the f32 kernel's time (``ms_f32``) beside SDPA's in f32
    (``library_ms_f32``). K1's ring-step row (phase 14) adds its shape,
    offsets and launches per rank and variant (its ``launches`` sums them),
    and its segments, grid, merge grid and co-resident ``slots`` as the
    radikal row does; the dedup row (phase 14c) the same and its live tiles.
    K4's sharded row (``serve_sharded_radikal_full/b64``) times the 4
    shards' launches together and adds each shard's time and tiles.

The main-path phases (6-14d and 16-18b) drive the port's entry points
(``apss_blocked(use_kernel=True)`` for K1, ``apss_fused_compacted`` for K2,
``apss_block_matmul`` for K7, ``apss_blocked(sp, use_kernel=True)`` for K3,
``query_topk(use_kernel=True)`` and the servers for K4, K5 and K6, on a
sharded index too for K4; ``MutableAPSSIndex`` for K4's masked entry;
``prefill`` for K8, ``decode_step`` and ``LMServer`` for K9; ``apss`` in
4 ranks for K1 under the ring schedules; ``ResumableSweep.run`` for K4's
masked entry once per step; ``dedup_corpus`` for K1) with the
launch counts set to 0 just before and read just after, each serving path
(batch size, early exit, server) on its own, and hold the
results against the plain paths on the card. Comparison rule (the
kernels, cuBLAS and the CPU add in different orders): pairs with
|s - t| > 1e-5 agree exactly in membership, count and order by (value
desc, id asc); values agree to 1e-5; pairs within 1e-5 of t may differ, and
the number of such pairs is printed. Two entries whose values differ by at
most 1e-5 may trade places (a near tie). K7's matrix: values agree to 1e-5
and the zero pattern is equal wherever |s - t| > 1e-5. Early exit is held
to more: values and ids identical to the full scan through the same
kernels, counts equal to ``min(count, k)``.

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
TOL = 1e-5
REPS = 5
PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 without tensor cores (TF32 off)
PEAK_BF16_TC_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores, dense
PEAK_TF32_TC_FLOPS = 495e12  # H100 SXM, tf32 on the tensor cores, dense
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
KERNEL_INFO = {
    "apss_fused": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/apss_fused.cu",
        replaces="src/repro/kernels/apss_block/fused.py:316",
    ),
    "apss_tile_candidates": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/tile_candidates.cu",
        header="src/repro_torch/kernels/apss_block/csrc/tile_items.cuh",
        replaces="src/repro/kernels/apss_block/fused.py:739",
    ),
    "sparse_tile_candidates": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/sparse_tile_candidates.cu",
        header="src/repro_torch/kernels/apss_block/csrc/tile_items.cuh",
        replaces="src/repro/kernels/apss_block/sparse.py:198",
    ),
    "apss_block": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/apss_block.cu",
        replaces="src/repro/kernels/apss_block/apss_block.py:98",
    ),
    "rect_tile_candidates": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/rect_tile_candidates.cu",
        replaces="src/repro/kernels/apss_block/fused.py:501",
    ),
    "rect_tile_candidates_masked": dict(  # K4's masked entry: the live index's delta joins
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/rect_tile_candidates.cu",
        header="src/repro_torch/kernels/apss_block/csrc/rect_tiles.cuh",
        replaces="src/repro/kernels/apss_block/fused.py:501",
    ),
    "rect_tile_candidates_ee": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/rect_tile_candidates_ee.cu",
        replaces="src/repro/kernels/apss_block/fused.py:666",
    ),
    "rect_sparse_tile_candidates": dict(
        route="cuda",
        source="src/repro_torch/kernels/apss_block/csrc/rect_sparse_tile_candidates.cu",
        replaces="src/repro/kernels/apss_block/sparse.py:296",
    ),
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:111",
    ),
    "decode_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:102",
    ),
}
LM_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}  # K8/K9 against their plain versions
NO_SPILL = ("apss_fused", "tile_candidates", "sparse_tile_candidates", "apss_block",
            "rect_tile_candidates", "rect_sparse_tile_candidates",
            "decode_attention")  # libraries whose spills fail the build
TENSOR_CORE_KERNELS = ("flash_attention", "apss_block")  # the build fails without HGMMA


class PhaseFailed(Exception):
    pass


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, seconds since the script started, ``fields``."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T_START, **fields}),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch  # noqa: F401  (fails when run outside a checkout)

    smi = smi_name_power()
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit("device", kind=kind, nvidia_smi=smi, capability=list(cap),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    check(cap == (9, 0), f"kernels are built for sm_90a; card is sm_{cap[0]}{cap[1]}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    mma = {name: sass_mma_counts(libs[name]) for name in TENSOR_CORE_KERNELS}
    ptxas = {name: _build.ptxas_report(name) for name in _build.sources()}
    emit("build", seconds=build_s, sass_mma=mma, ptxas=ptxas)
    for name, counts in mma.items():
        check(counts is None or counts["HGMMA"] > 0,
              f"{name}'s library holds no warpgroup MMA (HGMMA) in its SASS: {counts}")
    for name in NO_SPILL:
        spilled = [r for r in ptxas[name] if r.get("spill_stores") or r.get("spill_loads")]
        check(not spilled, f"{name} spills registers: {spilled}")

    from repro_torch.core.sparse import from_dense
    from repro_torch.data.sparse import sparse_clustered_corpus
    from repro_torch.data.synthetic import clustered_corpus, synthetic_corpus

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    edge_probes(np, torch)
    sparse_edge_probes(np, torch)
    serving_edge_probes(np, torch)
    f1_probe(np, torch)
    emit("clocks_before_timed_rows", nvidia_smi=clocks(), query=CLOCK_QUERY)
    D, gen_s = generated(torch, lambda: torch.from_numpy(
        clustered_corpus(65536, 768, 8, n_clusters=32, seed=0)).cuda())
    rows, clustered = main_path_phase(np, torch, "clustered_65k", D, gen_s, threshold=0.5,
                                      k=32)
    clustered = dict(D=D, sp=None, single=clustered, threshold=0.5)  # for planner_auto
    del D
    radikal, gen_s = generated(torch, lambda: synthetic_corpus(
        6883, 136447, 1072472 / 6883, seed=0))  # kept on the host for the distributed phase
    D = torch.from_numpy(radikal).cuda()
    more, dense = main_path_phase(np, torch, "radikal_full", D, gen_s, threshold=0.2, k=32)
    single = dict(ref=dense["ref"], k1=dense["k1"], near=dense["near"])
    rows += more
    rows.append(k7_phase(np, torch, "k7_radikal_full", D, threshold=0.2))
    sp, conv_s = generated(torch, lambda: from_dense(D))
    more, served = serve_radikal_phase(np, torch, "serve_radikal_full", D, sp, threshold=0.2,
                                       k=32)
    rows += more
    rows += serve_sharded_phase(np, torch, "serve_sharded_radikal_full", D, sp, served,
                                threshold=0.2, k=32)
    residuals = []  # drift's: the planner's planned runs, the distributed phase's apss calls
    profile = planner_auto_phase(np, torch, "planner_auto", {
        "radikal_full": dict(D=D, sp=sp, single=single, threshold=0.2),
        "clustered_65k": clustered}, served, residuals, k=32)
    audit_phase(np, torch, "audit_radikal_full", radikal, D, sp, threshold=0.2, k=32)
    del D, served, clustered
    torch.cuda.empty_cache()
    rows.append(sparse_phase(np, torch, "sparse_radikal_full", sp, conv_s,
                             threshold=0.2, k=32, dense=dense))
    del sp, dense
    sp, gen_s = generated(torch, lambda: sparse_clustered_corpus(
        65536, 8192, 16.0, n_clusters=32, seed=0))
    rows.append(sparse_phase(np, torch, "sparse_clustered_65k", sp, gen_s,
                             threshold=0.5, k=32))
    rows.append(serve_clustered_phase(np, torch, "serve_sparse_clustered_65k", sp,
                                      threshold=0.5, k=32))
    del sp
    torch.cuda.empty_cache()
    rows.append(serve_early_exit_phase(np, torch, "serve_early_exit_overlap"))
    torch.cuda.empty_cache()
    rows += live_corpus_phase(np, torch, radikal)
    rows.append(distributed_phase(np, torch, "distributed_radikal_full", radikal, single,
                                  residuals, profile, threshold=0.2, k=32, n_pad=7168,
                                  m_pad=136448))
    rows.append(sweep_phase(np, torch, "sweep_radikal_full", radikal, single, residuals,
                            profile, threshold=0.2, k=32))
    rows.append(dedup_phase(np, torch, "dedup_radikal_full", radikal))
    del radikal, single
    torch.cuda.empty_cache()
    apss_paper_phase(np, torch, "apss_paper_20news")
    lm_edge_probes(np, torch)
    r1_probe(np, torch)
    cfg, model = lm_model(torch)
    rows.append(lm_prefill_phase(np, torch, "lm_prefill_qwen3_1_7b", cfg, model))
    row, max_dlogit = lm_decode_phase(np, torch, "lm_decode_qwen3_1_7b_32k", cfg, model)
    rows.append(row)
    lm_server_phase(np, torch, "lm_server_qwen3_1_7b", cfg, model, max_dlogit)
    del model
    torch.cuda.empty_cache()
    rows += lm_zoo_phases(np, torch)
    emit("clocks_after_timed_rows", nvidia_smi=clocks(), query=CLOCK_QUERY)
    emit("kernels", kernels=rows)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def sass_mma_counts(lib: Path) -> dict | None:
    """Tensor-core instructions in a built library's SASS: warpgroup MMA
    (``HGMMA``) and warp MMA (``HMMA``), by ``cuobjdump -sass`` from the
    toolkit beside ``nvcc``; ``None`` where the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    ops = []  # the opcode of each instruction line "/*addr*/ [@pred] OP.mods ... ;"
    for line in sass.splitlines():
        words = [w for w in line.split("*/", 1)[-1].split() if not w.startswith("@")]
        if words:
            ops.append(words[0].split(".")[0])
    return {op: ops.count(op) for op in ("HGMMA", "HMMA")}


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def near_threshold_counts(torch, D, t: float, rows: int = 512):
    """Per row of ``D``, the pairs (no self-pair) with |s - t| <= TOL."""
    from repro_torch.core.precision import dot_f32

    n = D.shape[0]
    out = []
    for b in range(0, n, rows):
        s = dot_f32(D[b:b + rows], D)
        near = (s - t).abs() <= TOL
        r = torch.arange(b, min(b + rows, n), device=D.device)
        near[r - b, r] = False
        out.append(near.sum(dim=1))
    return torch.cat(out).cpu().numpy()


def compare(np, got, ref, t: float, near) -> dict:
    """Hold ``got`` against ``ref`` (each ``(values, indices, counts)`` numpy,
    ``-inf``/``-1`` empties) under the comparison rule of the module."""
    with np.errstate(invalid="ignore"):
        return _compare(np, got, ref, t, near)


def _compare(np, got, ref, t, near) -> dict:
    gv, gi, gc = got
    rv, ri, rc = ref
    k = gv.shape[1]
    count_bad = int((np.abs(gc.astype(np.int64) - rc) > near).sum())

    def far_first(v, i):
        far = (i >= 0) & (np.abs(v - t) > TOL)
        order = np.argsort(~far, axis=1, kind="stable")
        return (np.take_along_axis(v, order, 1), np.take_along_axis(i, order, 1),
                far.sum(axis=1))

    gv2, gi2, ng = far_first(gv, gi)
    rv2, ri2, nr = far_first(rv, ri)
    common = np.arange(k)[None, :] < np.minimum(ng, nr)[:, None]
    diff = np.where(common, np.abs(gv2 - rv2), 0.0)
    same_id = common & (gi2 == ri2)
    swapped = common & (gi2 != ri2)
    order_bad = int((swapped & (diff > TOL)).sum())
    longer = (np.arange(k)[None, :] >= np.minimum(ng, nr)[:, None]) & (
        np.arange(k)[None, :] < np.maximum(ng, nr)[:, None]
    )
    tail_v = np.where(ng[:, None] > nr[:, None], gv2, rv2)
    length_bad = int((longer & (np.abs(tail_v - t) > 2 * TOL)).sum())
    max_err = float(np.where(same_id, diff, 0.0).max()) if gv.size else 0.0
    return dict(
        count_mismatch_rows=count_bad,
        order_mismatches=order_bad,
        length_mismatches=length_bad,
        near_tie_swaps=int(swapped.sum() - order_bad),
        near_threshold_pairs=int(near.sum()),
        max_abs_err=max_err,
        ok=count_bad == 0 and order_bad == 0 and length_bad == 0 and max_err <= TOL,
    )


def as_rows(np, values, indices, counts):
    """Kernel outputs (any leading shape, ``NEG_LARGE`` empties) as host
    ``(values (rows, k), indices, counts (rows,))`` with ``-inf`` empties."""
    v = values.reshape(-1, values.shape[-1]).cpu().numpy()
    i = indices.reshape(-1, indices.shape[-1]).cpu().numpy()
    c = counts.reshape(-1).cpu().numpy()
    return np.where(i >= 0, v, -np.inf).astype(np.float32), i, c


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def time_ms(np, torch, fn) -> float:
    """Median of REPS timed calls (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def timed(torch, fn):
    """``(fn(), host-clock ms)`` of one call that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def wall_ms(np, torch, fn, reps: int = REPS) -> dict:
    """Median, min and max host-clock ms of ``reps`` more calls of one path."""
    times = [timed(torch, fn)[1] for _ in range(reps)]
    return dict(median=float(np.median(times)), min=min(times), max=max(times))


# Device-record name of each kernel that ``profiled`` counts.
PROFILED_KERNELS = {"flash_attention": "fa::flash_forward", "decode_attention": "da::decode_partials"}
# Throwaway launches (``torch.cuda._sleep``'s kernel) at the head of every
# profiled window. On an H100, kineto drops the first device records of a
# trace as out of its window, more of them as the process ages: late in the
# smoke a few dozen, and with them now and then deepseek-moe-16b's first K8
# or K9. The lead takes that loss; the count of its records that survive
# says how large the loss was.
PROFILE_LEAD_LAUNCHES = 1024
PROFILE_LEAD = "chip_smoke.profile_lead"  # the lead's host scope
LEAD_KERNEL = "spin_kernel"


def _profile_stats(torch, prof, wall_ms: float, top: int, kernels: dict) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in prof.events() if e.device_type != cuda]
    lead_end = max((e.time_range.end for e in host if e.name == PROFILE_LEAD), default=None)
    host_ops = sum(1 for e in host if e.cpu_parent is None and e.name != PROFILE_LEAD
                   and (lead_end is None or e.time_range.start >= lead_end))
    events = [e for e in prof.key_averages()  # kernels, memcpys and memsets, not the ops
              if e.device_type == cuda and e.self_device_time_total > 0]
    lead = dict(launches=PROFILE_LEAD_LAUNCHES,
                records=sum(e.count for e in events if LEAD_KERNEL in e.key))
    # the lead's kernels, and the device-side span kineto draws for its scope
    events = [e for e in events if LEAD_KERNEL not in e.key and e.key != PROFILE_LEAD]
    records = {name: sum(e.count for e in events if key in e.key)
               for name, key in kernels.items()}
    if not events:  # the profiler saw no device time: not measured
        return dict(host_ops=host_ops, device_busy_ms=None, idle_share=None, records=records,
                    lead=lead, top=[])
    busy = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    return dict(host_ops=host_ops, device_launches=sum(e.count for e in events),
                device_busy_ms=busy, idle_share=1 - busy / wall_ms, records=records,
                lead=lead,
                top=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3, count=e.count)
                     for e in events[:top]])


def profiled(torch, fn, wall_ms: float, top: int = 6, attempts: int = 3,
             kernels: dict = PROFILED_KERNELS) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the number of top-level
    host ops, the device launches and their summed device time (the
    device's busy time, kernels not overlapping), the idle share against
    ``wall_ms`` (the path's unprofiled host-clock time: the profiler slows
    the host), the ``top`` kernels by device time, and per kernel of
    ``kernels`` (launch-count name: a key of its device records) its device
    records beside the launches counted around the call. The window opens
    with ``PROFILE_LEAD_LAUNCHES`` throwaway launches, left out of every
    figure but ``lead`` (its launches and surviving records). A trace whose
    records still differ from the counted launches is taken again, up to
    ``attempts`` calls. ``device_busy_ms`` is ``None`` where the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    lost = []
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = launches_now()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(PROFILE_LEAD):
                for _ in range(PROFILE_LEAD_LAUNCHES):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
        after = launches_now()
        launched = {name: after[name] - before[name] for name in kernels}
        stats = _profile_stats(torch, prof, wall_ms, top, kernels)
        if stats["device_busy_ms"] is None or stats["records"] == launched:
            break
        lost.append(dict(records=stats["records"], device_launches=stats["device_launches"],
                         lead=stats["lead"]))
    return dict(stats, wall_ms=wall_ms, profiled_wall_ms=profiled_ms, launches=launched,
                attempts=attempt, lost_records=lost)


def check_profile(phase: str, profile: dict) -> None:
    """The profiler's device records of the port's kernels equal their launch
    counts (where it saw device time)."""
    if profile["device_busy_ms"] is not None:
        check(profile["records"] == profile["launches"],
              f"{phase}: the profile holds {profile['records']} kernel records for "
              f"{profile['launches']} counted launches")


def bound(flop: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flop / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def library_topk(torch, D, t: float, k: int, rows: int = 512):
    """Yardstick: f32 ``torch.matmul`` in 512-row blocks plus a stable top-k
    (no tile masks, no self-exclusion). The port never calls it."""
    out = []
    for b in range(0, D.shape[0], rows):
        s = torch.matmul(D[b:b + rows], D.T)
        cnt = (s >= t).sum(dim=1)
        s = torch.where(s >= t, s, float("-inf"))
        v, i = torch.sort(s, dim=1, descending=True, stable=True)
        out.append((v[:, :k], i[:, :k], cnt))
    return out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def edge_probes(np, torch) -> None:
    from repro_torch import (
        apss_blocked,
        apss_fused,
        apss_fused_compacted,
        apss_reference,
    )
    from repro_torch.core.precision import dot_f32
    from repro_torch.interop import matches_to_numpy

    def corpus(n, m, seed, density=0.3):
        rng = np.random.default_rng(seed)
        D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
        D *= rng.random((n, m)) < density
        D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(D).cuda()

    probes = {
        "n130_m100": (corpus(130, 100, 1), 0.35, 16),
        "negative_t_padded": (corpus(130, 100, 2), -0.1, 16),
        "k_gt_n": (corpus(100, 64, 3), 0.2, 160),
        "bf16": (corpus(300, 200, 4).bfloat16(), 0.3, 16),
        "all_pruned_t1.5": (corpus(200, 96, 5), 1.5, 16),
    }
    results = {}
    for name, (D, t, k) in probes.items():
        ref = apss_reference(D, t, k)
        S = dot_f32(D, D)
        S.fill_diagonal_(float("nan"))
        near = ((S - t).abs() <= TOL).sum(dim=1).cpu().numpy()
        r = {}
        for path, fn in (
            ("apss_blocked_kernel", lambda: apss_blocked(D, t, k, use_kernel=True)),
            ("apss_fused_compacted", lambda: apss_fused_compacted(D, t, k)),
        ):
            got = fn()
            torch.cuda.synchronize()
            r[path] = compare(np, matches_to_numpy(got), matches_to_numpy(ref), t, near)
            check(r[path]["ok"], f"edge probe {name} via {path}: {r[path]}")
        if t > 1.0:
            check(int(ref.counts.sum()) == 0, "t=1.5 oracle has matches")
        results[name] = dict(matches=int(ref.counts.sum()), **{
            p: {key: v for key, v in c.items() if key != "ok"} for p, c in r.items()})
    # An explicitly dead mask yields nothing even though every score passes t=0.
    D = corpus(256, 96, 6)
    got = apss_fused(D, D, 0.0, 16, block_mask=torch.zeros((1, 1), dtype=torch.int32))
    check(int(got.counts.sum()) == 0 and bool((got.indices == -1).all()),
          "explicit all-zero mask produced matches")
    results["explicit_zero_mask"] = dict(matches=0)
    results.update(k2_probes(np, torch, corpus))
    emit("edge_probes", probes=results)


def k2_probes(np, torch, corpus) -> dict:
    """K2 against its plain version at tile shapes and widths the entry
    points do not reach: non-square tiles, 64-row tiles, one ring stage (m =
    32), m = 96, and a worklist of diagonal tiles only."""
    from repro_torch.kernels.apss_block import fused

    t, n, results = 0.3, 300, {}
    for bm, bn, m, diagonal in ((256, 128, 224, False), (128, 256, 224, False),
                                (64, 64, 32, False), (128, 128, 96, False),
                                (128, 128, 224, True)):
        Dp = torch.nn.functional.pad(corpus(n, m, 7), (0, 0, 0, 512 - n))
        if diagonal:
            pairs = [(i, i) for i in range(512 // bm)]
        else:
            pairs = [(i, j) for i in range(512 // bm) for j in range(512 // bn)]
        ij = torch.tensor(pairs, dtype=torch.int32).T.contiguous().cuda()
        near = np.concatenate([near_threshold_counts(torch, Dp[:n], t), np.zeros(512 - n, int)])
        wl = ij.cpu().numpy().astype(np.int64)
        kw = dict(block_m=bm, block_n=bn, n_valid=n)
        pk = fused.apss_tile_candidates_kernel(Dp, ij, t, 16, **kw)
        pp = fused.apss_tile_candidates_plain(Dp, ij, t, 16, **kw)
        r = {}
        for part, a, b, blocks, bs in (("forward", pk[:3], pp[:3], wl[0], bm),
                                       ("mirror", pk[3:], pp[3:], wl[1], bn)):
            rows = (blocks[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
            c = compare(np, as_rows(np, *a), as_rows(np, *b), t, near[rows])
            check(c["ok"], f"K2 probe {bm}x{bn} m={m} diagonal={diagonal} {part}: {c}")
            r[part] = {key: v for key, v in c.items() if key != "ok"}
        check(int(pp[2].sum()) > 0, f"K2 probe {bm}x{bn} m={m}: no candidates")
        check(not diagonal or int(pk[5].sum()) == 0, "K2 probe: a diagonal mirror packet")
        results[f"k2_{bm}x{bn}_m{m}{'_diagonal' if diagonal else ''}"] = r
    return results


def sparse_edge_probes(np, torch) -> None:
    from repro_torch import apss_block_matmul, apss_blocked, apss_reference
    from repro_torch.core.precision import dot_f32
    from repro_torch.core.sparse import SparseCorpus, from_dense, to_dense
    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block.apss_block import apss_block_plain
    from repro_torch.kernels.apss_block.sparse import apss_sparse_compacted

    def corpus(n, m, seed, density=0.3):
        rng = np.random.default_rng(seed)
        D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
        D *= rng.random((n, m)) < density
        D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(D).cuda()

    # Two 64-row blocks; row 0 stores dim 3 as two 0.5 slots (effective 1.0),
    # row 64 holds dim 3 at 1.0: a per-slot bound would prune their tile.
    idx = torch.zeros((128, 2), dtype=torch.int32)
    val = torch.zeros((128, 2))
    idx[0], val[0] = torch.tensor([3, 3]), torch.tensor([0.5, 0.5])
    idx[64], val[64] = torch.tensor([3, 0]), torch.tensor([1.0, 0.0])
    nnz = torch.zeros(128, dtype=torch.int32)
    nnz[0], nnz[64] = 2, 1
    dup = SparseCorpus(idx, val, nnz, 8).to("cuda")

    probes = {
        "n130_m100": (from_dense(corpus(130, 100, 1)), 0.35, 16, None),
        "negative_t_padded": (from_dense(corpus(130, 100, 2)), -0.1, 16, None),
        "k_gt_n": (from_dense(corpus(100, 64, 3)), 0.2, 160, None),
        "duplicate_concentration": (dup, 0.8, 4, 64),
        "all_pruned_t1.5": (from_dense(corpus(200, 96, 5)), 1.5, 16, None),
    }
    results = {}
    for name, (sp, t, k, block) in probes.items():
        D = to_dense(sp)
        ref = apss_reference(D, t, k)
        S = dot_f32(D, D)
        S.fill_diagonal_(float("nan"))
        near = ((S - t).abs() <= TOL).sum(dim=1).cpu().numpy()
        reset_launches()
        if block is None:
            got = apss_blocked(sp, t, k, use_kernel=True)
        else:
            got = apss_sparse_compacted(sp, t, k, block_m=block)
        torch.cuda.synchronize()
        launches = launches_now()["sparse_tile_candidates"]
        r = compare(np, matches_to_numpy(got), matches_to_numpy(ref), t, near)
        check(r["ok"], f"sparse edge probe {name}: {r}")
        if t > 1.0:
            check(int(ref.counts.sum()) == 0, "t=1.5 oracle has matches")
        else:
            check(launches > 0, f"sparse edge probe {name}: K3 never ran")
        if name == "duplicate_concentration":
            check(int(got.counts.sum()) == 2, "duplicate-concentration match dropped")
        if name == "negative_t_padded":
            check(bool((got.counts == sp.n - 1).all()), "padded rows matched at t < 0")
        results[name] = dict(matches=int(ref.counts.sum()), k3_launches=launches,
                             **{key: v for key, v in r.items() if key != "ok"})

    # K7 with an explicit mask: dead tiles are zeros, even at t < 0.
    x = corpus(300, 200, 6)
    mask = torch.ones((3, 3), dtype=torch.int32)
    mask[0, 2] = mask[1, 0] = mask[2, 1] = 0
    for t in (0.3, -0.5):
        reset_launches()
        got = apss_block_matmul(x, x, t, block_mask=mask, block_m=128, block_n=128,
                                block_k=256)
        torch.cuda.synchronize()
        check(launches_now()["apss_block"] == 1, "K7 probe did not launch once")
        xp = torch.nn.functional.pad(x, (0, 56, 0, 84))
        want = apss_block_plain(xp, xp, t, block_mask=mask, block_m=128,
                                block_n=128)[:300, :300]
        band = (dot_f32(x, x) - t).abs() <= TOL
        c = dense_compare(torch, got, want, band)
        dead = torch.repeat_interleave(torch.repeat_interleave(
            mask.cuda() == 0, 128, 0), 128, 1)[:300, :300]
        check(c["ok"], f"K7 explicit-mask probe at t={t}: {c}")
        check(not bool(got[dead].any()), f"K7 wrote nonzeros in a dead tile at t={t}")
        results[f"k7_dead_tiles_t{t}"] = dict(
            dead_entries=int(dead.sum()), nonzero=int((got != 0).sum()),
            **{key: v for key, v in c.items() if key != "ok"})
    emit("sparse_edge_probes", probes=results)


def generated(torch, make):
    """``(make(), seconds)`` for a corpus made on the host or the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = make()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def launch_counters() -> list:
    import importlib

    return [importlib.import_module(f"repro_torch.kernels.{m}").LAUNCHES for m in (
        "apss_block.fused", "flash_attention.flash_attention",
        "decode_attention.decode_attention")]


def reset_launches():
    for counts in launch_counters():
        for key in counts:
            counts[key] = 0


def launches_now() -> dict:
    return {k: v for counts in launch_counters() for k, v in counts.items()}


def packet_compare(np, phase, name, pk, pp, ij, *, grid, bm, k, t, near_p):
    """Forward, mirror and folded packets of a worklist kernel against its
    plain version (``near_p``: near-threshold pairs per padded row)."""
    from repro_torch.kernels.apss_block.ops import fold_packets

    wl = ij.cpu().numpy().astype(np.int64)
    fwd_rows = (wl[0][:, None] * bm + np.arange(bm)[None, :]).reshape(-1)
    mir_rows = (wl[1][:, None] * bm + np.arange(bm)[None, :]).reshape(-1)
    cf = compare(np, as_rows(np, *pk[:3]), as_rows(np, *pp[:3]), t, near_p[fwd_rows])
    cb = compare(np, as_rows(np, *pk[3:]), as_rows(np, *pp[3:]), t, near_p[mir_rows])

    def folded(p):
        return as_rows(np, *fold_packets(
            ij, p[0], p[1], p[2][..., 0], p[3], p[4], p[5][..., 0],
            grid_m=grid, block_m=bm, k=k,
        ))

    cfold = compare(np, folded(pk), folded(pp), t, near_p)
    for part, c in (("forward", cf), ("mirror", cb), ("folded", cfold)):
        check(c["ok"], f"{phase}: {name} {part} packets disagree with plain: {c}")
    return dict(cf, max_abs_err=max(cf["max_abs_err"], cb["max_abs_err"]),
                mirror=cb, folded=cfold)


def main_path_phase(np, torch, phase, D, gen_s, *, threshold, k):
    """K1 and K2 on a dense corpus on the card. Returns the kernel rows and,
    for the sparse phase on the same data, K2's result and the
    near-threshold counts."""
    from repro_torch import apss_blocked, apss_fused_compacted
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block import fused
    from repro_torch.kernels.apss_block.ops import _pad_to, _pick_bk, compact_worklist

    n, m = D.shape
    t, bm = threshold, 256

    paths = {
        "apss_blocked_kernel": lambda: apss_blocked(D, t, k, use_kernel=True),
        "apss_fused_compacted": lambda: apss_fused_compacted(D, t, k),
        "apss_blocked_plain": lambda: apss_blocked(D, t, k, use_kernel=False),
    }
    # Main path through the entry points, counted.
    reset_launches()
    first_ms = {}
    m_k1, first_ms["apss_blocked_kernel"] = timed(torch, paths["apss_blocked_kernel"])
    m_k2, first_ms["apss_fused_compacted"] = timed(torch, paths["apss_fused_compacted"])
    launches = launches_now()
    check(launches["apss_fused"] > 0 and launches["apss_tile_candidates"] > 0,
          f"{phase}: a kernel never ran: {launches}")

    ref, first_ms["apss_blocked_plain"] = timed(torch, paths["apss_blocked_plain"])
    wall = {name: wall_ms(np, torch, fn) for name, fn in paths.items()}
    near = near_threshold_counts(torch, D, t)
    ref_np = matches_to_numpy(ref)
    k2_np = matches_to_numpy(m_k2)
    c1 = compare(np, matches_to_numpy(m_k1), ref_np, t, near)
    c2 = compare(np, k2_np, ref_np, t, near)

    # The kernels' own inputs, as the main path builds them.
    bk = _pick_bk(m, 512)
    Dp = _pad_to(D, bm, bk)
    grid = Dp.shape[0] // bm
    mask1 = block_prune_mask(Dp, Dp, t, bm, bm, use_minsize=False)
    mask2, ub = block_prune_mask(Dp, Dp, t, bm, bm, return_ub=True)
    wl = compact_worklist(mask2, ub)
    ij = torch.as_tensor(wl).cuda()
    T = ij.shape[1]
    emit(phase, n=n, m=m, threshold=t, k=k, corpus_seconds=gen_s,
         live_tiles_k1=int(mask1.sum()), live_tiles_k2=int(mask2.sum()),
         total_tiles=grid * grid, worklist_T=T,
         total_matches=int(ref.counts.sum()),
         overflowed_rows=int(ref.overflowed().sum()),
         launches=launches,
         first_call_ms=first_ms, wall_ms=wall,
         k1_vs_plain=c1, k2_vs_plain=c2)
    check(c1["ok"], f"{phase}: K1 path disagrees with the plain path: {c1}")
    check(c2["ok"], f"{phase}: K2 path disagrees with the plain path: {c2}")

    near_p = np.concatenate([near, np.zeros(Dp.shape[0] - n, near.dtype)])
    valid = np.minimum(bm, n - np.arange(grid) * bm)  # valid rows per block
    rows = []

    # K1 against its plain version on the same padded inputs.
    kw1 = dict(block_m=bm, block_n=bm, n_valid_cols=n, exclude_self=True)
    out_k = fused.apss_fused_kernel(Dp, Dp, mask1, t, k, **kw1)
    out_p = fused.apss_fused_plain(Dp, Dp, mask1, t, k, **kw1)
    cmp1 = compare(np, as_rows(np, *out_k), as_rows(np, *out_p), t, near_p)
    check(cmp1["ok"], f"{phase}: K1 disagrees with its plain version: {cmp1}")
    mk = mask1.cpu().numpy()
    flop1 = 2.0 * m * float((mk * np.outer(valid, valid)).sum())
    bytes1 = 4.0 * n * m + n * (8 * k + 4) + mk.size
    row = kernel_row(
        np, torch, "apss_fused", phase, launches, cmp1,
        lambda: fused.apss_fused_kernel(Dp, Dp, mask1, t, k, **kw1),
        lambda: fused.apss_fused_plain(Dp, Dp, mask1, t, k, **kw1),
        lambda: library_topk(torch, D, t, k), flop1, bytes1,
    )
    segments = fused.fused_segments_for(Dp, Dp.shape[0], k)
    row_tiles = -(-Dp.shape[0] // fused.FUSED_TILE)
    row.update(segments=segments, grid=[row_tiles, segments],
               merge_grid=-(-Dp.shape[0] // 8) if segments > 1 else 0,
               slots=fused.fused_capacity(Dp.dtype, k, Dp.device))
    rows.append(row)

    # K2 against its plain version on the same padded inputs and worklist.
    kw2 = dict(block_m=bm, block_n=bm, n_valid=n)
    pk = fused.apss_tile_candidates_kernel(Dp, ij, t, k, **kw2)
    pp = fused.apss_tile_candidates_plain(Dp, ij, t, k, **kw2)
    cmp2 = packet_compare(np, phase, "K2", pk, pp, ij, grid=grid, bm=bm, k=k,
                          t=t, near_p=near_p)
    flop2 = 2.0 * m * float((valid[wl[0]] * valid[wl[1]]).sum())
    bytes2 = 4.0 * n * m + 8 * T + T * 2 * bm * (8 * k + 4)
    row = kernel_row(
        np, torch, "apss_tile_candidates", phase, launches, cmp2,
        lambda: fused.apss_tile_candidates_kernel(Dp, ij, t, k, **kw2),
        lambda: fused.apss_tile_candidates_plain(Dp, ij, t, k, **kw2),
        lambda: library_topk(torch, D, t, k), flop2, bytes2,
    )
    items = len(fused.tile_work_items(T, bm, bm))
    row.update(work_items=items, grid=[items, T], profile=profiled(  # scoring vs selection
        torch, lambda: fused.apss_tile_candidates_kernel(Dp, ij, t, k, **kw2), row["ms"],
        top=3, kernels={"apss_tile_candidates": "tile_part_kernel"}))
    rows.append(row)
    k1_np = matches_to_numpy(m_k1)
    del Dp, m_k1, m_k2, ref, out_k, out_p, pk, pp
    torch.cuda.empty_cache()
    return rows, dict(k2=k2_np, k1=k1_np, ref=ref_np, near=near)


def k7_phase(np, torch, phase, D, *, threshold) -> dict:
    """K7 through ``apss_block_matmul`` (auto mask) on a dense corpus on the
    card, held against ``apss_block_plain`` element by element."""
    from repro_torch import apss_block_matmul
    from repro_torch.core.precision import dot_f32
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.kernels.apss_block import apss_block
    from repro_torch.kernels.apss_block.ops import _pad_to

    n, m = D.shape
    t, bm = threshold, 256
    reset_launches()
    out, first_ms = timed(torch, lambda: apss_block_matmul(D, D, t))
    launches = launches_now()
    check(launches["apss_block"] > 0, f"{phase}: K7 never ran: {launches}")
    wall = wall_ms(np, torch, lambda: apss_block_matmul(D, D, t))

    Dp = _pad_to(D, bm, 512)
    mask = block_prune_mask(Dp, Dp, t, bm, bm, use_minsize=False)
    kw = dict(block_m=bm, block_n=bm)
    pk = apss_block.apss_block_kernel(Dp, Dp, mask, t, **kw)
    pp = apss_block.apss_block_plain(Dp, Dp, t, block_mask=mask, **kw)
    band = (dot_f32(Dp, Dp) - t).abs() <= TOL
    cmp = dense_compare(torch, pk, pp, band)
    main = dense_compare(torch, out, pp[:n, :n], band[:n, :n])
    del band
    emit(phase, n=n, m=m, threshold=t, live_tiles=int(mask.sum()),
         total_tiles=mask.numel(), launches=launches, first_call_ms=first_ms,
         wall_ms=wall, nonzero=int((pp != 0).sum()), main_vs_plain=main,
         kernel_vs_plain=cmp)
    check(main["ok"] and cmp["ok"], f"{phase}: K7 disagrees with plain: {main} {cmp}")
    mk = mask.cpu().numpy()
    grid = Dp.shape[0] // bm
    valid = np.minimum(bm, n - np.arange(grid) * bm)
    flop = 2.0 * m * float((mk * np.outer(valid, valid)).sum())
    nbytes = 4.0 * n * m + 4.0 * Dp.shape[0] ** 2 + mk.size

    def library():
        s = torch.matmul(D, D.T)
        return torch.where(s >= t, s, 0.0)

    # The tensor cores' passes: three tf32 (f32 split hi/lo) or one bf16.
    passes = apss_block.K7_PASSES[Dp.dtype]
    tc_peak = PEAK_TF32_TC_FLOPS if Dp.dtype == torch.float32 else PEAK_BF16_TC_FLOPS
    row = kernel_row(
        np, torch, "apss_block", phase, launches, cmp,
        lambda: apss_block.apss_block_kernel(Dp, Dp, mask, t, **kw),
        lambda: apss_block.apss_block_plain(Dp, Dp, t, block_mask=mask, **kw),
        library, passes * flop, nbytes, peak=tc_peak,
    )
    # Every score of a 1,024-row slice against its float64 product.
    xs = Dp[:1024]
    ones = torch.ones((xs.shape[0] // bm,) * 2, dtype=torch.int32)
    err64 = float((apss_block.apss_block_kernel(xs, xs, ones, -2.0, **kw).double()
                   - xs.double() @ xs.double().T).abs().max())
    row.update(passes=passes, tile=list(apss_block.K7_TILE), flop_scores=flop,
               bound_ms_fma=bound(flop, nbytes)[0], max_abs_err_f64_slice=err64)
    check(Dp.dtype != torch.float32 or err64 <= 2e-6,
          f"{phase}: K7 f32 is {err64:.3g} from the float64 product on 1,024 rows")
    del Dp, out, pk, pp
    torch.cuda.empty_cache()
    return row


def dense_compare(torch, got, ref, band) -> dict:
    """K7's rule: values within TOL, zero pattern equal off the band."""
    zero_bad = int((((got != 0) != (ref != 0)) & ~band).sum())
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    return dict(zero_pattern_mismatches=zero_bad, max_abs_err=err,
                band_entries=int(band.sum()), ok=zero_bad == 0 and err <= TOL)


def sparse_phase(np, torch, phase, sp, gen_s, *, threshold, k, dense=None) -> dict:
    """The sparse self-join (K3) through ``apss_blocked(sp, use_kernel=True)``
    on a CSR corpus on the card, against the plain sparse path and, with
    ``dense``, against K2's result on the same data."""
    from repro_torch import apss_blocked
    from repro_torch.core.pruning import live_tile_mask, sparse_block_stats
    from repro_torch.core.sparse import pad_rows_sparse, to_dense
    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block import sparse
    from repro_torch.kernels.apss_block.fused import _tile_packets
    from repro_torch.kernels.apss_block.ops import compact_worklist, fold_packets

    n, m = sp.shape
    t, bm = threshold, 256
    kernel_path = lambda: apss_blocked(sp, t, k, use_kernel=True)  # noqa: E731
    plain_path = lambda: apss_blocked(sp, t, k, use_kernel=False)  # noqa: E731
    reset_launches()
    got, first_k = timed(torch, kernel_path)
    launches = launches_now()
    check(launches["sparse_tile_candidates"] > 0, f"{phase}: K3 never ran: {launches}")
    ref, first_p = timed(torch, plain_path)
    wall = {"apss_blocked_sparse_kernel": wall_ms(np, torch, kernel_path),
            "apss_blocked_sparse_plain": wall_ms(np, torch, plain_path, reps=1)}
    if dense is None:
        near = near_threshold_counts(torch, to_dense(sp), t)
    else:
        near = dense["near"]
    got_np = matches_to_numpy(got)
    c = compare(np, got_np, matches_to_numpy(ref), t, near)
    vs_k2 = None
    if dense is not None:
        vs_k2 = compare(np, got_np, dense["k2"], t, near)
        vs_k2["counts_equal"] = bool(np.array_equal(got_np[2], dense["k2"][2]))

    # K3's own inputs, built stage by stage as the main path builds them, each
    # stage timed on the host clock up to a synchronize.
    stage = {}
    spp, _ = pad_rows_sparse(sp, bm)
    grid = spp.n // bm

    def stats_and_mask():
        stats = sparse_block_stats(spp, bm)
        return live_tile_mask(stats, stats, t, return_ub=True)

    (mask, ub), stage["stats_mask"] = timed(torch, stats_and_mask)
    wl, stage["host_worklist"] = timed(torch, lambda: compact_worklist(mask, ub))
    ij = torch.as_tensor(wl).cuda()
    T = ij.shape[1]
    (bdims, bx), stage["host_support_gather"] = timed(
        torch, lambda: sparse.block_support_gather(spp, bm))
    (bx, bdims), stage["support_to_card"] = timed(
        torch, lambda: (torch.from_numpy(bx).cuda(), torch.from_numpy(bdims).cuda()))
    idxb = spp.indices.reshape(grid, bm, spp.cap)
    valb = spp.values.reshape(grid, bm, spp.cap)
    yg, stage["tile_gather"] = timed(
        torch, lambda: sparse.gather_tiles(bdims, idxb, valb, ij))
    kw = dict(n_valid=n)
    pk, stage["k3"] = timed(
        torch, lambda: sparse.sparse_tile_candidates_kernel(bx, yg, ij, t, k, **kw))
    _, stage["fold"] = timed(torch, lambda: fold_packets(
        ij, pk[0], pk[1], pk[2][..., 0], pk[3], pk[4], pk[5][..., 0],
        grid_m=grid, block_m=bm, k=k))
    S = bx.shape[2]
    emit(phase, n=n, m=m, cap=spp.cap, nnz=int(sp.nnz.sum()), threshold=t, k=k,
         corpus_seconds=gen_s, support_S=S, worklist_T=T,
         live_tiles=int(mask.sum()), total_tiles=grid * grid,
         yg_bytes=yg.numel() * 4, bx_bytes=bx.numel() * 4, stage_ms=stage,
         total_matches=int(ref.counts.sum()),
         overflowed_rows=int(ref.overflowed().sum()),
         launches=launches, first_call_ms={"kernel": first_k, "plain": first_p},
         wall_ms=wall, k3_vs_plain=c, k3_vs_k2=vs_k2)
    check(c["ok"], f"{phase}: K3 path disagrees with the plain sparse path: {c}")
    if vs_k2 is not None:
        check(vs_k2["ok"] and vs_k2["counts_equal"],
              f"{phase}: K3 path disagrees with K2 on the same data: {vs_k2}")

    near_p = np.concatenate([near, np.zeros(spp.n - n, near.dtype)])
    pp = sparse.sparse_tile_candidates_plain(bx, yg, ij, t, k, **kw)
    cmp = packet_compare(np, phase, "K3", pk, pp, ij, grid=grid, bm=bm, k=k,
                         t=t, near_p=near_p)
    valid = np.minimum(bm, n - np.arange(grid) * bm)
    flop = 2.0 * S * float((valid[wl[0]] * valid[wl[1]]).sum())
    nbytes = 4.0 * (bx.numel() + yg.numel()) + 8 * T + T * 2 * bm * (8 * k + 4)
    ib = ij[0].long()

    def library():
        s = torch.bmm(bx[ib], yg.transpose(1, 2))
        return _tile_packets(s, ij[0], ij[1], threshold=t, k=k, block_m=bm,
                             block_n=bm, n_valid=n)

    row = kernel_row(
        np, torch, "sparse_tile_candidates", phase, launches, cmp,
        lambda: sparse.sparse_tile_candidates_kernel(bx, yg, ij, t, k, **kw),
        lambda: sparse.sparse_tile_candidates_plain(bx, yg, ij, t, k, **kw),
        library, flop, nbytes,
    )
    items = len(sparse.sparse_work_items(T, bm))
    row.update(work_items=items, grid=[items, T], support_S=S, profile=profiled(
        torch, lambda: sparse.sparse_tile_candidates_kernel(bx, yg, ij, t, k, **kw), row["ms"],
        top=3, kernels={"sparse_tile_candidates": "tile_part_kernel"}))
    del got, ref, bx, yg, pk, pp
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Serving phases (K4, K5, K6)
# ---------------------------------------------------------------------------


def rect_reference(torch, Q, C, t: float, k: int):
    """The rectangular oracle ``extract_matches(Q·Cᵀ, t, k, exclude_self=False)``
    and, per query row, the pairs with |s - t| <= TOL."""
    from repro_torch.core.matches import extract_matches
    from repro_torch.core.precision import dot_f32

    S = dot_f32(Q, C)
    near = ((S - t).abs() <= TOL).sum(dim=1).cpu().numpy()
    return extract_matches(S, t, k, exclude_self=False), near


def saturated(np, m, k):
    """``(values, indices, counts)`` with counts saturated at k."""
    v, i, c = m
    return v, i, np.minimum(c, k)


def identical(np, got, ref) -> bool:
    return all(np.array_equal(a, b) for a, b in zip(got, ref))


def tile_near(np, near, wl, bq):
    """Per packet row of a rectangular worklist, its query row's
    near-threshold count (0 on padded query rows)."""
    rows = (wl[0][:, None] * bq + np.arange(bq)[None, :]).reshape(-1)
    return np.concatenate([near, np.zeros(rows.max() + 1, near.dtype)])[rows]


def serving_inputs(np, torch, index, Q, t: float, block_q: int):
    """The padded batch, worklist (host and card) and bounds that
    ``query_topk`` builds for ``Q``."""
    from repro_torch.kernels.apss_block.ops import compact_rect_worklist
    from repro_torch.serving.query import _query_mask, _queries

    Qt = _queries(index, Q)
    Qp = torch.nn.functional.pad(Qt, (0, 0, 0, (-Qt.shape[0]) % block_q))
    mask, ub = _query_mask(Qp, index.stats, threshold=t, block_q=block_q,
                           use_minsize=True, normalized=index.normalized)
    wl = compact_rect_worklist(mask, ub)
    ubw = torch.from_numpy(ub.cpu().numpy()[wl[0], wl[1]].astype(np.float32)).cuda()
    return Qp, wl, torch.as_tensor(wl).cuda(), ubw


def rect_work(np, wl, *, B, n, bq, bc, depth, k, tiles=None):
    """FLOP and bytes of one rectangular kernel call: products over the valid
    rows of the tiles it scores (``tiles``: a mask, default all), each valid
    query row and each corpus row of those tiles read once at ``depth`` f32
    features, every packet written."""
    T = wl.shape[1]
    tiles = np.ones(T, bool) if tiles is None else tiles
    vq = np.clip(B - wl[0][tiles] * bq, 0, bq)
    vc = np.clip(n - wl[1][tiles] * bc, 0, bc)
    rows_c = np.clip(n - np.unique(wl[1][tiles]) * bc, 0, bc).sum()
    flop = 2.0 * depth * float((vq * vc).sum())
    return flop, 4.0 * depth * (B + rows_c) + 8 * T + T * bq * (8 * k + 4)


def library_rect(torch, Q, C, t: float, k: int):
    """Yardstick of K4 and K5: f32 ``torch.matmul(Q, Cᵀ)`` over the whole
    corpus plus a stable top-k (no tile masks). The port never calls it."""
    s = torch.matmul(Q, C.T)
    cnt = (s >= t).sum(dim=1)
    s = torch.where(s >= t, s, float("-inf"))
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k], cnt


def k4_row(np, torch, row_name, launches, index, Q, near, *, bq, t, k):
    """K4 against its plain version on the main path's inputs, timed."""
    from repro_torch.kernels.apss_block import fused

    B = Q.shape[0]
    Qp, wl, ij, _ = serving_inputs(np, torch, index, Q, t, bq)
    kw = dict(block_q=bq, block_c=index.block_rows, nc_valid=index.n)
    pk = fused.rect_tile_candidates_kernel(Qp, index.corpus, ij, t, k, **kw)
    pp = fused.rect_tile_candidates_plain(Qp, index.corpus, ij, t, k, **kw)
    c = compare(np, as_rows(np, *pk), as_rows(np, *pp), t, tile_near(np, near, wl, bq))
    check(c["ok"], f"{row_name}: K4 disagrees with its plain version: {c}")
    flop, nbytes = rect_work(np, wl, B=B, n=index.n, bq=bq, bc=index.block_rows,
                             depth=index.m, k=k)
    row = kernel_row(
        np, torch, "rect_tile_candidates", row_name, launches, c,
        lambda: fused.rect_tile_candidates_kernel(Qp, index.corpus, ij, t, k, **kw),
        lambda: fused.rect_tile_candidates_plain(Qp, index.corpus, ij, t, k, **kw),
        lambda: library_rect(torch, Qp[:B], index.corpus, t, k), flop, nbytes,
    )
    row.update(rect_split_fields(fused.rect_work_split(ij.shape[1], Qp.shape[1], bq,
                                                       index.block_rows), bq))
    return row


def rect_split_fields(split, bq: int) -> dict:
    """K4's and K6's launch shape: work items, the two grids of a pass
    (items; selection blocks of 8 warps), passes and scratch bytes."""
    return dict(tiles=split.n_tiles, work_items=split.n_items, n_chunks=split.n_chunks,
                strip_rows=split.strip_rows, passes=-(-split.n_tiles // split.pass_tiles),
                grid=[split.pass_tiles * split.n_chunks * split.strips,
                      -(-split.pass_tiles * bq // 8)],
                scratch_bytes=split.scratch_bytes)


def k5_row(np, torch, row_name, launches, index, Q, near, *, bq, t, k):
    """K5 against its plain version on the main path's inputs (packets and
    skip flags), timed; the bound counts the tiles this run scores."""
    from repro_torch.kernels.apss_block import fused

    B = Q.shape[0]
    Qp, wl, ij, ubw = serving_inputs(np, torch, index, Q, t, bq)
    kw = dict(block_q=bq, block_c=index.block_rows, nc_valid=index.n, nq_valid=B)
    pk = fused.rect_tile_candidates_early_exit_kernel(Qp, index.corpus, ij, ubw, t, k, **kw)
    pp = fused.rect_tile_candidates_early_exit_plain(Qp, index.corpus, ij, ubw, t, k, **kw)
    c = compare(np, as_rows(np, *pk[:3]), as_rows(np, *pp[:3]), t,
                tile_near(np, near, wl, bq))
    skipped = pk[3][:, 0].cpu().numpy().astype(bool)
    c["skip_flags_equal"] = bool(np.array_equal(skipped, pp[3][:, 0].cpu().numpy() == 1))
    check(c["ok"] and c["skip_flags_equal"],
          f"{row_name}: K5 disagrees with its plain version: {c}")
    flop, nbytes = rect_work(np, wl, B=B, n=index.n, bq=bq, bc=index.block_rows,
                             depth=index.m, k=k, tiles=~skipped)
    row = kernel_row(
        np, torch, "rect_tile_candidates_ee", row_name, launches, c,
        lambda: fused.rect_tile_candidates_early_exit_kernel(Qp, index.corpus, ij, ubw, t, k,
                                                             **kw),
        lambda: fused.rect_tile_candidates_early_exit_plain(Qp, index.corpus, ij, ubw, t, k,
                                                            **kw),
        lambda: library_rect(torch, Qp[:B], index.corpus, t, k), flop, nbytes + 8 * len(skipped),
    )
    split = fused.ee_split_for(Qp, index.corpus, block_q=bq, block_c=index.block_rows, k=k)
    row.update(live_tiles=len(skipped), scored_tiles=int((~skipped).sum()),
               grid_blocks=split.grid, n_chunks=split.n_chunks, strip_rows=split.strip_rows,
               work_items=len(split.items))
    return row


def k6_row(np, torch, row_name, launches, index, Q, near, *, bq, t, k):
    """K6 against its plain version on the main path's inputs, timed."""
    from repro_torch.kernels.apss_block import fused, sparse
    from repro_torch.kernels.apss_block.fused import _rect_tile_packets

    B = Q.shape[0]
    Qp, wl, ij, _ = serving_inputs(np, torch, index, Q, t, bq)
    qg = sparse.gather_query_tiles(Qp, index.bdims, ij, bq)
    kw = dict(nc_valid=index.n)
    pk = sparse.rect_sparse_tile_candidates_kernel(qg, index.bx, ij, t, k, **kw)
    pp = sparse.rect_sparse_tile_candidates_plain(qg, index.bx, ij, t, k, **kw)
    c = compare(np, as_rows(np, *pk), as_rows(np, *pp), t, tile_near(np, near, wl, bq))
    check(c["ok"], f"{row_name}: K6 disagrees with its plain version: {c}")
    bc, S = index.block_rows, qg.shape[2]
    flop, nbytes = rect_work(np, wl, B=B, n=index.n, bq=bq, bc=bc, depth=S, k=k)
    nbytes += 4.0 * S * (qg.shape[0] * bq - B)  # qg is read whole, padding rows too
    cj = ij[1].long()

    def library():
        s = torch.bmm(qg, index.bx[cj].transpose(1, 2))
        return _rect_tile_packets(s, cj, threshold=t, k=k, block_q=bq, block_c=bc,
                                  nc_valid=index.n)

    row = kernel_row(
        np, torch, "rect_sparse_tile_candidates", row_name, launches, c,
        lambda: sparse.rect_sparse_tile_candidates_kernel(qg, index.bx, ij, t, k, **kw),
        lambda: sparse.rect_sparse_tile_candidates_plain(qg, index.bx, ij, t, k, **kw),
        library, flop, nbytes,
    )
    row.update(support_S=S, **rect_split_fields(
        fused.rect_work_split(qg.shape[0], S, bq, bc, sparse.RECT_SCRATCH_BYTES), bq))
    return row


def query_tiles(*args, **kw):
    """``query_topk`` and the tiles it added to ``query.TILES``."""
    from repro_torch.serving import query

    query.TILES.update(total=0, live=0, scored=0)
    return query.query_topk(*args, **kw), dict(query.TILES)


def serving_edge_probes(np, torch) -> None:
    """query_topk through K4, K5 and K6 (and the plain early-exit scan) on the
    shapes that broke things before, and the tie probe of the strict skip
    test, against the rectangular oracle on the card."""
    from repro_torch.core.sparse import from_dense
    from repro_torch.interop import matches_to_numpy
    from repro_torch.serving import build_index, query_topk

    def corpus(n, m, seed, density=0.3):
        rng = np.random.default_rng(seed)
        D = np.abs(rng.standard_normal((n, m))).astype(np.float32)
        D *= rng.random((n, m)) < density
        D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(D).cuda()

    C, Q = corpus(130, 100, 1), corpus(5, 100, 11)
    Qz = Q.clone()
    Qz[2] = 0  # an all-zero query
    probes = {
        "n130_m100_B5": (Q, 0.35, 16),
        "negative_t_padded": (Q, -0.1, 16),
        "k_gt_n": (Q, 0.2, 160),
        "all_pruned_t1.5": (Q, 1.5, 16),
        "zero_query": (Qz, 0.2, 16),
    }
    indexes = {
        "dense": build_index(C, block_rows=64, normalize=False),
        "sparse": build_index(from_dense(C), block_rows=64, normalize=False),
    }
    results = {}
    for name, (Qb, t, k) in probes.items():
        ref, near = rect_reference(torch, Qb, C, t, k)
        ref_np = matches_to_numpy(ref)
        r = {}
        for kind, index in indexes.items():
            reset_launches()
            full = matches_to_numpy(query_topk(index, Qb, t, k, block_q=8, use_kernel=True))
            ee = matches_to_numpy(query_topk(index, Qb, t, k, block_q=8, use_kernel=True,
                                             early_exit=True))
            torch.cuda.synchronize()
            launches = launches_now()
            c = compare(np, full, ref_np, t, near)
            ce = compare(np, ee, saturated(np, ref_np, k), t, near)
            check(c["ok"] and ce["ok"], f"serving probe {name} ({kind}): {c} {ce}")
            check(identical(np, ee, saturated(np, full, k)),
                  f"serving probe {name} ({kind}): early exit differs from the full scan")
            used = (["rect_tile_candidates", "rect_tile_candidates_ee"] if kind == "dense"
                    else ["rect_sparse_tile_candidates"])
            if t <= 1.0:
                check(all(launches[u] > 0 for u in used),
                      f"serving probe {name} ({kind}): a kernel never ran: {launches}")
            else:
                check(int(full[2].sum()) == 0, f"serving probe {name}: t=1.5 matched")
            if t < 0:
                check(bool((full[2] == 130).all()), "padded corpus rows matched at t < 0")
            if name == "zero_query":
                check(int(full[2][2]) == 0, "an all-zero query matched")
            r[kind] = dict(launches={u: launches[u] for u in used},
                           **{key: v for key, v in c.items() if key != "ok"})
        results[name] = dict(matches=int(ref.counts.sum()), **r)

    # The tie probe: corpus block 1 (bound √2) fills both rows' top-k with
    # 1.0 first; block 0's bound is exactly 1.0, every row's k-th value, and
    # its lower ids must win, so the strict skip test has to score it.
    k = 4
    Ct = torch.zeros((128, 64))
    Ct[0:k, 3] = Ct[64:64 + k, 3] = 1.0
    Ct[k:2 * k, 17] = Ct[64 + k:64 + 2 * k, 17] = 1.0
    Ct[64 + 2 * k, [3, 17]] = float(np.float32(1 / np.sqrt(2)))
    Qt = torch.zeros((2, 64))
    Qt[0, 3] = Qt[1, 17] = 1.0
    want = [[0, 1, 2, 3], [4, 5, 6, 7]]
    tie = {}
    for kind, corpus_t in (("dense", Ct.cuda()), ("sparse", from_dense(Ct.cuda()))):
        index = build_index(corpus_t, block_rows=64, normalize=False)
        full = query_topk(index, Qt, 0.5, k, block_q=8, use_kernel=True)
        for way, use_kernel in (("kernel", True), ("plain", False)):
            ee, tiles = query_tiles(index, Qt, 0.5, k, block_q=8, use_kernel=use_kernel,
                                    early_exit=True)
            check(full.indices.tolist() == want and ee.indices.tolist() == want,
                  f"tie probe ({kind}, {way}): {full.indices.tolist()} {ee.indices.tolist()}")
            check(bool(torch.equal(ee.values, full.values)), f"tie probe ({kind}, {way})")
            check(tiles["scored"] == 2, f"tie probe ({kind}, {way}): tied tile skipped")
            tie[f"{kind}_{way}"] = tiles
    results["tie_probe"] = tie
    emit("serving_edge_probes", probes=results)


def f1_probe(np, torch) -> None:
    """F1 on the card: a bf16 dense index scores f32 queries unrounded. A
    standard-normal corpus of 4096 rows x 2560 features (2.5 FK chunks),
    normalised and stored in bf16, and 64 f32 queries (its first rows plus
    0.05-scaled noise, normalised), t = 0.05, k = 16, block_q 64: K4 (its
    f32 x bf16 entry) and K5 through ``query_topk`` must give exactly the
    plain path's counts, and both the float64 count on the bf16 corpus in
    every row with no pair within TOL of t."""
    from repro_torch.interop import matches_to_numpy
    from repro_torch.serving import build_index, query_topk

    rng = np.random.default_rng(0)
    C = rng.standard_normal((4096, 2560)).astype(np.float32)
    C /= np.linalg.norm(C, axis=1, keepdims=True)
    Q = C[:64] + 0.05 * rng.standard_normal((64, 2560)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    Qt = torch.from_numpy(Q).cuda()
    index = build_index(torch.from_numpy(C).cuda().bfloat16(), block_rows=256,
                        normalize=False)
    check(index.corpus.dtype == torch.bfloat16, "F1 probe: the index is not bf16")
    t, k = 0.05, 16
    kw = dict(block_q=64)
    reset_launches()
    full = matches_to_numpy(query_topk(index, Qt, t, k, use_kernel=True, **kw))
    ee = matches_to_numpy(query_topk(index, Qt, t, k, use_kernel=True, early_exit=True, **kw))
    torch.cuda.synchronize()
    launches = launches_now()
    plain = matches_to_numpy(query_topk(index, Qt, t, k, use_kernel=False, **kw))
    rounded = matches_to_numpy(query_topk(index, Qt.bfloat16(), t, k, use_kernel=False, **kw))
    S = Qt.double() @ index.corpus[:4096, :2560].double().T
    clear = ((S - t).abs() > TOL).all(dim=1).cpu().numpy()
    want = (S >= t).sum(dim=1).cpu().numpy()
    near = ((S - t).abs() <= TOL).sum(dim=1).cpu().numpy()
    c = compare(np, full, plain, t, near)
    emit("f1_probe", n=4096, m=2560, queries=64, threshold=t, k=k,
         launches={n: launches[n] for n in ("rect_tile_candidates", "rect_tile_candidates_ee")},
         clear_rows=int(clear.sum()), matches=int(plain[2].sum()),
         rows_where_bf16_queries_count_otherwise=int((rounded[2] != plain[2]).sum()),
         kernel_vs_plain=c)
    check(launches["rect_tile_candidates"] > 0 and launches["rect_tile_candidates_ee"] > 0,
          f"F1 probe: a kernel never ran: {launches}")
    check(clear.sum() >= 48, f"F1 probe: only {int(clear.sum())} rows clear of t")
    check(np.array_equal(full[2], plain[2]), "F1 probe: kernel and plain counts differ")
    check(np.array_equal(full[2][clear], want[clear]),
          "F1 probe: counts differ from the float64 count on the bf16 corpus")
    check(c["ok"], f"F1 probe: the kernel path disagrees with the plain path: {c}")
    check(identical(np, ee, saturated(np, full, k)), "F1 probe: K5 differs from K4")


def serve_radikal_phase(np, torch, phase, D, sp, *, threshold, k) -> tuple[list, dict]:
    """``query_topk`` on the radikal corpus: a dense index (K4 at B = 64 and
    at B = 8, K5) and a sparse one (K6), 64 perturbed rows as queries; each
    held against the plain path on the card and the oracle. Returns the
    ``kernels`` rows and, for the sharded and planner phases, the queries,
    the oracle and its near-threshold counts, the K4 results at B = 64 and
    8, the K6 result and both indices."""
    from repro_torch.data.sparse import perturbed_queries
    from repro_torch.interop import matches_to_numpy
    from repro_torch.serving import build_index, index_nbytes

    t = threshold
    n, m = D.shape
    dense, build_d = generated(torch, lambda: build_index(D, block_rows=256, normalize=False))
    spidx, build_s = generated(torch, lambda: build_index(sp, block_rows=256, normalize=False))
    Q = torch.from_numpy(perturbed_queries(sp, 64, seed=1)).cuda()
    runs = {  # name: (index, batch, block_q, early_exit, kernel)
        "k4_b64": (dense, 64, 64, False, "rect_tile_candidates"),
        "k4_b8": (dense, 8, 8, False, "rect_tile_candidates"),
        "k5_b64": (dense, 64, 64, True, "rect_tile_candidates_ee"),
        "k6_b64": (spidx, 64, 64, False, "rect_sparse_tile_candidates"),
    }

    def run(name, use_kernel):
        index, B, bq, ee, _ = runs[name]
        return query_tiles(index, Q[:B], t, k, block_q=bq, use_kernel=use_kernel,
                           early_exit=ee)

    first, got, launches = {}, {}, {}
    for name, (*_, kname) in runs.items():  # each path counted on its own
        reset_launches()
        got[name], first[name] = timed(torch, lambda: run(name, True))
        launches[name] = launches_now()
        check(launches[name][kname] > 0, f"{phase}: {kname} never ran: {launches[name]}")
    wall = {name: wall_ms(np, torch, lambda: run(name, True)) for name in runs}
    wall.update({f"{name}_plain": wall_ms(np, torch, lambda: run(name, False), reps=1)
                 for name in runs})
    ref, near = rect_reference(torch, Q, D, t, k)
    ref_np = matches_to_numpy(ref)
    cmp = {}
    for name, (res, tiles) in got.items():
        _, B, _, ee, _ = runs[name]
        g = matches_to_numpy(res)
        want = tuple(a[:B] for a in (saturated(np, ref_np, k) if ee else ref_np))
        plain = matches_to_numpy(run(name, False)[0])
        cmp[name] = dict(vs_oracle=compare(np, g, want, t, near[:B]),
                         vs_plain=compare(np, g, plain, t, near[:B]), **tiles)
        check(cmp[name]["vs_oracle"]["ok"] and cmp[name]["vs_plain"]["ok"],
              f"{phase}: {name} disagrees: {cmp[name]}")
    k4 = matches_to_numpy(got["k4_b64"][0])
    check(identical(np, matches_to_numpy(got["k5_b64"][0]), saturated(np, k4, k)),
          f"{phase}: K5's values/ids differ from K4's")
    emit(phase, n=n, m=m, threshold=t, k=k, queries=64,
         index_build_s={"dense": build_d, "sparse": build_s},
         index_bytes={"dense": index_nbytes(dense), "sparse": index_nbytes(spidx)},
         support_S=int(spidx.bx.shape[2]), total_matches=int(ref.counts.sum()),
         launches=launches, first_call_ms=first, wall_ms=wall, compare=cmp)
    kw = dict(t=t, k=k)
    rows = [
        k4_row(np, torch, f"{phase}/b64", launches["k4_b64"], dense, Q, near, bq=64, **kw),
        k4_row(np, torch, f"{phase}/b8", launches["k4_b8"], dense, Q[:8], near[:8], bq=8,
               **kw),
        k5_row(np, torch, phase, launches["k5_b64"], dense, Q, near, bq=64, **kw),
        k6_row(np, torch, phase, launches["k6_b64"], spidx, Q, near, bq=64, **kw),
    ]
    return rows, dict(Q=Q, oracle=ref_np, near=near, k4_b64=k4, k4_b64_tiles=got["k4_b64"][1],
                      k4_b8=matches_to_numpy(got["k4_b8"][0]),
                      k6_b64=matches_to_numpy(got["k6_b64"][0]), dense=dense, spidx=spidx)


def serve_sharded_phase(np, torch, phase, D, sp, served, *, threshold, k, p=4) -> list:
    """Sharded serving on the radikal corpus: a dense index in ``p`` row-block
    shards (``devices``: ``cuda:(s % device_count)``, all on one card
    here), rows padded to a multiple of ``p · 256``, so the last shard's
    last block is all padding and pruned; ``query_topk`` on the 64 queries
    of ``serve_radikal_phase`` (``served``) launches K4 once per shard with
    live tiles, at global ids. Its result must equal that phase's unsharded
    K4 result bit for bit and agree with the oracle and the sharded plain
    path. The same corpus in ``p`` CSR shards runs the plain gather-dot
    path against the oracle and refuses ``use_kernel`` and ``early_exit``.
    A ``RetrievalServer(use_kernel=True)`` on the dense shards answers the
    64 queries with no retry or degradation, equal to the one-shot call."""
    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block import fused
    from repro_torch.serving import RetrievalServer, build_index, index_nbytes, query_topk
    from repro_torch.serving.query import _query_mask, _queries, shard_worklists

    t, bq = threshold, 64
    Q, oracle, near = served["Q"], served["oracle"], served["near"]
    B = Q.shape[0]
    devices = [torch.device("cuda", s % torch.cuda.device_count()) for s in range(p)]
    dense, build_d = generated(torch, lambda: build_index(D, block_rows=256, normalize=False,
                                                          devices=devices))
    check(dense.n_shards == p and dense.n_padded % (p * 256) == 0,
          f"{phase}: {dense.n_shards} shards of {dense.n_padded} rows")
    Qp = _queries(dense, Q)
    Qp = torch.nn.functional.pad(Qp, (0, 0, 0, (-B) % bq))
    mask, ub = _query_mask(Qp, dense.stats, threshold=t, block_q=bq, use_minsize=True,
                           normalized=dense.normalized)
    mask = mask.cpu().numpy()
    work = shard_worklists(dense, mask, ub.cpu().numpy())
    shard_tiles = [0] * p
    for s, ij in work:
        shard_tiles[s] = ij.shape[1]
    live_shards = sum(1 for n in shard_tiles if n)
    real_blocks = -(-dense.n // dense.block_rows)
    check(not mask[:, real_blocks:].any() and sum(shard_tiles) == served["k4_b64_tiles"]["live"],
          f"{phase}: per-shard live tiles {shard_tiles} against the unsharded "
          f"{served['k4_b64_tiles']}, padding blocks live: {mask[:, real_blocks:].any()}")

    def sharded(use_kernel=True):
        return query_tiles(dense, Q, t, k, block_q=bq, use_kernel=use_kernel)

    reset_launches()
    (got, tiles), first_ms = timed(torch, sharded)
    launches = launches_now()
    check(launches["rect_tile_candidates"] == live_shards,
          f"{phase}: K4 launched {launches['rect_tile_candidates']} times for "
          f"{live_shards} shards with live tiles")
    check(tiles["live"] == tiles["scored"] == sum(shard_tiles)
          and tiles["total"] == dense.n_blocks, f"{phase}: tiles {tiles}, per shard "
          f"{shard_tiles}")
    g = matches_to_numpy(got)
    plain = matches_to_numpy(sharded(use_kernel=False)[0])
    cmp = dict(vs_oracle=compare(np, g, oracle, t, near), vs_plain=compare(np, g, plain, t, near),
               identical_to_unsharded_k4=identical(np, g, served["k4_b64"]))
    check(cmp["identical_to_unsharded_k4"],
          f"{phase}: the sharded K4 result differs from the unsharded one")
    check(cmp["vs_oracle"]["ok"] and cmp["vs_plain"]["ok"], f"{phase}: disagrees: {cmp}")
    wall = dict(k4=wall_ms(np, torch, sharded),
                plain=wall_ms(np, torch, lambda: sharded(use_kernel=False), reps=1))
    profile = profiled(torch, sharded, wall["k4"]["median"],
                       kernels={"rect_tile_candidates": "rect_part_kernel"})
    check_profile(phase, profile)

    kw = dict(block_q=bq, block_c=dense.block_rows, nc_valid=dense.n)
    shard_ij = [(dense.shards[s], torch.from_numpy(ij).cuda()) for s, ij in work]

    def k4_all():
        return [fused.rect_tile_candidates_kernel(Qp, C, ij, t, k, **kw) for C, ij in shard_ij]

    def plain_all():
        return [fused.rect_tile_candidates_plain(Qp, C, ij, t, k, **kw) for C, ij in shard_ij]

    shard_ms = [time_ms(np, torch, lambda: fused.rect_tile_candidates_kernel(
        Qp, C, ij, t, k, **kw)) for C, ij in shard_ij]
    wl = np.concatenate([ij for _, ij in work], axis=1)

    def rows_of(packets):
        return as_rows(np, *(torch.cat(f) for f in zip(*packets)))

    pc = compare(np, rows_of(k4_all()), rows_of(plain_all()), t, tile_near(np, near, wl, bq))
    check(pc["ok"], f"{phase}: K4 disagrees with its plain version on the shards: {pc}")
    flop, nbytes = rect_work(np, wl[[0, 2]], B=B, n=dense.n, bq=bq, bc=dense.block_rows,
                             depth=dense.m, k=k)
    row = kernel_row(
        np, torch, "rect_tile_candidates", f"{phase}/b64", launches, pc, k4_all, plain_all,
        lambda: [library_rect(torch, Qp[:B], C, t, k) for C in dense.shards],
        flop, nbytes + 4 * wl.shape[1],  # the worklists' third row
    )
    row.update(shards=p, shard_tiles=shard_tiles, shard_ms=shard_ms,
               shard_ms_sum=float(sum(shard_ms)))

    srv = RetrievalServer(dense, threshold=t, k=k, max_batch=B, block_q=bq, normalize=False,
                          cache_size=0, use_kernel=True)
    reset_launches()
    results = srv.serve(list(Q.cpu().numpy()))
    server_launches = launches_now()["rect_tile_candidates"]
    stats = srv.stats
    check(all(r.status == "ok" for r in results) and stats.retries == stats.degraded == 0,
          f"{phase}: the server retried or degraded: {stats}")
    check(server_launches == live_shards, f"{phase}: the server launched K4 "
          f"{server_launches} times for one batch")
    check(all(np.array_equal(r.values, g[0][i]) and np.array_equal(r.indices, g[1][i])
              and r.count == g[2][i] for i, r in enumerate(results)),
          f"{phase}: the server's answers differ from the one-shot query")
    dense_bytes = index_nbytes(dense)
    del dense, shard_ij, srv
    torch.cuda.empty_cache()

    spsh, build_s = generated(torch, lambda: build_index(sp, block_rows=256, normalize=False,
                                                         devices=devices))
    reset_launches()
    (gs, sp_tiles), sp_first_ms = timed(torch, lambda: query_tiles(spsh, Q, t, k, block_q=bq))
    sp_launches = {n: c for n, c in launches_now().items() if c}
    cmp["sparse_vs_oracle"] = compare(np, matches_to_numpy(gs), oracle, t, near)
    check(cmp["sparse_vs_oracle"]["ok"], f"{phase}: the sparse shards disagree: {cmp}")
    refusals = {name: _raises(lambda: query_topk(spsh, Q, t, k, block_q=bq, **kw_),
                              NotImplementedError)
                for name, kw_ in (("use_kernel", dict(use_kernel=True)),
                                  ("early_exit", dict(early_exit=True)))}
    check(all(refusals.values()), f"{phase}: the sparse shards did not refuse: {refusals}")
    wall["sparse_plain"] = wall_ms(np, torch, lambda: query_tiles(spsh, Q, t, k, block_q=bq))
    emit(phase, n=D.shape[0], m=D.shape[1], threshold=t, k=k, queries=B, shards=p,
         devices=[str(d) for d in devices], n_padded=spsh.n_padded, nb_local=spsh.nb_local,
         shard_tiles=shard_tiles, tiles=tiles, sparse_tiles=sp_tiles,
         index_build_s={"dense": build_d, "sparse": build_s},
         index_bytes={"dense": dense_bytes, "sparse": index_nbytes(spsh)},
         launches=launches, sparse_launches=sp_launches, server_launches=server_launches,
         server=dict(requests=len(results), steps=stats.steps, retries=stats.retries,
                     degraded=stats.degraded),
         first_call_ms={"k4": first_ms, "sparse_plain": sp_first_ms}, wall_ms=wall,
         profile=profile, shard_ms=shard_ms, compare=cmp, refusals=refusals)
    del spsh
    torch.cuda.empty_cache()
    return [row]


def drive_server(srv, queries, nreq: int, *, step_server: bool):
    """Closed-loop burst of ``nreq`` requests. The step server gets
    ``max_batch`` submits and then their ``result()`` calls, which step it
    (``benchmarks/bench_serve.py`` steps it at each full batch); the
    continuous server gets every submit at once and its workers score them
    as they arrive. Returns ``(wall seconds, results, latencies)``: a
    request's latency runs from its submit to the return of its
    ``result()`` call, in ms on the host clock."""
    t0 = time.perf_counter()
    group = srv.max_batch if step_server else nreq
    results, lat = [], []
    for a in range(0, nreq, group):
        sent = []
        for i in range(a, min(a + group, nreq)):
            at = time.perf_counter()
            sent.append((srv.submit(queries[i % len(queries)]), at))
        for rid, at in sent:
            results.append(srv.result(rid))
            lat.append((time.perf_counter() - at) * 1e3)
    return time.perf_counter() - t0, results, lat


def serve_clustered_phase(np, torch, phase, sp, *, threshold, k) -> dict:
    """Serving on ``bench_serve.py``'s corpus and traffic: ``query_topk`` at
    B = 1, 8 and 64 through K6, sparse early exit, and both servers at
    max_batch 8 and 64 (192 closed-loop requests, no cache)."""
    from repro_torch.core.sparse import to_dense
    from repro_torch.data.sparse import perturbed_queries
    from repro_torch.interop import matches_to_numpy
    from repro_torch.serving import (
        ContinuousRetrievalServer,
        RetrievalServer,
        build_index,
        index_nbytes,
        query_topk,
    )

    t = threshold
    n, m = sp.shape
    index, build_s = generated(torch, lambda: build_index(sp, block_rows=256, normalize=False))
    qmax = perturbed_queries(sp, 64, seed=1)
    Q = torch.from_numpy(qmax).cuda()
    ref, near = rect_reference(torch, Q, to_dense(sp), t, k)
    ref_np = matches_to_numpy(ref)

    def run(B, use_kernel=True, early_exit=False):
        return query_tiles(index, Q[:B], t, k, block_q=max(8, B), use_kernel=use_kernel,
                           early_exit=early_exit)

    got, first, launches = {}, {}, {}
    for name, B, early_exit in (("b1", 1, False), ("b8", 8, False), ("b64", 64, False),
                                ("ee_b64", 64, True)):  # each path counted on its own
        reset_launches()
        got[name], first[name] = timed(torch, lambda: run(B, early_exit=early_exit))
        launches[name] = launches_now()
        check(launches[name]["rect_sparse_tile_candidates"] > 0,
              f"{phase}: K6 never ran on {name}: {launches[name]}")
    ee = got.pop("ee_b64")
    wall = {f"b{B}": wall_ms(np, torch, lambda: run(B)) for B in (1, 8, 64)}
    wall["ee_b64"] = wall_ms(np, torch, lambda: run(64, early_exit=True))
    wall.update({f"b{B}_plain": wall_ms(np, torch, lambda: run(B, False), reps=1)
                 for B in (1, 8, 64)})
    cmp = {}
    for name, (res, tiles) in got.items():
        B = int(name[1:])
        g = matches_to_numpy(res)
        cmp[name] = dict(
            vs_oracle=compare(np, g, tuple(a[:B] for a in ref_np), t, near[:B]),
            vs_plain=compare(np, g, matches_to_numpy(run(B, False)[0]), t, near[:B]),
            **tiles)
        check(cmp[name]["vs_oracle"]["ok"] and cmp[name]["vs_plain"]["ok"],
              f"{phase}: B={B} disagrees: {cmp[name]}")
    ee_np = matches_to_numpy(ee[0])
    check(identical(np, ee_np, saturated(np, matches_to_numpy(got["b64"][0]), k)),
          f"{phase}: sparse early exit differs from the K6 scan")
    cmp["ee_b64"] = ee[1]

    servers = {}
    for max_batch in (8, 64):
        bq = max(8, max_batch)
        one_shot = [matches_to_numpy(query_topk(index, Q[i:i + 1], t, k, block_q=bq,
                                                use_kernel=True)) for i in range(64)]
        for kind in ("step", "continuous"):
            kwargs = dict(threshold=t, k=k, max_batch=max_batch, cache_size=0,
                          use_kernel=True, normalize=False)

            def make():
                if kind == "continuous":
                    return ContinuousRetrievalServer(index, workers=2, **kwargs)
                return RetrievalServer(index, **kwargs)

            warm = make()
            warm.serve(list(qmax[:max_batch]))
            warm.close()
            srv = make()
            reset_launches()
            wall_s, results, lat_ms = drive_server(srv, list(qmax), 192,
                                                   step_server=kind == "step")
            srv.close()
            k6 = launches_now()["rect_sparse_tile_candidates"]
            st = srv.stats
            lat = np.percentile(lat_ms, [50, 99])
            ok = sum(r.status == "ok" for r in results)
            check(ok == 192 and st.degraded == 0 and st.retries == 0 and k6 > 0,
                  f"{phase}: {kind} server at max_batch {max_batch}: ok={ok} {st} K6={k6}")
            for i, r in enumerate(results):
                v, ids, c = one_shot[i % 64]
                check(r.count == int(c[0]) and np.array_equal(r.indices, ids[0])
                      and np.array_equal(r.values, v[0]),
                      f"{phase}: {kind} server result {i} differs from the one-shot call")
            servers[f"{kind}_{max_batch}"] = dict(
                requests=192, ok=ok, qps=192 / wall_s, wall_s=wall_s,
                latency_ms_submit_to_result_host={"p50": float(lat[0]), "p99": float(lat[1])},
                steps=st.steps, degraded=st.degraded, retries=st.retries, k6_launches=k6)
    emit(phase, n=n, m=m, threshold=t, k=k, index_build_s=build_s,
         index_bytes=index_nbytes(index), support_S=int(index.bx.shape[2]),
         launches=launches, first_call_ms=first, wall_ms=wall, compare=cmp,
         servers=servers)
    row = k6_row(np, torch, phase, launches["b64"], index, Q, near, bq=64, t=t, k=k)
    del index
    torch.cuda.empty_cache()
    return row


def serve_early_exit_phase(np, torch, phase) -> dict:
    """``bench_serve.measure_early_exit``'s corpus: cross-cluster tiles stay
    live through a weak shared vocabulary but lose to within-cluster top-k.
    Densified through K5 and sparse through the plain scan with K6 tiles:
    both must skip tiles and equal their full scans."""
    from repro_torch.core.sparse import to_dense
    from repro_torch.data.sparse import perturbed_queries, sparse_clustered_corpus
    from repro_torch.interop import matches_to_numpy
    from repro_torch.serving import build_index

    t, k = 0.01, 8
    sp = sparse_clustered_corpus(8192, 2048, 16.0, n_clusters=16, seed=2, overlap_dims=8)
    Q = torch.from_numpy(perturbed_queries(sp, 64, seed=3)).cuda()
    dense = build_index(to_dense(sp), block_rows=64, normalize=False)
    spidx = build_index(sp, block_rows=64, normalize=False)

    launches = {}

    def run(name, index, use_kernel, early_exit, kname=None):
        reset_launches()
        res, tiles = query_tiles(index, Q, t, k, block_q=64, use_kernel=use_kernel,
                                 early_exit=early_exit)
        torch.cuda.synchronize()
        launches[name] = launches_now()
        if kname:
            check(launches[name][kname] > 0, f"{phase}: {kname} never ran on {name}")
        return matches_to_numpy(res), tiles

    k4, k4s = run("k4", dense, True, False, "rect_tile_candidates")
    k5, k5s = run("k5", dense, True, True, "rect_tile_candidates_ee")
    k6, _ = run("k6", spidx, True, False, "rect_sparse_tile_candidates")
    sp_ee, sp_ees = run("sparse_scan", spidx, True, True, "rect_sparse_tile_candidates")
    plain_ee, plain_ees = run("dense_plain_scan", dense, False, True)
    ref, near = rect_reference(torch, Q, to_dense(sp), t, k)
    ref_np = saturated(np, matches_to_numpy(ref), k)
    scored = {"k5": k5s, "dense_plain_scan": plain_ees, "sparse_scan_k6_tiles": sp_ees}
    c_plain = compare(np, plain_ee, ref_np, t, near)
    c_k5 = compare(np, k5, ref_np, t, near)
    emit(phase, n=sp.n, m=sp.m, threshold=t, k=k, queries=64, launches=launches,
         live_tiles=k4s["live"], scored=scored, k5_vs_oracle=c_k5,
         plain_scan_vs_oracle=c_plain)
    check(identical(np, k5, saturated(np, k4, k)), f"{phase}: K5 differs from the K4 scan")
    check(identical(np, sp_ee, saturated(np, k6, k)), f"{phase}: sparse scan differs from K6")
    check(k5s["scored"] < k5s["live"] and sp_ees["scored"] < sp_ees["live"],
          f"{phase}: no tile skipped: {scored}")
    check(c_k5["ok"] and c_plain["ok"], f"{phase}: {c_k5} {c_plain}")
    row = k5_row(np, torch, phase, launches["k5"], dense, Q, near, bq=64, t=t, k=k)
    del dense, spidx
    torch.cuda.empty_cache()
    return row

# ---------------------------------------------------------------------------
# LM serving: K8 (prefill) and K9 (decode)
# ---------------------------------------------------------------------------


def _attention_modules():
    import importlib

    return (importlib.import_module("repro_torch.kernels.flash_attention.flash_attention"),
            importlib.import_module("repro_torch.kernels.decode_attention.decode_attention"))


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _dtype_name(torch, dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def _k9_compare(torch, got, want) -> dict:
    """K9 partials against the plain version's: normalised output, m, l."""
    (acc, m, l), (pacc, pm, pl) = got, want
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    pout = pacc / torch.where(pl == 0, 1.0, pl)[..., None]
    l_rel = ((l - pl).abs() / torch.where(pl == 0, 1.0, pl)).max().item()
    return dict(max_abs_err=(out - pout).abs().max().item(),
                m_err=(m - pm).abs().max().item(), l_rel_err=l_rel)


def _k9_ok(cmp: dict, dtype_name: str) -> bool:
    return (cmp["max_abs_err"] <= LM_ATOL[dtype_name] and cmp["m_err"] <= 2e-5
            and cmp["l_rel_err"] <= 1e-5)


K8_PROBES = [  # B, Hq, Hkv, S, D, causal
    (1, 2, 2, 1, 16, True),       # S = 1, group 1
    (2, 4, 2, 130, 64, True),     # S not a multiple of the tile, group 2
    (1, 8, 1, 200, 128, True),    # group 8
    (2, 16, 8, 256, 128, False),  # non-causal, divisible S
]
K9_PROBES = [  # B, Hq, Hkv, L, D, lengths
    (3, 2, 2, 100, 16, [0, 1, 100]),    # lengths 0, 1 and L; group 1
    (3, 4, 2, 1000, 64, [0, 1, 1000]),  # L not a multiple of a tile; group 2
    (2, 16, 2, 777, 128, [777, 5]),     # group 8
]


def lm_edge_probes(np, torch) -> None:
    from repro_torch.kernels.flash_attention import flash_attention

    k8, k9 = _attention_modules()
    g = torch.Generator("cuda").manual_seed(0)

    def normal(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    errs, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        dn = _dtype_name(torch, dtype)
        for B, Hq, Hkv, S, D, causal in K8_PROBES:
            q, k, v = normal((B, Hq, S, D), dtype), normal((B, Hkv, S, D), dtype), \
                normal((B, Hkv, S, D), dtype)
            got = flash_attention(q, k, v, causal=causal)
            want = k8.flash_attention_plain(q, k, v, causal=causal)
            name = f"k8_{B}x{Hq}x{Hkv}x{S}x{D}_{'causal' if causal else 'full'}_{dn}"
            errs[name] = (got.float() - want.float()).abs().max().item()
            if not (got.dtype == dtype and errs[name] <= LM_ATOL[dn]):
                bad.append(name)
        for B, Hq, Hkv, L, D, lengths in K9_PROBES:
            q, k, v = normal((B, Hq, D), dtype), normal((B, Hkv, L, D), dtype), \
                normal((B, Hkv, L, D), dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            cmp = _k9_compare(torch, k9.decode_attention_kernel(q, k, v, lens),
                              k9.decode_attention_plain(q, k, v, lens))
            name = f"k9_{B}x{Hq}x{Hkv}x{L}x{D}_len{'-'.join(map(str, lengths))}_{dn}"
            errs[name] = cmp
            if not _k9_ok(cmp, dn):
                bad.append(name)
    torch.cuda.synchronize()
    q = normal((1, 2, 130, 64), torch.float32)
    noncausal_raises = _raises(lambda: flash_attention(q, q, q, causal=False), ValueError)
    emit("lm_edge_probes", errors=errs, noncausal_value_error=noncausal_raises)
    check(not bad, f"lm_edge_probes: kernel differs from its plain version: {bad}")
    check(noncausal_raises, "lm_edge_probes: non-causal ragged S did not raise")


def _bf16_ulps(torch, got, want) -> float:
    """Largest |got - want| in bf16 ulps of want (8 significant bits)."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return ((got - want).abs() / ulp).max().item()


def r1_probe(np, torch) -> None:
    """ROADMAP R1: K8 and K9 in bf16 with V from 4 * (1 + |N(0, 1)|), so
    every output lies at or above 4, where one bf16 ulp (0.031) passes the
    absolute 2e-2 bound. Each against its plain version and the f32
    reference: the largest |Δ|, in bf16 ulps of the output too. Held to the
    card test's bounds: K8 within 2 ulps, K9 within a relative 1e-5."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    from repro_torch.kernels.flash_attention import attention_reference, flash_attention

    k8, k9 = _attention_modules()
    g = torch.Generator("cuda").manual_seed(4)

    def normal(shape):
        return torch.randn(shape, generator=g, device="cuda")

    bf = torch.bfloat16
    q, k = normal((2, 16, 1024, 128)).to(bf), normal((2, 8, 1024, 128)).to(bf)
    v = (4 * (1 + normal((2, 8, 1024, 128)).abs())).to(bf)
    qd = normal((2, 16, 128)).to(bf)
    lens = torch.tensor([1024, 333], dtype=torch.int32, device="cuda")
    got8 = flash_attention(q, k, v).float()
    acc, _, l = k9.decode_attention_kernel(qd, k, v, lens)
    got9 = acc / l[..., None]
    pacc, _, pl = k9.decode_attention_plain(qd, k, v, lens)
    wants = {
        "k8_vs_plain": (got8, k8.flash_attention_plain(q, k, v).float()),
        "k8_vs_f32_reference": (got8, attention_reference(q.float(), k.float(), v.float())),
        "k9_vs_plain": (got9, pacc / pl[..., None]),
        "k9_vs_f32_reference": (got9, decode_attention_reference(
            qd.float(), k.float(), v.float(), lens)),
    }
    out = {name: dict(max_abs_err=(a - b).abs().max().item(), max_ulps=_bf16_ulps(torch, a, b),
                      max_rel_err=((a - b).abs() / b.abs()).max().item(),
                      out_min=b.min().item(), out_max=b.max().item())
           for name, (a, b) in wants.items()}
    emit("r1_probe", **out)
    for name, r in out.items():
        bound_ok = r["max_ulps"] <= 2 if name.startswith("k8") else r["max_rel_err"] <= 1e-5
        check(r["out_min"] >= 4 and bound_ok, f"r1_probe: {name} outside its bound: {r}")


def _top1(a, b) -> int:
    """Positions whose top-1 token is the same in two logit tensors."""
    return int((a.argmax(-1) == b.argmax(-1)).sum())


def _max_dlogit(a, b) -> float:
    return max((a[i].float() - b[i].float()).abs().max().item() for i in range(a.shape[0]))


def lm_model(torch):
    """The full qwen3-1.7b config in bf16, weights from seed 0 on the card."""
    from repro_torch.configs.qwen3_1_7b import config
    from repro_torch.models.transformer import count_params, init_transformer

    cfg = config()
    model, init_s = generated(torch, lambda: init_transformer(
        cfg, generator=torch.Generator("cuda").manual_seed(0), device="cuda"))
    n = count_params(cfg)
    check(n == sum(p.numel() for p in model.parameters()), "lm_model: parameter count")
    emit("lm_model", config=cfg.name, params=n,
         weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
         init_seconds=init_s)
    return cfg, model


def lm_prefill_phase(np, torch, phase, cfg, model, *, batch=2, seq=4096) -> dict:
    from repro_torch.models.transformer import prefill, transformer_logits

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)).cuda()
    reset_launches()
    logits, first_ms = timed(torch, lambda: prefill(model, cfg, tokens))
    launches = launches_now()
    check(launches["flash_attention"] == cfg.n_layers,
          f"{phase}: K8 launched {launches['flash_attention']} times, not {cfg.n_layers}")
    check(tuple(logits.shape) == (batch, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          f"{phase}: prefill logits {tuple(logits.shape)} not finite or misshaped")
    wall = wall_ms(np, torch, lambda: prefill(model, cfg, tokens))
    profile = profiled(torch, lambda: prefill(model, cfg, tokens), wall["median"])
    plain = prefill(model, cfg, tokens, use_kernel=False)
    plain_wall = wall_ms(np, torch, lambda: prefill(model, cfg, tokens, use_kernel=False))
    prefill_dlogit = (logits - plain).abs().max().item()
    n = batch * seq
    lk = transformer_logits(model, cfg, tokens)
    lp = transformer_logits(model, cfg, tokens, use_kernel=False)
    finite = bool(torch.isfinite(lk).all())
    # The same weights in f32: K8 and the plain path then differ only in the
    # order of their f32 sums, below bf16's rounding noise.
    m32, cfg32 = copy.deepcopy(model).float(), dataclasses.replace(cfg, dtype=torch.float32)
    lk32 = transformer_logits(m32, cfg32, tokens)
    lp32 = transformer_logits(m32, cfg32, tokens, use_kernel=False)
    del m32
    agree = dict(bf16=_top1(lk, lp), f32=_top1(lk32, lp32),
                 bf16_kernel_vs_f32=_top1(lk, lp32), bf16_plain_vs_f32=_top1(lp, lp32))
    dlogit = dict(bf16=_max_dlogit(lk, lp), f32=_max_dlogit(lk32, lp32))
    del lk, lp, lk32, lp32
    torch.cuda.empty_cache()
    emit(phase, batch=batch, seq=seq, launches=launches, first_call_ms=first_ms,
         wall_ms=wall, plain_wall_ms=plain_wall, profile=profile,
         prefill_max_abs_dlogit=prefill_dlogit,
         prefill_top1_equal=int((logits.argmax(-1) == plain.argmax(-1)).sum()),
         logits_max_abs_dlogit=dlogit, logits_top1_agree=agree, positions=n,
         top1_agreement={k: v / n for k, v in agree.items()})
    check(finite, f"{phase}: transformer_logits not finite")
    check_profile(phase, profile)
    # In f32 the two paths differ by summation order only (|Δlogit| ~1e-6):
    # at most 2 of the positions may flip a near-tie.
    check(agree["f32"] >= n - 2 and dlogit["f32"] <= 1e-4,
          f"{phase}: f32 top-1 agreement {agree['f32']}/{n}, |Δlogit| {dlogit['f32']}")
    check(agree["bf16_kernel_vs_f32"] >= agree["bf16_plain_vs_f32"] - 0.01 * n,
          f"{phase}: in bf16 the kernel path is farther from the f32 model than the plain "
          f"path: {agree}")
    return k8_row(np, torch, phase, launches, batch, cfg.n_heads, cfg.n_kv_heads, seq,
                  cfg.head_dim)


def k8_row(np, torch, phase, launches, B, Hq, Hkv, S, D) -> dict:
    """K8 at one layer's shapes: bf16 (the model's dtype, the tensor-core
    kernel) and f32 (the FMA kernel) against the plain version; the bf16
    times beside SDPA (flash, GQA, causal), bound at the bf16 tensor-core
    peak; the f32 kernel's time as ``ms_f32`` beside its own bound."""
    import torch.nn.functional as F

    k8, _ = _attention_modules()
    g = torch.Generator("cuda").manual_seed(1)
    q32, k32, v32 = (torch.randn(shape, generator=g, device="cuda")
                     for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (a.to(dtype) for a in (q32, k32, v32))
        got = k8.flash_attention_kernel(q, k, v)
        want = k8.flash_attention_plain(q, k, v)
        dn = _dtype_name(torch, dtype)
        errs[dn] = (got.float() - want.float()).abs().max().item()
        check(errs[dn] <= LM_ATOL[dn], f"{phase}: K8 differs from its plain version in {dn}: "
              f"{errs[dn]}")
        del got, want
    ms_f32 = time_ms(np, torch, lambda: k8.flash_attention_kernel(q32, k32, v32))
    scale = 1.0 / D ** 0.5
    library_ms_f32 = time_ms(np, torch, lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True, scale=scale, enable_gqa=True))
    flop = 4.0 * D * (S * (S + 1) / 2) * B * Hq
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    row = kernel_row(
        np, torch, "flash_attention", phase, launches, dict(max_abs_err=errs["bfloat16"]),
        lambda: k8.flash_attention_kernel(q, k, v),
        lambda: k8.flash_attention_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale,
                                               enable_gqa=True),
        flop, nbytes, peak=PEAK_BF16_TC_FLOPS)
    row.update(shape=[B, Hq, Hkv, S, D], dtype="bfloat16", max_abs_err_f32=errs["float32"],
               ms_f32=ms_f32, bound_ms_f32=bound(flop, 2 * nbytes)[0],
               library_ms_f32=library_ms_f32,
               per_prefill_bound_ms=row["bound_ms"] * launches["flash_attention"])
    return row


def lm_decode_phase(np, torch, phase, cfg, model, *, batch=8, max_len=32768):
    """Returns the K9 row and the largest |Δlogit| between the two paths."""
    from repro_torch.models.transformer import decode_step, make_cache

    rng = np.random.default_rng(0)
    lens = rng.integers(1, max_len, size=batch)  # in [1, max_len - 1]
    lens[0] = max_len - 1
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, batch).astype(np.int32)).cuda()
    lens_t = torch.from_numpy(lens.astype(np.int32)).cuda()

    def filled():
        cache = make_cache(cfg, batch, max_len, device="cuda")
        g = torch.Generator("cuda").manual_seed(2)
        for a, b in (("dense_k", "dense_v"), ("k", "v")):  # the dense layers come first
            for i in range(cache[a].shape[0] if a in cache else 0):
                cache[a][i].normal_(generator=g)
                cache[b][i].normal_(generator=g)
        return cache

    cache, fill_s = generated(torch, filled)

    def step(use_kernel=None):
        cache["length"].copy_(lens_t)  # the update is in place: repeat the same step
        return decode_step(model, cfg, cache, tokens, use_kernel=use_kernel)[0]

    reset_launches()
    lk, first_ms = timed(torch, step)
    launches = launches_now()
    check(launches["decode_attention"] == cfg.n_layers,
          f"{phase}: K9 launched {launches['decode_attention']} times, not {cfg.n_layers}")
    check(tuple(lk.shape) == (batch, cfg.padded_vocab) and bool(torch.isfinite(lk).all()),
          f"{phase}: decode logits {tuple(lk.shape)} not finite or misshaped")
    check(cache["length"].tolist() == (lens + 1).tolist(), f"{phase}: lengths not advanced")
    wall = wall_ms(np, torch, step)
    profile = profiled(torch, step, wall["median"])
    lp = step(False)
    plain_wall = wall_ms(np, torch, lambda: step(False))
    dlogit = (lk - lp).abs().max().item()
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    live = int(lens.sum())
    kv_row = cfg.n_kv_heads * cfg.head_dim * 2 * cache["k"].element_size()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    emit(phase, batch=batch, max_len=max_len, lengths=lens.tolist(),
         cache_bytes=sum(t.numel() * t.element_size() for key, t in cache.items()
                         if key != "length"), fill_seconds=fill_s,
         launches=launches, first_call_ms=first_ms, wall_ms=wall, plain_wall_ms=plain_wall,
         profile=profile, max_abs_dlogit=dlogit, top1_agree=agree, rows=batch,
         k9_step_bound_ms=cfg.n_layers * live * kv_row / PEAK_BYTES * 1e3,
         weights_step_bound_ms=weight_bytes / PEAK_BYTES * 1e3)
    check_profile(phase, profile)
    row = k9_row(np, torch, phase, launches, cfg, cache, lens_t)
    del cache, lk, lp
    torch.cuda.empty_cache()
    return row, dlogit


def k9_row(np, torch, phase, launches, cfg, cache, lens_t) -> dict:
    """K9 at one layer's shapes (layer 0 of the decode cache) against its
    plain version; times beside SDPA with a length mask."""
    import torch.nn.functional as F

    _, k9 = _attention_modules()
    B, L, D = lens_t.numel(), cache["k"].shape[3], cfg.head_dim
    g = torch.Generator("cuda").manual_seed(3)
    q = torch.randn((B, cfg.n_heads, D), generator=g, device="cuda").to(cfg.dtype)
    k, v = cache["k"][0], cache["v"][0]
    cmp = _k9_compare(torch, k9.decode_attention_kernel(q, k, v, lens_t),
                      k9.decode_attention_plain(q, k, v, lens_t))
    check(_k9_ok(cmp, "bfloat16"), f"{phase}: K9 differs from its plain version: {cmp}")
    mask = (torch.arange(L, device="cuda")[None, :] < lens_t[:, None])[:, None, None, :]
    live = int(lens_t.sum())
    nbytes = 2.0 * live * cfg.n_kv_heads * D * k.element_size() + q.numel() * q.element_size() \
        + 4.0 * B * cfg.n_heads * (D + 2)
    flop = 4.0 * live * cfg.n_heads * D
    row = kernel_row(
        np, torch, "decode_attention", phase, launches, cmp,
        lambda: k9.decode_attention_kernel(q, k, v, lens_t),
        lambda: k9.decode_attention_plain(q, k, v, lens_t),
        lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                               scale=1.0 / D ** 0.5, enable_gqa=True),
        flop, nbytes)
    sp = k9.decode_split(L, D, batch=B, q_heads=cfg.n_heads, kv_heads=cfg.n_kv_heads)
    live_splits = sum(-(-min(n, L) // sp.split) for n in lens_t.tolist())
    row.update(shape=[B, cfg.n_heads, cfg.n_kv_heads, L, D], dtype="bfloat16",
               live_positions=live, m_err=cmp["m_err"], l_rel_err=cmp["l_rel_err"],
               per_step_bound_ms=row["bound_ms"] * launches["decode_attention"],
               split=sp.split, n_splits=sp.n_splits, grid=list(sp.grid),
               live_blocks=live_splits * cfg.n_kv_heads, scratch_bytes=sp.scratch_bytes)
    return row


def lm_server_phase(np, torch, phase, cfg, model, max_dlogit, *, requests=4, prompt=16,
                    gen=32, max_batch=8, max_len=512) -> None:
    from repro_torch.launch.serve import LMServer

    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (requests, prompt))

    class MarginServer(LMServer):
        """Records each step's token and the stepped slot's top-2 logit margin."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.stream, self.margins = [], []

        def step_token(self, slot, token):
            nxt = super().step_token(slot, token)
            top2 = self.last_logits[slot].topk(2).values
            self.stream.append(nxt)
            self.margins.append(float(top2[0] - top2[1]))
            return nxt

    def serve(srv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            srv.generate(srv.add_request(p), gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    steps = requests * (prompt + gen)
    srv = LMServer(cfg, max_batch=max_batch, max_len=max_len, params=model, device="cuda")
    reset_launches()
    dt = serve(srv)
    launches = launches_now()
    stream = [t for slot in range(requests) for t in srv.outputs[slot]]
    final_lengths = srv.cache["length"].tolist()
    profile = profiled(torch, lambda: srv.step_token(requests - 1, stream[-1]),  # one more
                       dt * 1e3 / steps)
    ref = MarginServer(cfg, max_batch=max_batch, max_len=max_len, params=model,
                       device="cuda", use_kernel=False)
    plain_dt = serve(ref)
    part = next((i for i, (a, b) in enumerate(zip(stream, ref.stream)) if a != b), None)
    margin = None if part is None else ref.margins[part]
    emit(phase, requests=requests, prompt_tokens=prompt, generated_tokens=gen, steps=steps,
         seconds=dt, tokens_per_s=steps / dt, generated_tokens_per_s=requests * gen / dt,
         ms_per_step=dt * 1e3 / steps, launches=launches,
         k9_launches_per_step=launches["decode_attention"] / steps,
         final_lengths=final_lengths, step_profile=profile,
         plain_seconds=plain_dt, plain_ms_per_step=plain_dt * 1e3 / steps,
         streams_equal=part is None, parted_at_step=part, plain_top2_margin_there=margin,
         decode_max_abs_dlogit=max_dlogit)
    check_profile(phase, profile)
    check(launches["decode_attention"] == cfg.n_layers * steps,
          f"{phase}: K9 launched {launches['decode_attention']} times in {steps} steps")
    check(len(stream) == steps and len(ref.stream) == steps, f"{phase}: stream lengths")
    check(final_lengths == [steps] * max_batch,
          f"{phase}: every slot must advance on every step")
    check(part is None or margin <= max_dlogit,
          f"{phase}: streams part at step {part} where the plain margin {margin} exceeds "
          f"the decode phase's largest |Δlogit| {max_dlogit}")


# ---------------------------------------------------------------------------
# The MLA and MoE LM families at full width, and qwen3-8b
# ---------------------------------------------------------------------------

CUT_LAYERS = 4  # depth of the f32 copies that hold the kernel path to the plain one


def zoo_model(torch, arch: str, *, n_layers: int | None = None, dtype=None):
    """``arch``'s full config (bf16) with weights from seed 0 on the card, or
    a cut of it (``n_layers`` at full width, ``dtype``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import (
        count_active_params, count_params, init_transformer,
    )

    cfg = get_arch(arch).make_config()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model, init_s = generated(torch, lambda: init_transformer(
        cfg, generator=torch.Generator("cuda").manual_seed(0), device="cuda"))
    n = count_params(cfg)
    check(n == sum(p.numel() for p in model.parameters()), f"{arch}: parameter count")
    emit("lm_model", config=cfg.name, n_layers=cfg.n_layers, dtype=_dtype_name(torch, cfg.dtype),
         params=n, active_params=count_active_params(cfg),
         weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
         init_seconds=init_s)
    return cfg, model


def _moe_drops(stats) -> list:
    return [float(s.dropped_frac) for s in stats]


def zoo_prefill_phase(np, torch, phase, arch, cfg, model, *, batch=2, seq=4096) -> dict:
    """``prefill`` of a full-width model through K8 (padded for MLA), counted,
    against ``use_kernel=False`` in bf16 (printed: the paths part at bf16's
    rounding noise, and an MoE router's choice can flip on it); then the
    same at ``CUT_LAYERS`` layers in f32, held: ``transformer_logits`` top-1
    equal on all but 2 of the positions with |Δlogit| ≤ 1e-4 (dense), on
    99 % of them (MoE: a routing near-tie may flip on an f32 last bit).
    Returns K8's row at one layer's shapes."""
    from repro_torch.models.transformer import prefill, transformer_logits

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)).cuda()
    stats, plain_stats = [], []
    reset_launches()
    logits, first_ms = timed(torch, lambda: prefill(model, cfg, tokens, moe_stats=stats))
    launches = launches_now()
    check(launches["flash_attention"] == cfg.n_layers,
          f"{phase}: K8 launched {launches['flash_attention']} times, not {cfg.n_layers}")
    check(tuple(logits.shape) == (batch, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          f"{phase}: prefill logits {tuple(logits.shape)} not finite or misshaped")
    wall = wall_ms(np, torch, lambda: prefill(model, cfg, tokens), reps=3)
    profile = profiled(torch, lambda: prefill(model, cfg, tokens), wall["median"])
    plain = prefill(model, cfg, tokens, use_kernel=False, moe_stats=plain_stats)
    plain_wall = wall_ms(np, torch, lambda: prefill(model, cfg, tokens, use_kernel=False),
                         reps=2)
    bf16 = dict(max_abs_dlogit=(logits - plain).abs().max().item(),
                top1_equal=int((logits.argmax(-1) == plain.argmax(-1)).sum()), rows=batch)
    del logits, plain
    torch.cuda.empty_cache()

    moe = {}
    if cfg.moe:  # one MoE layer alone at the prefill's token count, its share of the wall
        from repro_torch.models.moe import moe_ffn

        x = torch.randn((batch * seq, cfg.d_model), generator=torch.Generator("cuda").manual_seed(4),
                        device="cuda").to(cfg.dtype)
        layer_ms = time_ms(np, torch, lambda: moe_ffn(
            model.layers[0].ffn.moe, x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor))
        moe = dict(layer_ms=layer_ms, layers=len(model.layers),
                   share_of_wall=layer_ms * len(model.layers) / wall["median"])
        del x

    cut, m32 = zoo_model(torch, arch, n_layers=CUT_LAYERS, dtype=torch.float32)
    lk = transformer_logits(m32, cut, tokens)
    lp = transformer_logits(m32, cut, tokens, use_kernel=False)
    n = batch * seq
    f32 = dict(layers=CUT_LAYERS, top1_agree=_top1(lk, lp), max_abs_dlogit=_max_dlogit(lk, lp),
               finite=bool(torch.isfinite(lk).all()))
    del m32, lk, lp
    torch.cuda.empty_cache()
    emit(phase, batch=batch, seq=seq, launches=launches, first_call_ms=first_ms,
         wall_ms=wall, plain_wall_ms=plain_wall, profile=profile, bf16=bf16, f32_cut=f32,
         positions=n, moe_dropped_frac=_moe_drops(stats),
         moe_dropped_frac_plain=_moe_drops(plain_stats), moe_ffn=moe)
    check_profile(phase, profile)
    check(f32["finite"], f"{phase}: f32 logits not finite")
    if cfg.moe:
        check(f32["top1_agree"] >= 0.99 * n, f"{phase}: f32 top-1 agreement {f32}")
    else:
        check(f32["top1_agree"] >= n - 2 and f32["max_abs_dlogit"] <= 1e-4,
              f"{phase}: f32 top-1 agreement or |Δlogit| {f32}")
    if cfg.attention == "mla":
        return k8_mla_row(np, torch, phase, launches, batch, cfg, seq)
    return k8_row(np, torch, phase, launches, batch, cfg.n_heads, cfg.n_kv_heads, seq,
                  cfg.head_dim)


def k8_mla_row(np, torch, phase, launches, B, cfg, S) -> dict:
    """K8 as MLA's prefill calls it (``transformer._mla_flash``): q and k of
    width ``qk_head_dim``, v of ``v_head_dim``, zero-padded to K8's head dim
    and scaled by 1/√qk_head_dim, against its plain version on the same
    padded inputs; SDPA on the unpadded ones. The bound counts the unpadded
    work: the products of the real widths, q, k, v and the output once."""
    import torch.nn.functional as F

    k8, _ = _attention_modules()
    H, dqk, dv = cfg.n_heads, cfg.qk_head_dim, cfg.v_dim
    D = next(d for d in k8.HEAD_DIMS if d >= max(dqk, dv))
    g = torch.Generator("cuda").manual_seed(1)
    q32, k32 = (torch.randn((B, H, S, dqk), generator=g, device="cuda") for _ in range(2))
    v32 = torch.randn((B, H, S, dv), generator=g, device="cuda")
    scale = 1.0 / dqk ** 0.5

    def padded(dtype):
        return tuple(F.pad(a.to(dtype), (0, D - a.shape[-1])).contiguous()
                     for a in (q32, k32, v32))

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = padded(dtype)
        got = k8.flash_attention_kernel(q, k, v, scale=scale)
        want = k8.flash_attention_plain(q, k, v, scale=scale)
        dn = _dtype_name(torch, dtype)
        errs[dn] = (got.float() - want.float()).abs().max().item()
        check(errs[dn] <= LM_ATOL[dn] and not got[..., dv:].any(),
              f"{phase}: padded K8 differs from its plain version in {dn}: {errs[dn]}")
        del got, want
    p32 = padded(torch.float32)
    ms_f32 = time_ms(np, torch, lambda: k8.flash_attention_kernel(*p32, scale=scale))
    library_ms_f32 = time_ms(np, torch, lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True, scale=scale))
    del p32
    q, k, v = padded(torch.bfloat16)
    qb, kb, vb = (a.to(torch.bfloat16) for a in (q32, k32, v32))
    flop = 2.0 * (dqk + dv) * (S * (S + 1) / 2) * B * H
    nbytes = 2.0 * B * H * S * (2 * dqk + 2 * dv)
    row = kernel_row(
        np, torch, "flash_attention", phase, launches, dict(max_abs_err=errs["bfloat16"]),
        lambda: k8.flash_attention_kernel(q, k, v, scale=scale),
        lambda: k8.flash_attention_plain(q, k, v, scale=scale),
        lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True, scale=scale),
        flop, nbytes, peak=PEAK_BF16_TC_FLOPS)
    row.update(shape=[B, H, H, S, D], unpadded_dims=[dqk, dv], dtype="bfloat16",
               max_abs_err_f32=errs["float32"], ms_f32=ms_f32,
               bound_ms_f32=bound(flop, 2 * nbytes)[0], library_ms_f32=library_ms_f32,
               per_prefill_bound_ms=row["bound_ms"] * launches["flash_attention"])
    return row


def mla_decode_phase(np, torch, phase, arch, cfg, model, *, batch=8, max_len=32768) -> None:
    """MLA's absorbed decode (plain torch products, no kernel by design) over
    a seeded random latent cache of ``batch`` × ``max_len`` positions: the
    step's wall and device profile, no kernel launched. Then the absorbed
    decode against the explicit prefill path (K8, padded) over the same
    tokens at a short length: fed step by step from an empty cache, each
    step's logits against ``transformer_logits`` at that position, printed
    at full depth in bf16 and held at ``CUT_LAYERS`` layers in f32 (atol
    5e-4, rtol 5e-3: the CPU tests' decode-against-forward tolerance)."""
    from repro_torch.models.transformer import decode_step, make_cache, transformer_logits

    rng = np.random.default_rng(0)
    lens = rng.integers(1, max_len, size=batch)
    lens[0] = max_len - 1
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, batch).astype(np.int32)).cuda()
    lens_t = torch.from_numpy(lens.astype(np.int32)).cuda()

    def filled():
        cache = make_cache(cfg, batch, max_len, device="cuda")
        g = torch.Generator("cuda").manual_seed(2)
        for i in range(cache["c_kv"].shape[0]):
            cache["c_kv"][i].normal_(generator=g)
            cache["k_pe"][i].normal_(generator=g)
        return cache

    cache, fill_s = generated(torch, filled)

    def step(use_kernel=None):
        cache["length"].copy_(lens_t)
        return decode_step(model, cfg, cache, tokens, use_kernel=use_kernel)[0]

    reset_launches()
    lk, first_ms = timed(torch, step)
    launches = launches_now()
    check(not any(launches.values()), f"{phase}: MLA decode launched a kernel: {launches}")
    check(tuple(lk.shape) == (batch, cfg.padded_vocab) and bool(torch.isfinite(lk).all()),
          f"{phase}: decode logits {tuple(lk.shape)} not finite or misshaped")
    wall = wall_ms(np, torch, step, reps=3)
    profile = profiled(torch, step, wall["median"], kernels={})
    cache_bytes = sum(t.numel() * t.element_size() for key, t in cache.items()
                      if key != "length")
    live_bytes = int(lens.sum()) * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 * cfg.n_layers
    del cache, lk
    torch.cuda.empty_cache()

    def absorbed_vs_explicit(c, m, steps=32):
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, c.vocab_size, (2, steps)).astype(np.int32)).cuda()
        full = transformer_logits(m, c, toks).float()
        short = make_cache(c, 2, steps, device="cuda")
        got = torch.stack([decode_step(m, c, short, toks[:, i])[0] for i in range(steps)], 1)
        excess = ((got - full).abs() - (5e-4 + 5e-3 * full.abs())).max().item()
        return dict(steps=steps, max_abs_dlogit=(got - full).abs().max().item(),
                    top1_agree=_top1(got, full), positions=2 * steps, tol_excess=excess)

    bf16 = absorbed_vs_explicit(cfg, model)
    cut, m32 = zoo_model(torch, arch, n_layers=CUT_LAYERS, dtype=torch.float32)
    f32 = absorbed_vs_explicit(cut, m32)
    del m32
    torch.cuda.empty_cache()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    emit(phase, batch=batch, max_len=max_len, lengths=lens.tolist(), cache_bytes=cache_bytes,
         fill_seconds=fill_s, launches=launches, first_call_ms=first_ms, wall_ms=wall,
         profile=profile, kernel="none by design (absorbed latent attention, plain torch)",
         latent_step_bound_ms=live_bytes / PEAK_BYTES * 1e3,
         weights_step_bound_ms=weight_bytes / PEAK_BYTES * 1e3,
         absorbed_vs_explicit_bf16=bf16, absorbed_vs_explicit_f32_cut=f32)
    check(f32["tol_excess"] <= 0 and f32["top1_agree"] == f32["positions"],
          f"{phase}: absorbed decode parts from the explicit path in f32: {f32}")


def decode_dlogit(np, torch, cfg, model, *, batch=8, max_len=512) -> float:
    """The largest |Δlogit| of one GQA decode step, K9 against the plain
    path, over a seeded random cache: the server phase's tie bound where no
    decode phase ran."""
    from repro_torch.models.transformer import decode_step, make_cache

    cache = make_cache(cfg, batch, max_len, device="cuda")
    g = torch.Generator("cuda").manual_seed(2)
    for key, t in cache.items():
        if key != "length":
            t.normal_(generator=g)
    lens = torch.from_numpy(np.random.default_rng(0).integers(
        1, max_len, size=batch).astype(np.int32)).cuda()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, batch).astype(np.int32)).cuda()
    out = []
    for use in (None, False):
        cache["length"].copy_(lens)
        out.append(decode_step(model, cfg, cache, tokens, use_kernel=use)[0])
    del cache
    torch.cuda.empty_cache()
    return (out[0] - out[1]).abs().max().item()


def lm_zoo_phases(np, torch) -> list:
    """The three new families at full width, one model on the card at a
    time: minicpm3-4b (MLA: prefill through padded K8, the absorbed decode
    at a 32k latent cache), deepseek-moe-16b (prefill, an 8k decode
    through K9, a server) and qwen3-8b (prefill, a server)."""
    rows = []
    cfg, model = zoo_model(torch, "minicpm3-4b")
    rows.append(zoo_prefill_phase(np, torch, "lm_prefill_minicpm3_4b", "minicpm3-4b", cfg,
                                  model))
    mla_decode_phase(np, torch, "lm_decode_minicpm3_4b_32k", "minicpm3-4b", cfg, model)
    del model
    torch.cuda.empty_cache()

    cfg, model = zoo_model(torch, "deepseek-moe-16b")
    rows.append(zoo_prefill_phase(np, torch, "lm_prefill_deepseek_moe_16b",
                                  "deepseek-moe-16b", cfg, model))
    row, max_dlogit = lm_decode_phase(np, torch, "lm_decode_deepseek_moe_16b_8k", cfg, model,
                                      max_len=8192)
    rows.append(row)
    lm_server_phase(np, torch, "lm_server_deepseek_moe_16b", cfg, model, max_dlogit,
                    requests=2, prompt=8, gen=16)
    del model
    torch.cuda.empty_cache()

    cfg, model = zoo_model(torch, "qwen3-8b")
    rows.append(zoo_prefill_phase(np, torch, "lm_prefill_qwen3_8b", "qwen3-8b", cfg, model))
    lm_server_phase(np, torch, "lm_server_qwen3_8b", cfg, model,
                    decode_dlogit(np, torch, cfg, model), requests=2, prompt=8, gen=16)
    del model
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Near-duplicate detection and the paper's own cells
# ---------------------------------------------------------------------------

DEDUP = dict(planted=512, threshold=0.95, noise=0.01, seed=5)


def dedup_phase(np, torch, phase, radikal) -> dict:
    """``dedup_corpus`` (K1 on the card) on radikal plus ``DEDUP["planted"]``
    perturbed copies of its rows (each nonzero × (1 + 0.01 · U[0, 1))),
    against ``use_kernel=False``: equal ``keep`` and ``duplicate_of``, every
    planted row dropped for a kept row. K1 at the join's shapes against its
    plain version for the ``kernels`` line."""
    from repro_torch.core.apss import normalize_rows
    from repro_torch.data import dedup_corpus
    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block import fused
    from repro_torch.kernels.apss_block.ops import _padded_pair, _pick_bk

    n, m = radikal.shape
    t, k = DEDUP["threshold"], 64
    rng = np.random.default_rng(DEDUP["seed"])
    src = np.sort(rng.choice(n, DEDUP["planted"], replace=False))
    X, gen_s = generated(torch, lambda: torch.from_numpy(np.concatenate([
        radikal, radikal[src] * (1 + DEDUP["noise"] * rng.random((len(src), m),
                                                                  dtype=np.float32))])).cuda())
    reset_launches()
    (keep, dup_of), first_ms = timed(torch, lambda: dedup_corpus(X))
    launches = launches_now()
    check(launches["apss_fused"] == 1, f"{phase}: K1 launched {launches['apss_fused']} times")
    (pkeep, pdup), plain_first_ms = timed(torch, lambda: dedup_corpus(X, use_kernel=False))
    wall = wall_ms(np, torch, lambda: dedup_corpus(X), reps=3)
    plain_wall = wall_ms(np, torch, lambda: dedup_corpus(X, use_kernel=False), reps=3)
    planted = np.arange(n, n + len(src))
    emit(phase, n=int(X.shape[0]), m=m, threshold=t, k=k, planted=len(src),
         corpus_seconds=gen_s, launches=launches, first_call_ms=first_ms,
         plain_first_call_ms=plain_first_ms, wall_ms=wall, plain_wall_ms=plain_wall,
         dropped=int((~keep).sum()), dropped_original=int((~keep[:n]).sum()),
         planted_dropped=int((~keep[planted]).sum()),
         planted_to_source=int((dup_of[planted] == src).sum()),
         equal_to_plain=bool(np.array_equal(keep, pkeep) and np.array_equal(dup_of, pdup)))
    check(np.array_equal(keep, pkeep) and np.array_equal(dup_of, pdup),
          f"{phase}: K1's keep/duplicate_of differ from the plain path's")
    check(not keep[planted].any() and keep[dup_of[planted]].all(),
          f"{phase}: a planted row kept, or dropped for a dropped row")

    Dn = normalize_rows(X)
    del X
    _, _, Dp, _, mask = _padded_pair(Dn, Dn, t, None, True, 256, 256, _pick_bk(m, 512),
                                     Dn.device)
    near = near_threshold_counts(torch, Dn, t)
    N = Dn.shape[0]
    near_p = np.concatenate([near, np.zeros(Dp.shape[0] - N, near.dtype)])
    kw = dict(block_m=256, block_n=256, n_valid_cols=N, exclude_self=True)
    out_k = fused.apss_fused_kernel(Dp, Dp, mask, t, k, **kw)
    out_p = fused.apss_fused_plain(Dp, Dp, mask, t, k, **kw)
    cmp = compare(np, as_rows(np, *out_k), as_rows(np, *out_p), t, near_p)
    check(cmp["ok"], f"{phase}: K1 disagrees with its plain version: {cmp}")
    grid = Dp.shape[0] // 256
    valid = np.minimum(256, N - np.arange(grid) * 256)
    mk = mask.cpu().numpy()
    flop = 2.0 * m * float((mk * np.outer(valid, valid)).sum())
    nbytes = 4.0 * N * m + N * (8 * k + 4) + mk.size
    del out_k, out_p
    row = kernel_row(
        np, torch, "apss_fused", phase, launches, cmp,
        lambda: fused.apss_fused_kernel(Dp, Dp, mask, t, k, **kw),
        lambda: fused.apss_fused_plain(Dp, Dp, mask, t, k, **kw),
        lambda: library_topk(torch, Dn, t, k), flop, nbytes)
    segments = fused.fused_segments_for(Dp, Dp.shape[0], k)
    row.update(segments=segments, grid=[-(-Dp.shape[0] // fused.FUSED_TILE), segments],
               merge_grid=-(-Dp.shape[0] // 8) if segments > 1 else 0,
               slots=fused.fused_capacity(Dp.dtype, k, Dp.device),
               live_tiles=int(mk.sum()), total_tiles=int(mk.size))
    del Dn, Dp
    torch.cuda.empty_cache()
    return row


APSS_PAPER_ROOT = ROOT / "build" / "apss_paper"  # the cells' corpora, on local disk
APSS_WIKI_ROWS = 1024  # wikipedia's n, cut to fit the card's 80 GB (its m stays full)
APSS_WIKI_PLANTED = 64  # of them near duplicates: a random Zipf corpus has no pair at 0.9
APSS_20NEWS_PLANTED = 256  # near duplicates in 20news's padding rows (none pair at 0.4 else)


def _with_near_duplicates(np, torch, sp, count: int, seed: int):
    """``sp`` with ``count`` more rows: copies of random rows whose values are
    scaled by 1 + 0.1 · U[0, 1) and renormalized (cosine about 0.99)."""
    from repro_torch.core.sparse import SparseCorpus

    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.choice(sp.n, count, replace=False))
    vals = sp.values[src] * (1 + 0.1 * torch.from_numpy(rng.random((count, sp.cap),
                                                                   dtype=np.float32)))
    vals = vals / vals.norm(dim=1, keepdim=True)
    return SparseCorpus(torch.cat([sp.indices, sp.indices[src]]), torch.cat([sp.values, vals]),
                        torch.cat([sp.nnz, sp.nnz[src]]), sp.m)


def _padded_sparse(torch, sp, n: int, m: int):
    """``sp`` with zero rows up to ``n`` and zero columns up to ``m``."""
    from repro_torch.core.sparse import SparseCorpus

    z = sp.indices.new_zeros((n - sp.n, sp.cap))
    return SparseCorpus(torch.cat([sp.indices, z]), torch.cat([sp.values, z.float()]),
                        torch.cat([sp.nnz, z[:, 0]]), m)


def apss_paper_phase(np, torch, phase) -> None:
    """The paper's cells (``configs.apss_paper``, the ``apss`` arch) in 4
    ranks on the one card over gloo (``launch.apss_mesh.run_cells``). The
    corpora come from ``data.sparse.sparse_zipfian_bulk`` at
    ``PAPER_DATASETS``' n, m and nnz per row, zero-padded to the config's
    shapes, and go to the ranks in CSR: each rank densifies only its own
    cell on the card (``core.sparse.DenseView``). ``v_compressed`` runs at
    the full 20news scale (20,480 × 315,392 f32: four 6.45 GB column
    slices); ``h_allgather``, ``h_ring`` and ``grid_2d`` at wikipedia's m
    with n cut to ``APSS_WIKI_ROWS``, ``APSS_WIKI_PLANTED`` of them near
    duplicates of others (else nothing would match at t = 0.9); 20news
    gets ``APSS_20NEWS_PLANTED`` near duplicates in its padding rows (its
    generated rows hold no pair at t = 0.4). After the
    ranks exit, each result is
    held under the comparison rule to a single-device ``apss_blocked`` on
    the card (the plain path, as the cells run). The full configs are
    built on the meta device."""
    from repro_torch.configs import get_arch
    from repro_torch.core.apss import apss_blocked
    from repro_torch.core.sparse import DenseView
    from repro_torch.data.sparse import sparse_zipfian_bulk
    from repro_torch.data.synthetic import PAPER_DATASETS
    from repro_torch.interop import matches_to_numpy
    from repro_torch.launch.mesh import spawn

    arch = get_arch("apss")
    full = arch.make_config()
    meta = {}
    for name in arch.shapes:
        b = arch.cell(name).build(full, {"data": 2, "model": 2})
        (D,) = b.args
        meta[name] = dict(shape=list(D.shape), dtype=str(D.dtype), device=D.device.type,
                          bytes=D.numel() * D.element_size(), spec=b.in_shardings[0],
                          static_info=b.static_info)
    cfg = dict(full)
    cfg["wikipedia"] = dict(full["wikipedia"], n=APSS_WIKI_ROWS)
    APSS_PAPER_ROOT.mkdir(parents=True, exist_ok=True)
    corpora = {}
    t0 = time.perf_counter()
    for data, spec, n_real, planted, seed in (
            ("20news", cfg["20news"], PAPER_DATASETS["20-newsgroups"]["n"],
             APSS_20NEWS_PLANTED, 0),
            ("wikipedia", cfg["wikipedia"], APSS_WIKI_ROWS - APSS_WIKI_PLANTED,
             APSS_WIKI_PLANTED, 1)):
        paper = PAPER_DATASETS["20-newsgroups" if data == "20news" else "wikipedia"]
        sp = sparse_zipfian_bulk(n_real, paper["m"], paper["nnz"] / paper["n"], seed=seed,
                                 device="cpu")
        if planted:
            sp = _with_near_duplicates(np, torch, sp, planted, seed)
        sp = _padded_sparse(torch, sp, spec["n"], spec["m"])
        path = APSS_PAPER_ROOT / f"{data}.npz"
        np.savez(path, indices=sp.indices.numpy(), values=sp.values.numpy(),
                 nnz=sp.nnz.numpy(), m=sp.m)
        corpora[data] = (sp, str(path))
    gen_s = time.perf_counter() - t0
    cells = [("v_compressed", corpora["20news"][1])] + [
        (name, corpora["wikipedia"][1]) for name in ("h_allgather", "h_ring", "grid_2d")]
    t0 = time.perf_counter()
    ranks = spawn("repro_torch.launch.apss_mesh:run_cells", 4, cells, cfg, device="cuda",
                  threads=2, run_dir=str(APSS_PAPER_ROOT))
    ranks_s = time.perf_counter() - t0
    results = {}
    for data, names in (("20news", ["v_compressed"]),
                        ("wikipedia", ["h_allgather", "h_ring", "grid_2d"])):
        sp = corpora[data][0]
        t = cfg[data]["t"]
        D, dense_s = generated(torch, lambda: DenseView(sp).dense_cell(
            slice(None), slice(None), "cuda"))
        ref, single_ms = timed(torch, lambda: apss_blocked(D, t, 64, block_rows=512,
                                                           device=D.device))
        ref = matches_to_numpy(ref)
        near = near_threshold_counts(torch, D, t)
        for name in names:
            cmp = compare(np, ranks[0][name]["matches"], ref, t, near)
            results[name] = dict(
                n=sp.n, m=sp.m, threshold=t, cap=sp.cap, dense_bytes=D.numel() * 4,
                rank_wall_s=[r[name]["wall_s"] for r in ranks],
                rank_wire_s=[r[name]["wire_s"] for r in ranks],
                rank_wire_bytes=[r[name]["wire_bytes"] for r in ranks],
                matches=int(ref[2].sum()), single_device_ms=single_ms,
                densify_s=dense_s, vs_single=cmp)
        del D
        torch.cuda.empty_cache()
    emit(phase, corpus_seconds=gen_s, ranks_seconds=ranks_s, cells=results,
         full_config_meta_builds=meta)
    for name, r in results.items():
        check(r["vs_single"]["ok"], f"{phase}: {name} disagrees with the single-device "
              f"apss_blocked: {r['vs_single']}")


# ---------------------------------------------------------------------------
# The paper's distributions: 4 ranks on one card (core.distributed)
# ---------------------------------------------------------------------------

DIST_REPS = 2  # wall-clock runs of each variant (median); the first is profiled


# ---------------------------------------------------------------------------
# The execution planner
# ---------------------------------------------------------------------------

PLAN_SLOW_MS = 5000.0  # a candidate whose warm-up takes longer is timed by it alone
# The calibration's sizes. Its matmul rate is the slope between the plain
# join at depths m and m/8. At n = m = 4096 the per-score extraction
# swamped the depth's share, and two runs of this script on an NVIDIA H100
# 80GB HBM3 at 700 W fitted 105,454 and 556,670 GF/s, above the card's f32
# peak. At m = 32768 the depth is most of the join, and 10 runs a point
# tame the host clock.
CALIBRATION = dict(n=2048, m=32768, cap=64, m_sparse=16384, iters=10)


def smi_name_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def record_summary(r, ms: float) -> dict:
    """A telemetry record of a call that took ``ms``: its live fraction,
    modeled FLOPs and FLOPs per measured second."""
    return dict(variant=r.variant, n=r.n, m=r.m, block_rows=r.block_rows,
                live_fraction=r.live_fraction, flops=r.flops, wire_bytes=r.wire_bytes,
                flops_per_s=r.flops / (ms / 1e3) if ms > 0 else None, ms=ms)


def planner_auto_phase(np, torch, phase, cells, served, residuals, *, k):
    """The execution planner (``repro_torch.planner``) on the card.

    Calibrates (``calibrate(**CALIBRATION)``, cached under
    ``build/calibration``) and prints the profile beside the card's name
    and power limit. Per cell (``cells``: the dense corpus, its
    CSR form or None, the phase's plain result and near-threshold counts,
    the threshold): ``plan_apss`` with the kernel candidates the card
    offers, its ranking printed (``describe``); one config of each (kind,
    sparse, use_kernel) is timed through the planner's ``execute`` on the
    prepared representation (the chosen config for its own group, the
    largest block for the others: the plain paths' Python loops run the
    fewest blocks there), median of 3 after a warm-up (a candidate whose
    warm-up takes over ``PLAN_SLOW_MS`` by that run alone), each kernel
    candidate launching its kernel (K1, K3) and no plain one; predicted against measured, their ratio, and whether the
    chosen config lands within 2x of the best measured (printed, not
    gated). ``plan.run()`` under a telemetry log is held to the phase's
    plain result by ``compare()``, and its records printed (live fraction,
    modeled FLOPs, FLOPs per measured second). Then ``query_topk(plan=
    "auto")`` on ``served``'s dense index at B = 64 and 8 and on its CSR
    index: each plan chooses the kernel, K4 or K6 launches, and the result
    equals its phase's fixed K4 or K6 result and agrees with the oracle.
    Each ``plan.run()`` runs under an ``obs.Tracer`` too; its drift
    residuals against the profile go to ``residuals``. Returns the
    profile."""
    import functools
    import os
    import statistics

    from repro_torch.core.sparse import from_dense
    from repro_torch.interop import matches_to_numpy
    from repro_torch.obs import Tracer, drift
    from repro_torch.planner import CommLog, execute, plan_apss, plan_query_topk
    from repro_torch.planner import calibrate as cal
    from repro_torch.serving import query_topk

    t_phase = time.perf_counter()
    os.environ["REPRO_CALIB_DIR"] = str(ROOT / "build" / "calibration")  # ranks inherit it
    cal._MEMO.clear()
    profile, calib_s = generated(torch, lambda: cal.calibrate(**CALIBRATION))
    emit(f"{phase}/calibration", seconds=calib_s, nvidia_smi=smi_name_power(),
         path=str(cal.profile_path().relative_to(ROOT)), profile=dataclasses.asdict(profile))
    kernel_of = {False: "apss_fused", True: "sparse_tile_candidates"}
    for cell, c in cells.items():
        D, t = c["D"], c["threshold"]
        plan, plan_s = generated(torch, lambda: plan_apss(D, t, k))
        print(plan.describe(top=len(plan.estimates)), flush=True)
        data = {False: D}
        if any(e.config.sparse for e in plan.estimates):
            data[True] = c["sp"] if c["sp"] is not None else from_dense(D, device=D.device)
        groups = {}  # (kind, sparse, use_kernel) -> the estimate timed for it
        for e in plan.estimates:
            key = (e.config.kind, e.config.sparse, e.config.use_kernel)
            if key not in groups or (groups[key] is not plan.cost
                                     and e.config.block_rows > groups[key].config.block_rows):
                groups[key] = e
        cands, failed = [], []
        for e in sorted(groups.values(), key=plan.estimates.index):
            cfg = e.config
            fn = functools.partial(execute, cfg, data[cfg.sparse], t, k, prepared=True)
            reset_launches()
            _, warm_ms = timed(torch, fn)
            runs = [warm_ms] if warm_ms > PLAN_SLOW_MS else [timed(torch, fn)[1]
                                                             for _ in range(3)]
            launched = launches_now()[kernel_of[cfg.sparse]]
            if (launched > 0) != cfg.use_kernel:
                failed.append(f"{cfg.name} launched {kernel_of[cfg.sparse]} {launched} times")
            e.measured_s = statistics.median(runs) / 1e3
            cands.append(dict(config=cfg.name, predicted_ms=e.total_s * 1e3,
                              measured_ms=e.measured_s * 1e3,
                              predicted_over_measured=e.total_s / e.measured_s,
                              runs_ms=runs, warmup_ms=warm_ms,
                              kernel_launches=launched))
        best = min(cands, key=lambda x: x["measured_ms"])
        chosen = cands[0]  # the plan's config ranks first and is timed itself
        reset_launches()
        with CommLog() as log, Tracer() as tr:
            res, run_ms = timed(torch, plan.run)
        residuals += drift.residuals_from_trace(tr, profile)
        cmp = compare(np, matches_to_numpy(res), c["single"]["ref"], t, c["single"]["near"])
        emit(f"{phase}/{cell}", threshold=t, k=k, chosen=plan.config.name, plan_s=plan_s,
             summary=plan.summary.as_dict(), candidates=cands, best=best["config"],
             chosen_ms=chosen["measured_ms"], best_ms=best["measured_ms"],
             chosen_within_2x_of_best=chosen["measured_ms"] <= 2 * best["measured_ms"],
             run_ms=run_ms, run_launches=launches_now(), vs_plain=cmp,
             records=[record_summary(r, run_ms) for r in log.records])
        check(chosen["config"] == plan.config.name, f"{phase}/{cell}: ranking and timing differ")
        check(not failed, f"{phase}/{cell}: " + "; ".join(failed))
        check(cmp["ok"], f"{phase}/{cell}: plan.run() disagrees with the plain path: {cmp}")
        del data, res

    t = cells["radikal_full"]["threshold"]
    Q, near = served["Q"], served["near"]
    queries = {  # name: (index, batch, the phase's fixed result, kernel)
        "dense_b64": (served["dense"], 64, served["k4_b64"], "rect_tile_candidates"),
        "dense_b8": (served["dense"], 8, served["k4_b8"], "rect_tile_candidates"),
        "csr_b64": (served["spidx"], 64, served["k6_b64"], "rect_sparse_tile_candidates"),
    }
    for name, (index, B, fixed, kname) in queries.items():
        qplan = plan_query_topk(index, B, t, k)

        def call():
            return query_topk(index, Q[:B], t, k, plan="auto")

        reset_launches()
        with CommLog() as log:
            got, first_ms = timed(torch, call)
        launched = launches_now()[kname]
        g = matches_to_numpy(got)
        vs_fixed = compare(np, g, fixed, t, near[:B])
        vs_oracle = compare(np, g, tuple(a[:B] for a in served["oracle"]), t, near[:B])
        emit(f"{phase}/query_{name}", batch=B, plan=qplan.as_dict(), launches={kname: launched},
             identical_to_fixed=identical(np, g, fixed), vs_fixed=vs_fixed,
             vs_oracle=vs_oracle, first_call_ms=first_ms, wall_ms=wall_ms(np, torch, call),
             records=[record_summary(r, first_ms) for r in log.records])
        check(qplan.use_kernel, f"{phase}/query_{name}: the plan did not choose the kernel")
        check(launched > 0, f"{phase}/query_{name}: {kname} never ran")
        check(vs_fixed["ok"] and vs_oracle["ok"],
              f"{phase}/query_{name}: planned query disagrees: {vs_fixed} {vs_oracle}")
    emit(f"{phase}/done", seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return profile


def dist_variants(capacity4: int, capacity2: int) -> list:
    """Every variant of the distributed phase, dense then sparse, as
    ``launch.apss_mesh`` variants."""
    row, pods = ((4,), ("data",)), ((2, 2), ("pod", "data"))
    model, grid = ((4,), ("model",)), ((2, 2), ("data", "model"))
    out = []
    for corpus in ("dense", "sparse"):
        kern = dict(use_kernel=True) if corpus == "dense" else {}
        for s in ("allgather", "ring", "halfring"):
            out.append(dict(name=f"{corpus}_horizontal_{s}", distribution="horizontal",
                            mesh=row, corpus=corpus, gather="data",
                            kwargs=dict(schedule=s, block_rows=512, **kern)))
        out.append(dict(name=f"{corpus}_hierarchical", distribution="hierarchical",
                        mesh=pods, corpus=corpus, gather=("pod", "data"),
                        kwargs=dict(axes=("pod", "data"), block_rows=512, **kern)))
        for a in ("allreduce", "scatter", "compressed", "recursive"):
            out.append(dict(name=f"{corpus}_vertical_{a}", distribution="vertical",
                            mesh=model, corpus=corpus,
                            gather="model" if a == "scatter" else None, scatter=a == "scatter",
                            kwargs=dict(axis_name="model", accumulation=a, block_rows=512,
                                        candidate_capacity=capacity4, return_stats=True)))
        for a in ("allreduce", "compressed"):
            out.append(dict(name=f"{corpus}_2d_{a}", distribution="2d", mesh=grid,
                            corpus=corpus, gather="data",
                            kwargs=dict(accumulation=a, block_rows=512,
                                        candidate_capacity=capacity2, return_stats=True)))
    # The planner's choice on the sparse corpus (the dense one exceeds
    # MAX_DENSIFY_BYTES, so only sparse configs are candidates), after
    # calibrate(mesh) in the ranks.
    out.append(dict(name="sparse_auto", distribution="auto", mesh=row, corpus="sparse",
                    kwargs={}, calibrate=CALIBRATION))
    return out


def candidate_capacity(torch, D, t: float, p: int, rows: int = 512) -> int:
    """The largest number of columns of a row that any of ``p`` dimension
    slices proposes at the Lemma-1 threshold ``t/p`` (self included). Every
    candidate set of the compressed and recursive accumulations is a subset,
    so a capacity this large truncates none."""
    from repro_torch.core.precision import dot_f32
    from repro_torch.core.pruning import local_threshold

    t_loc = float(local_threshold(t, p))
    w = D.shape[1] // p
    most = 0
    for b in range(0, D.shape[0], rows):
        hit = torch.zeros((min(rows, D.shape[0] - b), D.shape[0]), dtype=torch.bool,
                          device=D.device)
        for d in range(p):
            hit |= dot_f32(D[b:b + rows, d * w:(d + 1) * w], D[:, d * w:(d + 1) * w]) >= t_loc
        most = max(most, int(hit.sum(dim=1).max()))
    return most


def slice_cap(np, indices, nnz, m: int, p: int) -> int:
    """``cap_loc`` of the host dimension split: the most stored entries of
    one row in one of ``p`` dimension slices."""
    valid = np.arange(indices.shape[1])[None, :] < nnz[:, None]
    owner = indices // (m // p)
    return max(1, max(int((valid & (owner == d)).sum(axis=1).max()) for d in range(p)))


def dist_expected_bytes(v: dict, *, n: int, m: int, k: int, cap: int, cap_loc4: int,
                        cap_loc2: int) -> dict:
    """The bytes one rank sends in a variant, by collective, counted from the
    schedules of ``core.distributed`` (the tensor a ppermute sends; the input
    of every other collective)."""
    kw = v["kwargs"]
    sparse = v["corpus"] == "sparse"
    out = dict(ppermute=0, psum=0, psum_scatter=0, all_gather=0, pmax=0)
    if v["distribution"] in ("horizontal", "hierarchical"):
        n_loc = n // 4
        block = n_loc * (8 * cap + 4) if sparse else n_loc * m * 4  # CSR triple or rows
        caravan = n_loc * (8 * k + 4)                                # a Matches of n_loc rows
        if v["distribution"] == "hierarchical":  # 2 inner hops, 1 outer, each with its owner id
            out["ppermute"] = 3 * (block + 4)
        elif kw["schedule"] == "allgather":
            out["all_gather"] = block
        elif kw["schedule"] == "ring":
            out["ppermute"] = 3 * block
        else:  # halfring at p = 4: 2 block hops with the caravan, 1 home shift
            out["ppermute"] = 2 * block + 3 * caravan
        return out
    bs, acc = kw["block_rows"], kw["accumulation"]
    C = kw["candidate_capacity"]
    if v["distribution"] == "vertical":
        nb, cols, r = n // bs, n, 4
        steps = 1
    else:  # 2-D on (2, 2): two ring steps of the cell over the row axis
        cols, r, steps = n // 2, 2, 2
        bs = max(d for d in range(1, min(bs, cols) + 1) if cols % d == 0)  # the block clamp
        nb = cols // bs
        out["ppermute"] = (n // 2) * (8 * cap_loc2 if sparse else (m // 2) * 4)
        out["pmax"] = 8  # the overflow, over the column then the row axis
    cc = min(C, cols)
    per_block = {
        "allreduce": dict(psum=bs * cols * 4),
        "scatter": dict(psum_scatter=bs * cols * 4),
        "compressed": dict(all_gather=bs * cc * 4, psum=bs * r * cc * 4),
        "recursive": dict(ppermute=2 * 3 * bs * cc * 4, all_gather=bs * cc * 4,
                          psum=bs * r * cc * 4),  # 2 hypercube levels of (ids, values, ub)
    }[acc]
    for op, b in per_block.items():
        out[op] += steps * nb * b
    if v["distribution"] == "vertical" and acc in ("compressed", "recursive"):
        out["pmax"] = 4
    return out


def auto_check(per_rank, sent) -> list:
    """The ``distribution="auto"`` variant: one config chosen on every rank,
    and each rank's record's ppermute bytes equal to the bytes it sent."""
    failed = []
    chosen = per_rank[0]["chosen"]
    if len(set(chosen)) != 1:
        failed.append(f"auto: the ranks chose {chosen}")
    for r, (rec, counted) in enumerate(zip(per_rank, sent)):
        recorded = sum(h["bytes_per_hop"] * h["hops"] for rr in rec["records"]
                       for h in rr["hops"] if h["op"] == "ppermute")
        if recorded != counted["ppermute"]:
            failed.append(f"auto: rank {r} recorded {recorded} ppermute bytes, sent "
                          f"{counted['ppermute']}")
    return failed


def dist_row_check(np, got, single, n0: int, t: float) -> dict:
    """A gathered distributed result against the single-device reference:
    rows below ``n0`` by the comparison rule, padded rows empty."""
    v, i, c = got
    cmp = compare(np, (v[:n0], i[:n0], c[:n0]), single["ref"], t, single["near"])
    cmp["vs_k1"] = compare(np, (v[:n0], i[:n0], c[:n0]), single["k1"], t, single["near"])["ok"]
    cmp["padded_rows_empty"] = bool((c[n0:] == 0).all() and (i[n0:] == -1).all())
    return cmp


def audit_check(phase, report) -> None:
    """The 4-rank audit (``AUDIT_RANKS``) that the distributed phase's ranks
    ran after their variants: rank 0's report printed, the gated families
    within the band and the ring's link ratio within 0.5-2."""
    rows = audit_rows(report.entries)
    emit(f"{phase}/audit", ranks=4, meshes=report.meshes, gated_ok=report.gated_ok(),
         **AUDIT_RANKS, families=rows)
    ring = report.entry("horizontal/ring[dense]").link_ratio
    check(report.gated_ok() and ring is not None and 0.5 <= ring <= 2.0,
          f"{phase}: the 4-rank audit: gated {report.gated_ok()}, ring link ratio {ring}")


def distributed_phase(np, torch, phase, D_host, single, residuals, profile, *, threshold, k,
                      n_pad, m_pad) -> dict:
    """The paper's 1-D and 2-D distributions (``core.distributed.apss``) in 4
    ranks on the one card over gloo, dense and sparse, on ``D_host`` padded
    with zero rows and columns to ``(n_pad, m_pad)``; every variant against
    the single-device reference ``single`` (its plain result, K1's, and the
    near-threshold counts). Rank 0's drift residuals of every variant's first
    run against ``profile`` go to ``residuals``. Returns K1's row at a ring
    step's shape."""
    import statistics

    from repro_torch.core.precision import dot_f32
    from repro_torch.core.sparse import from_dense
    from repro_torch.kernels.apss_block import fused
    from repro_torch.kernels.apss_block.ops import _padded_pair, _pick_bk
    from repro_torch.launch.mesh import default_backend, spawn
    from repro_torch.obs import drift

    n0, m0 = D_host.shape
    t = threshold
    run = ROOT / "build" / "distributed"
    run.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    dense_path = run / "corpus.npy"
    Dp = np.lib.format.open_memmap(dense_path, mode="w+", dtype=np.float32,
                                   shape=(n_pad, m_pad))
    Dp[:n0, :m0] = D_host
    Dp.flush()
    Dc = torch.from_numpy(np.asarray(Dp)).cuda()
    sp = from_dense(Dc, device=Dc.device)
    idx, val, nnz = (x.cpu().numpy() for x in (sp.indices, sp.values, sp.nnz))
    sparse_path = run / "corpus.npz"
    np.savez(sparse_path, indices=idx, values=val, nnz=nnz, m=m_pad)
    cap4 = candidate_capacity(torch, Dc, t, 4)
    cap2 = candidate_capacity(torch, Dc, t, 2)
    del Dc, sp
    torch.cuda.empty_cache()  # the card's memory goes to the 4 ranks
    setup_s = time.perf_counter() - t0
    variants = dist_variants(cap4, cap2)

    # The main path: every variant in 4 ranks on the card, counted and timed.
    t0 = time.perf_counter()
    recs = spawn("repro_torch.launch.apss_mesh:run_variants", 4,
                 {"dense": str(dense_path), "sparse": str(sparse_path)}, variants, t, k,
                 DIST_REPS, profile, AUDIT_RANKS, device="cuda", run_dir=run)
    spawn_s = time.perf_counter() - t0
    audit_check(phase, recs[0]["audit"])
    cap = idx.shape[1]
    sizes = dict(n=n_pad, m=m_pad, k=k, cap=cap, cap_loc4=slice_cap(np, idx, nnz, m_pad, 4),
                 cap_loc2=slice_cap(np, idx, nnz, m_pad, 2))
    table, k1_launches, failed = {}, {}, []
    for v in variants:
        name = v["name"]
        per_rank = [r[name] for r in recs]
        residuals += [drift.Residual(**r) for r in per_rank[0]["residuals"]]
        sent = [rec["wire_bytes"][0] for rec in per_rank]
        if v["distribution"] == "auto":
            failed += auto_check(per_rank, sent)
            want = sent[0]  # the chosen schedule's: its ppermute bytes are held to the record
        else:
            want = dist_expected_bytes(v, **sizes)
        cmp = dist_row_check(np, per_rank[0]["matches"], single, n0, t)
        uses_k1 = bool(v["kwargs"].get("use_kernel"))
        k1 = [rec["launches"]["apss_fused"] for rec in per_rank]
        if uses_k1:
            k1_launches[name] = k1
        table[name] = dict(
            wall_ms=statistics.median(per_rank[0]["wall_ms"]), wall_ms_runs=per_rank[0]["wall_ms"],
            device_ms=[rec["device_ms"] for rec in per_rank],
            copy_ms=[rec["copy_ms"] for rec in per_rank],
            k1_ms=[rec["k1_ms"] for rec in per_rank],
            wire_ms=[statistics.median(rec["wire_ms"]) for rec in per_rank],
            bytes_sent=[sum(b.values()) for b in sent], bytes_expected=sum(want.values()),
            k1_launches=k1, overflow_rows=per_rank[0].get("overflow_rows"),
            capacity=v["kwargs"].get("candidate_capacity"), vs_single=cmp,
            chosen=per_rank[0].get("chosen"), profile=per_rank[0].get("profile"),
            records=per_rank[0]["records"],
        )
        if not (cmp["ok"] and cmp["vs_k1"] and cmp["padded_rows_empty"]):
            failed.append(f"{name} disagrees with the single-device reference: {cmp}")
        if any(b != want for b in sent):
            failed.append(f"{name} sent {sent}, the schedule sends {want}")
        if uses_k1 and min(k1) == 0:
            failed.append(f"{name}: K1 never ran on some rank: {k1}")
        if per_rank[0].get("overflow_rows"):
            failed.append(f"{name}: {per_rank[0]['overflow_rows']} rows overflowed")
    emit(phase, n=n0, m=m0, n_pad=n_pad, m_pad=m_pad, ranks=4,
         backend=default_backend("cuda", 4),
         threshold=t, k=k, cap=cap, cap_loc=[sizes["cap_loc4"], sizes["cap_loc2"]],
         candidate_capacity={"p4": cap4, "p2": cap2}, setup_s=setup_s, spawn_s=spawn_s,
         reps=DIST_REPS, variants=table)
    check(not failed, f"{phase}: " + "; ".join(failed))

    # K1 alone at a ring step's shape: rank 2's rows against rank 1's block
    # (step s = 1), against its plain version.
    n_loc = n_pad // 4
    x = torch.from_numpy(np.array(Dp[2 * n_loc:3 * n_loc])).cuda()
    y = torch.from_numpy(np.array(Dp[n_loc:2 * n_loc])).cuda()
    row_off, col_off = 2 * n_loc, n_loc
    bm = 256
    _, nc, xp, yp, mask = _padded_pair(x, y, t, None, True, bm, bm, _pick_bk(m_pad, 512),
                                       x.device)
    kw1 = dict(block_m=bm, block_n=bm, n_valid_cols=nc, row_offset=row_off,
               col_offset=col_off, exclude_self=True)
    near = ((dot_f32(x, y) - t).abs() <= TOL).sum(dim=1).cpu().numpy()
    near = np.concatenate([near, np.zeros(xp.shape[0] - n_loc, near.dtype)])
    cmp1 = compare(np, as_rows(np, *fused.apss_fused_kernel(xp, yp, mask, t, k, **kw1)),
                   as_rows(np, *fused.apss_fused_plain(xp, yp, mask, t, k, **kw1)), t, near)
    check(cmp1["ok"], f"{phase}: K1 at the ring step disagrees with its plain version: {cmp1}")
    launches = {"apss_fused": sum(sum(v) for v in k1_launches.values())}
    mk = mask.cpu().numpy()
    valid_r = np.full(mk.shape[0], bm)
    valid_c = np.minimum(bm, nc - np.arange(mk.shape[1]) * bm)
    flop = 2.0 * m_pad * float((mk * np.outer(valid_r, valid_c)).sum())
    nbytes = 4.0 * 2 * n_loc * m_pad + n_loc * (8 * k + 4) + mk.size
    row = kernel_row(
        np, torch, "apss_fused", phase, launches, cmp1,
        lambda: fused.apss_fused_kernel(xp, yp, mask, t, k, **kw1),
        lambda: fused.apss_fused_plain(xp, yp, mask, t, k, **kw1),
        lambda: library_rect(torch, x, y, t, k), flop, nbytes,
    )
    segments = fused.fused_segments_for(xp, yp.shape[0], k)
    row.update(shape=[n_loc, n_loc, m_pad], row_offset=row_off, col_offset=col_off,
               launches_per_rank=k1_launches, segments=segments,
               grid=[-(-xp.shape[0] // fused.FUSED_TILE), segments],
               merge_grid=-(-xp.shape[0] // 8) if segments > 1 else 0,
               slots=fused.fused_capacity(xp.dtype, k, xp.device))
    del x, y, xp, yp, mask
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Live corpus (K4's masked entry)
# ---------------------------------------------------------------------------

LIVE_ROOT = ROOT / "build" / "live"  # the WAL of live_clustered_65k, on local disk


class MaskedCalls:
    """While ``on``, keeps copies of the arguments of the live index's K4
    calls (made on the card before each call, so later mutations of the
    index's tensors do not reach them); each tensor is copied once."""

    def __init__(self, torch):
        from repro_torch.serving import mutable

        self.torch, self.mutable = torch, mutable
        self.real = mutable.rect_tile_candidates_kernel
        self.on, self.calls = False, []

    def __enter__(self):
        self.mutable.rect_tile_candidates_kernel = self._spy
        return self

    def __exit__(self, *exc):
        self.mutable.rect_tile_candidates_kernel = self.real

    def _spy(self, *args, **kw):
        if self.on:
            seen = {}

            def copy_(x):
                if not isinstance(x, self.torch.Tensor):
                    return x
                return seen.setdefault(id(x), x.clone())

            self.calls.append((tuple(copy_(a) for a in args),
                               {n: copy_(v) for n, v in kw.items()}))
        return self.real(*args, **kw)


def masked_near(np, torch, Q, C, ij, bq, col_live, qpos, t):
    """Per packet row of a masked K4 call, its query row's pairs with
    |s - t| <= TOL among the live columns other than its own position."""
    from repro_torch.core.precision import dot_f32

    rows = (ij[0].numpy()[:, None] * bq + np.arange(bq)[None, :]).reshape(-1)
    urows = np.unique(rows)
    live = col_live.to(C.device).bool()
    per = {}
    for a in range(0, len(urows), 512):
        r = torch.from_numpy(urows[a:a + 512]).to(Q.device)
        near = ((dot_f32(Q[r], C) - t).abs() <= TOL) & live[None, :]
        own = qpos.to(Q.device)[r].long()
        has = own >= 0
        near[torch.arange(len(r), device=Q.device)[has], own[has]] = False
        per.update(zip(urows[a:a + 512].tolist(), near.sum(dim=1).cpu().tolist()))
    return np.array([per[r] for r in rows])


def masked_work(np, calls, k, m):
    """FLOP and bytes of the masked K4 calls of one delta join: products of
    each tile's non-zero query rows (the delta's rows, or the live rows of
    a corpus block) with its live corpus rows at the index's width ``m``
    (not the lane-padded one), each of those rows read once, both masks
    read, every packet written."""
    flop = nbytes = 0.0
    for (Q, C, ij, *_), kw in calls:
        bq, bc, depth = kw["block_q"], kw["block_c"], m
        wl = ij.numpy()
        qnz = Q.ne(0).any(dim=1).cpu().numpy().reshape(-1, bq)
        live = kw["col_live"].cpu().numpy().astype(bool).reshape(-1, bc)
        flop += 2.0 * depth * float((qnz.sum(1)[wl[0]] * live.sum(1)[wl[1]]).sum())
        rows = qnz[np.unique(wl[0])].sum() + live[np.unique(wl[1])].sum()
        nbytes += (4.0 * depth * rows + live.size + 4 * Q.shape[0] + 8 * wl.shape[1]
                   + wl.shape[1] * bq * (8 * k + 4))
    return flop, nbytes


def library_masked(torch, Q, C, ij, t, k, *, block_q, block_c, nc_valid, col_live, qpos):
    """Yardstick of the masked K4: ``torch.bmm`` of the same tiles (in
    chunks of at most 256 MB of operands), the masks, and a stable-sort
    top-k. The port never calls it."""
    from repro_torch.kernels.apss_block.fused import _rect_tile_packets, live_masked

    m = Q.shape[1]
    qb, cb = Q.view(-1, block_q, m), C.view(-1, block_c, m)
    ij = ij.to(Q.device).long()
    step = max(1, (1 << 28) // (4 * (block_q + block_c) * m))
    outs = []
    for a in range(0, ij.shape[1], step):
        i, j = ij[0, a:a + step], ij[1, a:a + step]
        s = live_masked(torch.bmm(qb[i], cb[j].transpose(1, 2)), i, j, col_live, qpos,
                        block_q=block_q, block_c=block_c)
        outs.append(_rect_tile_packets(s, j, threshold=t, k=k, block_q=block_q,
                                       block_c=block_c, nc_valid=nc_valid))
    return [torch.cat(p) for p in zip(*outs)]


def masked_k4_row(np, torch, row_name, launches, calls, t, k, m):
    """The masked K4 calls of one delta join (forward and reverse) held
    against the plain version on the same inputs and timed together; the
    bound counts the work at the index's width ``m``."""
    from repro_torch.kernels.apss_block import fused

    got, ref, near = [], [], []
    for (Q, C, ij, *_), kw in calls:
        got.append(as_rows(np, *fused.rect_tile_candidates_kernel(Q, C, ij, t, k, **kw)))
        ref.append(as_rows(np, *fused.rect_tile_candidates_plain(Q, C, ij, t, k, **kw)))
        near.append(masked_near(np, torch, Q, C, ij, kw["block_q"], kw["col_live"],
                                kw["qpos"], t))
    cmp = compare(np, *(tuple(np.concatenate(x) for x in zip(*side)) for side in (got, ref)),
                  t, np.concatenate(near))
    check(cmp["ok"], f"{row_name}: the masked K4 disagrees with its plain version: {cmp}")
    flop, nbytes = masked_work(np, calls, k, m)
    row = kernel_row(
        np, torch, "rect_tile_candidates_masked", row_name, launches, cmp,
        lambda: [fused.rect_tile_candidates_kernel(Q, C, ij, t, k, **kw)
                 for (Q, C, ij, *_), kw in calls],
        lambda: [fused.rect_tile_candidates_plain(Q, C, ij, t, k, **kw)
                 for (Q, C, ij, *_), kw in calls],
        lambda: [library_masked(torch, Q, C, ij, t, k, **kw) for (Q, C, ij, *_), kw in calls],
        flop, nbytes,
    )
    row.update(calls=[dict(query_rows=int(Q.shape[0]), block_q=kw["block_q"],
                           block_c=kw["block_c"], tiles=int(ij.shape[1]),
                           passes=-(-int(ij.shape[1]) // fused.rect_work_split(
                               int(ij.shape[1]), Q.shape[1], kw["block_q"],
                               kw["block_c"]).pass_tiles))
                      for (Q, C, ij, *_), kw in calls])
    return row


class LiveOps:
    """Runs the live index's ops, each on its own: the launch counts set to
    0 before and added up after, the host-clock wall (ending in a
    synchronize), and, from a tracer around the op, the time in its
    ``checkpoint/save`` spans (the WAL entry and the snapshot)."""

    def __init__(self, np, torch):
        self.np, self.torch = np, torch
        self.walls: dict = {}
        self.io: dict = {}
        self.launches: dict = {}

    def run(self, name, fn):
        from repro_torch.obs import Tracer

        reset_launches()
        with Tracer() as tr:
            out, ms = timed(self.torch, fn)
        for key, n in launches_now().items():
            self.launches[key] = self.launches.get(key, 0) + n
        io = sum(s.duration_s for s in tr.walk() if s.name == "checkpoint/save") * 1e3
        self.walls.setdefault(name, []).append(ms)
        self.io.setdefault(name, []).append(io)
        return out

    def summary(self) -> dict:
        return dict(walls_ms=self.walls, wal_snapshot_ms=self.io,
                    append_io_share=sum(self.io.get("append", [0.0])) / max(
                        1e-9, sum(self.walls.get("append", [0.0]))))


def live_graph_checks(np, phase, idx, fresh, surv, ref, near, t, *, reopened=None):
    """The final graph: equal bit for bit to the fresh rebuild's (its ids
    translated to gids) and to the reopened index's, and exact against the
    port's oracle on the survivors by the comparison rule."""
    gids, g = idx.graph()
    check(np.array_equal(gids, surv), f"{phase}: the live gids are not the survivors")
    _, fg = fresh.graph()
    fi = np.where(fg.indices >= 0, surv[np.maximum(fg.indices, 0)], -1)
    check(np.array_equal(g.values, fg.values) and np.array_equal(g.indices, fi)
          and np.array_equal(g.counts, fg.counts),
          f"{phase}: the mutated graph differs from the fresh rebuild's")
    if reopened is not None:
        rg, rm = reopened
        check(np.array_equal(rg, gids) and all(np.array_equal(a, b) for a, b in zip(rm, g)),
              f"{phase}: the reopened index differs from the one before")
    rv, ri, rc = ref
    ri = np.where(ri >= 0, surv[np.maximum(ri, 0)], -1)
    c = compare(np, (g.values, g.indices, g.counts), (rv, ri, rc), t, near)
    check(c["ok"], f"{phase}: the live graph disagrees with the oracle: {c}")
    return c


def live_clustered_phase(np, torch, phase, *, n=65536, m=768, delta=256, dels=128) -> dict:
    """``clustered_corpus(65536, 768, 8)`` as a live index on the card with a
    WAL on local disk: four rounds of an append of 256 rows (seed 1), a
    delete of 128 random live ids and 64 queries through a
    ``RetrievalServer(use_kernel=True)`` (the version-keyed LRU checked),
    then compact, reopen and a fresh rebuild."""
    import shutil

    from repro_torch.core.apss import apss_blocked, normalize_rows
    from repro_torch.data.synthetic import clustered_corpus
    from repro_torch.interop import matches_to_numpy
    from repro_torch.serving import MutableAPSSIndex, RetrievalServer
    from repro_torch.serving.mutable import _normalize_host

    t0 = time.perf_counter()
    t, k, br, rounds = 0.5, 32, 128, 4
    d = LIVE_ROOT / phase
    shutil.rmtree(d, ignore_errors=True)
    D0 = clustered_corpus(n, m, 8, n_clusters=32, seed=0)
    extra = clustered_corpus(rounds * delta, m, 8, n_clusters=32, seed=1)
    raw = np.concatenate([D0, extra])
    alive = np.zeros(raw.shape[0], bool)
    alive[:D0.shape[0]] = True
    rng = np.random.default_rng(0)
    kw = dict(threshold=t, k=k, block_rows=br)
    ops = LiveOps(np, torch)
    with MaskedCalls(torch) as spy:
        idx = ops.run("setup", lambda: MutableAPSSIndex(D0, directory=str(d), **kw))
        srv = RetrievalServer(idx, threshold=t, k=k, max_batch=64, use_kernel=True)
        lru, q = [], None
        for r in range(rounds):
            spy.on = r == 0
            gids = ops.run("append", lambda: idx.append(extra[r * delta:(r + 1) * delta]))
            spy.on = False
            check(gids == list(range(D0.shape[0] + r * delta, D0.shape[0] + (r + 1) * delta)),
                  f"{phase}: unexpected gids")
            alive[gids] = True
            victims = sorted(rng.choice(np.nonzero(alive)[0], dels, replace=False).tolist())
            ops.run("delete", lambda: idx.delete(victims))
            alive[victims] = False
            stale = [] if q is None else srv.serve(list(q))  # last round's, cached before
            q = raw[rng.choice(np.nonzero(alive)[0], 64, replace=False)]
            q = q + 0.01 * np.abs(rng.standard_normal(q.shape)).astype(np.float32) * (q > 0)
            res = ops.run("queries", lambda: srv.serve(list(q)))
            again = srv.serve(list(q))
            check(not any(x.cached for x in stale + res) and all(x.cached for x in again)
                  and all(x.status == "ok" for x in stale + res + again),
                  f"{phase}: the version-keyed LRU hit across a mutation or missed within "
                  f"a version")
            own = idx.query(normalize_rows(torch.from_numpy(q).cuda()))  # the server's batch
            check(all(np.array_equal(x.values, v) and np.array_equal(x.indices, i)
                      for x, v, i in zip(res, own.values, own.indices)),
                  f"{phase}: the server's K4 lane differs from the masked K4 lane")
            lru.append(dict(version=idx.version, misses_after_mutation=len(stale),
                            hits_within_version=sum(x.cached for x in again)))
        check(srv.stats.degraded == srv.stats.retries == 0, f"{phase}: the server degraded")
        ops.run("compact", idx.compact)
        reopened = ops.run("reopen", lambda: MutableAPSSIndex(None, directory=str(d), **kw))
        reopened_graph = reopened.graph()
        del reopened
        surv = np.nonzero(alive)[0]
        fresh = ops.run("rebuild", lambda: MutableAPSSIndex(raw[surv], **kw))
    launches = ops.launches
    check(launches["rect_tile_candidates_masked"] > 0 and launches["rect_tile_candidates"] > 0,
          f"{phase}: the masked K4 or K4 never ran: {launches}")
    check(len(spy.calls) >= 1, f"{phase}: no masked K4 call captured")
    Dn = torch.from_numpy(_normalize_host(raw[surv])).cuda()
    ref = matches_to_numpy(apss_blocked(Dn, t, k, use_kernel=False))
    near = near_threshold_counts(torch, Dn, t)
    del Dn
    cmp = live_graph_checks(np, phase, idx, fresh, surv, ref, near, t,
                            reopened=reopened_graph)
    del fresh
    row = masked_k4_row(np, torch, phase, launches, spy.calls, t, k, m)
    emit(phase, n=int(alive.sum()), m=m, threshold=t, k=k, block_rows=br, rounds=rounds,
         capacity=idx._ncap, lanes=idx._mlanes, launches=launches, lru=lru,
         vs_oracle=cmp, seconds=time.perf_counter() - t0, **ops.summary())
    del idx, srv
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return row


def live_radikal_phase(np, torch, phase, radikal) -> dict:
    """The radikal corpus as the first append of a live index on the card
    (one delta join over every live tile), then two appends of 64 rows, two
    deletes of 32, 64 queries through ``query(use_kernel=True)`` and a
    fresh rebuild. No WAL: a snapshot would copy all of C to the host on
    every op."""
    from repro_torch.core.apss import apss_reference
    from repro_torch.core.sparse import from_dense
    from repro_torch.data.sparse import perturbed_queries
    from repro_torch.interop import matches_to_numpy
    from repro_torch.serving import MutableAPSSIndex
    from repro_torch.serving.mutable import _normalize_host

    t0 = time.perf_counter()
    t, k, br = 0.2, 32, 256
    sp = from_dense(torch.from_numpy(radikal).cuda())
    extra = [perturbed_queries(sp, 64, seed=s) for s in (2, 3)]
    Q = perturbed_queries(sp, 64, seed=1)
    del sp
    torch.cuda.empty_cache()
    raw = np.concatenate([radikal] + extra)
    alive = np.zeros(raw.shape[0], bool)
    alive[:radikal.shape[0]] = True
    rng = np.random.default_rng(0)
    kw = dict(threshold=t, k=k, block_rows=br)
    ops = LiveOps(np, torch)
    with MaskedCalls(torch) as spy:
        idx = ops.run("setup", lambda: MutableAPSSIndex(radikal, **kw))
        first_join = dict(launches=dict(ops.launches))
        for r, rows in enumerate(extra):
            spy.on = r == 0
            gids = ops.run("append", lambda: idx.append(rows))
            spy.on = False
            alive[gids] = True
            victims = sorted(rng.choice(np.nonzero(alive)[0], 32, replace=False).tolist())
            ops.run("delete", lambda: idx.delete(victims))
            alive[victims] = False
        got = ops.run("queries", lambda: idx.query(Q, use_kernel=True))
        own = idx.query(Q)
        check(np.array_equal(got.values, own.values) and np.array_equal(got.indices, own.indices)
              and np.array_equal(got.counts, own.counts),
              f"{phase}: query(use_kernel=True) differs from the masked K4 lane")
        surv = np.nonzero(alive)[0]
        fresh = ops.run("rebuild", lambda: MutableAPSSIndex(raw[surv], **kw))
    launches = ops.launches
    check(launches["rect_tile_candidates_masked"] > 0 and launches["rect_tile_candidates"] > 0,
          f"{phase}: the masked K4 or K4 never ran: {launches}")
    Dn = torch.from_numpy(_normalize_host(raw[surv])).cuda()
    ref = matches_to_numpy(apss_reference(Dn, t, k))
    near = near_threshold_counts(torch, Dn, t)
    cmp = live_graph_checks(np, phase, idx, fresh, surv, ref, near, t)
    qref, qnear = rect_reference(torch, torch.from_numpy(Q).cuda(), Dn, t, k)
    qv, qi, qc = matches_to_numpy(qref)
    qcmp = compare(np, tuple(got), (qv, np.where(qi >= 0, surv[np.maximum(qi, 0)], -1), qc),
                   t, qnear)
    check(qcmp["ok"], f"{phase}: the queries disagree with the oracle: {qcmp}")
    del Dn, fresh
    torch.cuda.empty_cache()
    row = masked_k4_row(np, torch, phase, launches, spy.calls, t, k, int(radikal.shape[1]))
    emit(phase, n=int(alive.sum()), m=int(radikal.shape[1]), threshold=t, k=k, block_rows=br,
         capacity=idx._ncap, lanes=idx._mlanes, launches=launches, first_join=first_join,
         vs_oracle=cmp, queries_vs_oracle=qcmp, seconds=time.perf_counter() - t0,
         **ops.summary())
    del idx, spy
    torch.cuda.empty_cache()
    return row


def live_sparse_phase(np, torch, phase, *, n=65536, m=8192) -> None:
    """``sparse_clustered_corpus(65536, 8192, 16, n_clusters=32)`` as a sparse
    live index on the card (the plain slot-order scorer, no kernel), its ELL
    width pinned at the corpus's: two rounds of an append of 256 rows and a
    delete of 128, then a fresh rebuild; ``query(use_kernel=True)`` must
    raise."""
    from repro_torch.core.apss import apss_blocked
    from repro_torch.core.sparse import from_dense, to_dense
    from repro_torch.data.sparse import sparse_clustered_corpus
    from repro_torch.interop import matches_to_numpy
    from repro_torch.serving import MutableAPSSIndex
    from repro_torch.serving.mutable import _normalize_sparse_host

    t0 = time.perf_counter()
    t, k, br, rounds = 0.5, 32, 256, 2
    sp = sparse_clustered_corpus(n, m, 16.0, n_clusters=32, seed=0)
    add = sparse_clustered_corpus(rounds * 256, m, 16.0, n_clusters=32, seed=1)
    cap = sp.cap
    check(add.cap <= cap, f"{phase}: the appended rows need a wider ELL than {cap}")
    raw = np.concatenate([to_dense(sp).cpu().numpy(), to_dense(add).cpu().numpy()])
    del add
    alive = np.zeros(raw.shape[0], bool)
    alive[:sp.n] = True
    rng = np.random.default_rng(0)
    kw = dict(threshold=t, k=k, block_rows=br, kind="sparse", cap=cap)
    ops = LiveOps(np, torch)
    idx = ops.run("setup", lambda: MutableAPSSIndex(sp, **kw))
    n0 = sp.n
    del sp
    for r in range(rounds):
        gids = ops.run("append", lambda: idx.append(raw[n0 + r * 256:n0 + (r + 1) * 256]))
        alive[gids] = True
        victims = sorted(rng.choice(np.nonzero(alive)[0], 128, replace=False).tolist())
        ops.run("delete", lambda: idx.delete(victims))
        alive[victims] = False
    q = raw[rng.choice(np.nonzero(alive)[0], 64, replace=False)]
    ops.run("queries", lambda: idx.query(q))
    check(_raises(lambda: idx.query(q, use_kernel=True), NotImplementedError),
          f"{phase}: query(use_kernel=True) on a sparse live index did not raise")
    surv = np.nonzero(alive)[0]
    fresh = ops.run("rebuild", lambda: MutableAPSSIndex(raw[surv], **kw))
    check(ops.launches["rect_tile_candidates_masked"] == 0, f"{phase}: a kernel ran")
    spn = _normalize_sparse_host(from_dense(raw[surv], cap=cap, device="cpu")).to("cuda")
    ref = matches_to_numpy(apss_blocked(spn, t, k, use_kernel=False))
    near = near_threshold_counts(torch, to_dense(spn), t)
    cmp = live_graph_checks(np, phase, idx, fresh, surv, ref, near, t)
    emit(phase, n=int(alive.sum()), m=m, cap=cap, threshold=t, k=k, block_rows=br,
         rounds=rounds, capacity=idx._ncap, launches=ops.launches, vs_oracle=cmp,
         seconds=time.perf_counter() - t0, **ops.summary())
    del idx, fresh, spn
    torch.cuda.empty_cache()


def live_corpus_phase(np, torch, radikal) -> list:
    """The three parts of the ``live_corpus`` phase; returns the masked K4's
    rows."""
    t0 = time.perf_counter()
    rows = [live_clustered_phase(np, torch, "live_clustered_65k"),
            live_radikal_phase(np, torch, "live_radikal_full", radikal)]
    live_sparse_phase(np, torch, "live_sparse_clustered_65k")
    emit("live_corpus", seconds=time.perf_counter() - t0)
    return rows


# ---------------------------------------------------------------------------
# The model-vs-program audit (obs.audit) and the build/load monitor
# ---------------------------------------------------------------------------

AUDIT_RANKS = dict(n=512, m=512, k=32, threshold=0.2)  # the 4-rank audit in phase 14


def audit_rows(entries) -> list:
    """Per audited family: the ratios, both sides' numbers and the census's
    kernels."""
    return [dict(family=e.family, config=e.config, flop_ratio=e.flop_ratio,
                 link_ratio=e.link_ratio, hbm_ratio=e.hbm_ratio,
                 predicted_flops=e.predicted_flops, measured_flops=e.measured_flops,
                 predicted_link_bytes=e.predicted_link_bytes,
                 measured_link_bytes=e.measured_link_bytes,
                 predicted_hbm_bytes=e.predicted_hbm_bytes,
                 measured_hbm_bytes=e.measured_hbm_bytes,
                 host_copy_bytes=e.record.analysis["host_copy_bytes"],
                 n_ops=e.record.analysis["n_ops"], kernels=e.kernels,
                 wall_s=e.record.t_lower_s, nvcc_s=e.record.t_compile_s,
                 temp_bytes=e.record.temp_bytes, code_bytes=e.record.code_bytes,
                 notes=list(e.notes))
            for e in entries]


def audit_phase(np, torch, phase, radikal, D, sp, *, threshold, k) -> None:
    """``obs.audit.run_audit`` on the radikal corpus on the card: the
    single-device families (blocked, dense and CSR, on their plain paths)
    and the serving (B = 64, a dense and a CSR index: K4, K6) and live-index
    (K4's masked entry) captures, each run once under the op census; every
    family's FLOP, link and HBM ratios and the census's K4 and K6 work. The
    planner's kernel candidates of the same families (K1 on ``D``, K3 on
    ``sp``, block 256) are audited the same way (``audit._audit_planned``),
    beside the plain ones. Then
    a warmed ``query_topk`` on a dense index of the same corpus under
    ``assert_no_retrace("serving.query")`` (it must build and load
    nothing), its captured K4 call replayed under ``obs.compile.measure``:
    the census's K4 FLOPs must equal ``rect_work``'s for that launch, and
    the audit's serving entry (the same index, queries and worklist) the
    same."""
    from repro_torch.obs import audit
    from repro_torch.obs import compile as obs_compile
    from repro_torch.planner.costmodel import VariantConfig
    from repro_torch.planner.plan import summarize_corpus
    from repro_torch.serving import build_index, query_topk

    t0 = time.perf_counter()
    reset_launches()
    report = audit.run_audit(radikal, k=k, threshold=threshold, batch=64, meshes=[],
                             device="cuda")
    audit_s = time.perf_counter() - t0
    launches = launches_now()
    rows = audit_rows(report.entries)
    fams = report.families()
    s = summarize_corpus(radikal, threshold)
    kernel_entries = [audit._audit_planned(VariantConfig("blocked", sparse, 256, use_kernel=True),
                                           s, data, threshold, k, None, None, D.device)
                      for sparse, data in ((False, D), (True, sp))]
    kernel_rows = audit_rows(kernel_entries)
    check("apss_fused" in kernel_rows[0]["kernels"]
          and "sparse_tile_candidates" in kernel_rows[1]["kernels"],
          f"{phase}: K1 or K3 never ran in the kernel candidates: {kernel_rows}")
    for want in ("blocked[dense]", "blocked[sparse]", "serving.query_topk[dense]",
                 "serving.query_topk[sparse]", "mutable.delta_join[dense]"):
        check(want in fams, f"{phase}: the audit lacks {want}: {fams}")
    census = {e.family: e.kernels for e in report.entries}
    check("rect_tile_candidates" in census["serving.query_topk[dense]"],
          f"{phase}: K4 never ran in the dense serving family: {census}")
    check("rect_sparse_tile_candidates" in census["serving.query_topk[sparse]"],
          f"{phase}: K6 never ran in the CSR serving family: {census}")
    check("rect_tile_candidates_masked" in census["mutable.delta_join[dense]"],
          f"{phase}: K4's masked entry never ran in the delta join: {census}")
    check(report.entry("blocked[dense]").flop_ratio is not None
          and 1 / audit.FLOP_RATIO_BAND <= report.entry("blocked[dense]").flop_ratio
          <= audit.FLOP_RATIO_BAND, f"{phase}: blocked[dense] outside the band: {rows[:2]}")

    # A warmed query under the no-retrace contract; its K4 call replayed.
    index = build_index(radikal, block_rows=64, device="cuda")
    Q = radikal[:64]
    query_topk(index, Q, threshold, k, use_kernel=True)  # warm
    before = obs_compile.snapshot()
    with obs_compile.capture_calls() as calls, \
            obs_compile.assert_no_retrace("serving.query"):
        query_topk(index, Q, threshold, k, use_kernel=True)
    check(obs_compile.snapshot() == before,
          f"{phase}: the warmed query built or loaded {obs_compile.snapshot()} vs {before}")
    call = calls["serving.dense_inner"]
    _, rec = obs_compile.measure(call.fn, *call.args, name="warm_query", **call.kwargs)
    index_c, Qp, wl = call.args[0], call.args[1], call.args[2]
    bq, bc = call.kwargs["block_q"], call.kwargs["block_c"]
    flop, nbytes = rect_work(np, wl, B=Qp.shape[0], n=index_c.corpus.shape[0], bq=bq, bc=bc,
                             depth=Qp.shape[1], k=k)
    k4 = rec.analysis["kernels"]["rect_tile_candidates"]
    check(k4["flops"] == flop and k4["launches"] == 1,
          f"{phase}: census K4 {k4} against rect_work's {flop}")
    audited = census["serving.query_topk[dense]"]["rect_tile_candidates"]
    check(audited["flops"] == flop,
          f"{phase}: the audit's K4 {audited} against rect_work's {flop} (same launch)")
    emit(phase, n=report.n, m=report.m, threshold=threshold, k=k, batch=64,
         audit_s=audit_s, seconds=time.perf_counter() - t0, launches=launches,
         gated_ok=report.gated_ok(), families=rows, kernel_families=kernel_rows,
         warm_query=dict(
             builds_and_loads=0, census_k4=k4, rect_work_flop=flop, rect_work_bytes=nbytes,
             tiles=int(wl.shape[1]), block_q=bq, block_c=bc, width=int(Qp.shape[1]),
             wall_s=rec.t_lower_s, temp_bytes=rec.temp_bytes, code_bytes=rec.code_bytes,
             ptxas=rec.kernels),
         census_k4=census["serving.query_topk[dense]"],
         census_k6=census["serving.query_topk[sparse]"],
         census_k4_masked=census["mutable.delta_join[dense]"])
    del report, index


# ---------------------------------------------------------------------------
# Resumable sweep (K4's masked entry, one launch per step)
# ---------------------------------------------------------------------------

SWEEP_ROOT = ROOT / "build" / "sweep"  # checkpoints and the ranks' corpus, on local disk
SWEEP_KILL = 27        # the middle step the kill faults fire at
SWEEP_DELAY_S = 0.2    # the straggler's delay at every step of the ranked part


class StepEvents:
    """While entered, CUDA events around every K4 launch of the sweep's steps
    (``robust.sweep`` calls the wrapper by the name it imported); nothing
    waits on them until :meth:`ms`."""

    def __init__(self, torch):
        from repro_torch.robust import sweep

        self.torch, self.sweep = torch, sweep
        self.real = sweep.rect_tile_candidates_kernel
        self.pairs = []

    def __enter__(self):
        self.sweep.rect_tile_candidates_kernel = self._timed
        return self

    def __exit__(self, *exc):
        self.sweep.rect_tile_candidates_kernel = self.real

    def _timed(self, *args, **kw):
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.real(*args, **kw)
        b.record()
        self.pairs.append((a, b))
        return out

    def ms(self) -> list:
        for _, b in self.pairs:
            b.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


def library_sweep(torch, Db, Cb, jb, t, k, *, bn, nc_valid, col_live, qpos):
    """Yardstick of a sweep step: one ``torch.bmm`` of the row blocks ``Db``
    against their partner blocks ``Cb`` (gathered beforehand, ids ``jb``),
    the masks and a stable-sort top-k. The port never calls it."""
    from repro_torch.kernels.apss_block.fused import _rect_tile_packets, live_masked

    ib = torch.arange(Db.shape[0], device=Db.device)
    s = live_masked(torch.bmm(Db, Cb.transpose(1, 2)), ib, jb, col_live, qpos,
                    block_q=bn, block_c=bn)
    return _rect_tile_packets(s, jb, threshold=t, k=k, block_q=bn, block_c=bn,
                              nc_valid=nc_valid)


def sweep_phase(np, torch, phase, radikal, single, residuals, profile, *, threshold, k,
                block_rows=128) -> dict:
    """The resumable sweep (``robust.ResumableSweep``) of the radikal corpus
    on the card, every step one launch of K4's masked entry: (a) the
    uninterrupted sweep against the single-device result, K4 per step from
    CUDA events, the wall and the checkpoint spans; (b) killed at step
    ``SWEEP_KILL`` and resumed by a new sweep over the directory; (c) the
    killed directory's newest step corrupted, the restore falling back a
    step; (d) 4 ranks on the card over gloo (54 % 4 ≠ 0: every rank scores
    every block), a delay fault on rank 1, killed at ``SWEEP_KILL``, the
    gathered ledger evicting rank 1 and 3 survivors (18 blocks each)
    resuming; (e) the drift report of ``residuals`` (the planner's planned
    runs and the distributed phase's ``apss`` calls) against ``profile``;
    (f) ``launch/serve.py --mode retrieval --chaos --trace-out
    --metrics-out`` in this process. (b)-(d) must equal (a) bit for bit.
    Returns K4's row at one step's shape."""
    import shutil
    import statistics
    import warnings

    from repro_torch.interop import matches_to_numpy
    from repro_torch.kernels.apss_block import fused
    from repro_torch.launch.mesh import spawn
    from repro_torch.obs import Tracer, drift
    from repro_torch.robust import Fault, FaultPlan, ResumableSweep, SweepKilled
    from repro_torch.robust import sweep as tsweep

    t_phase = time.perf_counter()
    t = threshold
    kw = dict(threshold=t, k=k, block_rows=block_rows)
    shutil.rmtree(SWEEP_ROOT, ignore_errors=True)
    SWEEP_ROOT.mkdir(parents=True)

    # (a) the uninterrupted sweep: the main path, counted and timed.
    sweep, setup_ms = timed(torch, lambda: ResumableSweep(
        radikal, directory=str(SWEEP_ROOT / "a"), **kw))
    B = sweep.B
    reset_launches()
    with StepEvents(torch) as ev, Tracer() as tr:
        got, wall = timed(torch, sweep.run)
    launches = launches_now()
    step_ms = ev.ms()
    io_ms = [s.duration_s * 1e3 for s in tr.walk() if s.name == "checkpoint/save"]
    steps = [s for s in tr.walk() if s.name == "sweep/step"]
    a = matches_to_numpy(got)
    cmp = compare(np, a, single["ref"], t, single["near"])
    cmp_k1 = compare(np, a, single["k1"], t, single["near"])
    emit(f"{phase}/uninterrupted", n=sweep.n, m=sweep.m, n_pad=sweep.n_pad, B=B,
         threshold=t, k=k, block_rows=block_rows, setup_ms=setup_ms, wall_ms=wall,
         launches=launches, step_spans=len(steps),
         k4_step_ms=dict(median=statistics.median(step_ms), min=min(step_ms),
                         max=max(step_ms), n=len(step_ms)),
         checkpoint_save_ms=dict(total=sum(io_ms), median=statistics.median(io_ms),
                                 n=len(io_ms)),
         vs_plain=cmp, vs_k1=cmp_k1)
    check(launches["rect_tile_candidates_masked"] == B and len(step_ms) == B,
          f"{phase}: {launches['rect_tile_candidates_masked']} masked K4 launches for {B} steps")
    check(cmp["ok"] and cmp_k1["ok"],
          f"{phase}: the sweep disagrees with the single-device result: {cmp} {cmp_k1}")
    Dd, col_live, qpos = sweep._Dd, sweep._col_live, sweep._qpos
    del sweep, got

    # (b) killed mid-sweep, resumed by a new sweep over the directory.
    t0 = time.perf_counter()
    plan = FaultPlan([Fault("kill", step=SWEEP_KILL)])
    killed = False
    try:
        ResumableSweep(radikal, directory=str(SWEEP_ROOT / "b"), fault_plan=plan, **kw).run()
    except SweepKilled:
        killed = True
    check(killed and plan.fired["kill:sweep"] == 1, f"{phase}: the kill did not fire")
    shutil.copytree(SWEEP_ROOT / "b", SWEEP_ROOT / "c")
    resumed = ResumableSweep(radikal, directory=str(SWEEP_ROOT / "b"), **kw)
    b_same = identical(np, matches_to_numpy(resumed.run()), a)
    emit(f"{phase}/kill_resume", killed_at=SWEEP_KILL, resumed_from=resumed.resumed_from,
         bit_for_bit=b_same, seconds=time.perf_counter() - t0)
    check(resumed.resumed_from == SWEEP_KILL and b_same,
          f"{phase}: the resumed sweep (from {resumed.resumed_from}) differs from (a)")
    del resumed

    # (c) the newest checkpoint corrupted: the restore falls back one step.
    t0 = time.perf_counter()
    step_dir = SWEEP_ROOT / "c" / f"step_{SWEEP_KILL:010d}"
    leaf = sorted(step_dir.glob("*.npy"))[0]
    FaultPlan(seed=1).corrupt_file(str(leaf))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fallback = ResumableSweep(radikal, directory=str(SWEEP_ROOT / "c"), **kw)
        c_same = identical(np, matches_to_numpy(fallback.run()), a)
    warned = [str(w.message) for w in caught if "falling back" in str(w.message)]
    emit(f"{phase}/corrupt_fallback", corrupted=str(leaf.relative_to(ROOT)),
         resumed_from=fallback.resumed_from, warnings=warned, bit_for_bit=c_same,
         seconds=time.perf_counter() - t0)
    check(fallback.resumed_from == SWEEP_KILL - 1 and warned and c_same,
          f"{phase}: the fallback (from {fallback.resumed_from}) differs from (a)")
    del fallback
    torch.cuda.empty_cache()

    # (d) 4 ranks on the card, a straggler evicted, 3 resume.
    t0 = time.perf_counter()
    path = SWEEP_ROOT / "corpus.npy"
    np.save(path, radikal)
    faults = [Fault("kill", step=SWEEP_KILL),
              Fault("delay", rank=1, seconds=SWEEP_DELAY_S, times=-1)]
    outs = spawn("repro_torch.launch.sweep:run_ranks", 4, str(path), str(SWEEP_ROOT / "d"),
                 kw, faults, device="cuda", run_dir=SWEEP_ROOT)
    path.unlink()
    d = next(o["matches"] for o in outs if "matches" in o)
    d_same = identical(np, d, a)
    emit(f"{phase}/ranks", ranks=4, sharded=[o["sharded"] for o in outs],
         killed=[o["killed"] for o in outs], evict=[o["evict"] for o in outs],
         rank_ema_s=outs[0]["rank_ema"], fired=[o["fired"] for o in outs],
         resumed=[o["resumed"] for o in outs], resumed_from=outs[0].get("resumed_from"),
         resumed_ranks=outs[0].get("resumed_ranks"),
         resumed_blocks=[len(o.get("resumed_blocks", [])) for o in outs],
         setup_s=[o["setup_s"] for o in outs], run_s=[o["run_s"] for o in outs],
         resume_s=[o.get("resume_s") for o in outs], bit_for_bit=d_same,
         seconds=time.perf_counter() - t0)
    check(all(o["killed"] and o["evict"] == [1] for o in outs),
          f"{phase}: the ranks were not all killed or did not evict [1]")
    check([o["resumed"] for o in outs] == [True, False, True, True]
          and outs[0]["resumed_from"] == SWEEP_KILL and outs[0]["resumed_sharded"]
          and outs[0]["resumed_ranks"] == 3 and len(outs[0]["resumed_blocks"]) == B // 3,
          f"{phase}: the survivors did not resume on 3 ranks of {B // 3} blocks")
    check(d_same, f"{phase}: the ranked sweep differs from (a)")

    # (e) drift of the cost model against the traced runs (a finding, not a gate).
    rep = drift.drift_report(residuals, profile=profile)
    emit(f"{phase}/drift", profile_kind=rep.profile_kind, stale=rep.stale,
         median_ratio=rep.median_ratio, per_variant=rep.per_variant,
         n_residuals=len(rep.residuals), recommendation=rep.recommendation,
         residuals=rep.as_dict()["residuals"])
    print(rep.describe(), flush=True)

    # (f) the chaos lane of the serving demo, with its trace and metrics.
    t0 = time.perf_counter()
    from repro_torch.launch import serve

    trace_path, metrics_path = SWEEP_ROOT / "chaos_trace.json", SWEEP_ROOT / "chaos_metrics.json"
    report = serve.main(["--mode", "retrieval", "--chaos", "--trace-out", str(trace_path),
                         "--metrics-out", str(metrics_path)])
    events = json.loads(trace_path.read_text())["traceEvents"]
    query_spans = sum(e.get("name") == "serving/query" for e in events)
    snap = json.loads(metrics_path.read_text())
    fraction = snap["histograms"].get("serving.live_tile_fraction", {})
    emit(f"{phase}/chaos", fired=report["fired"], differ=report["differ"], ok=report["ok"],
         queries=report["queries"], stats=report["stats"], qps=report["qps"],
         trace_events=len(events), serving_query_spans=query_spans,
         live_tile_fraction=fraction, seconds=time.perf_counter() - t0)
    check(report["fired"].get("error:serving.kernel", 0) > 0 and not report["differ"],
          f"{phase}: the chaos lane fired {report['fired']}, differ {report['differ']}")
    check(query_spans > 0 and fraction.get("count", 0) > 0,
          f"{phase}: the chaos lane's trace or metrics lack the serving spans or histogram")

    # K4 at one step's shape (the kill step), against its plain version.
    s = SWEEP_KILL
    blocks = np.arange(B)
    ij = torch.from_numpy(np.stack([blocks, (blocks - s) % B]).astype(np.int32))
    kk = dict(block_q=block_rows, block_c=block_rows, nc_valid=int(radikal.shape[0]),
              col_live=col_live, qpos=qpos)
    cmp1 = compare(np, as_rows(np, *fused.rect_tile_candidates_kernel(Dd, Dd, ij, t, k, **kk)),
                   as_rows(np, *fused.rect_tile_candidates_plain(Dd, Dd, ij, t, k, **kk)), t,
                   masked_near(np, torch, Dd, Dd, ij, block_rows, col_live, qpos, t))
    check(cmp1["ok"], f"{phase}: K4 at a sweep step disagrees with its plain version: {cmp1}")
    flop, nbytes = masked_work(np, [((Dd, Dd, ij, t, k), kk)], k, int(radikal.shape[1]))
    Db = Dd.view(B, block_rows, -1)
    jb = ij[1].to(Dd.device).long()
    Cb = Db[jb]  # the partner blocks, gathered outside the yardstick's time
    row = kernel_row(
        np, torch, "rect_tile_candidates_masked", phase,
        {"rect_tile_candidates_masked": launches["rect_tile_candidates_masked"]}, cmp1,
        lambda: fused.rect_tile_candidates_kernel(Dd, Dd, ij, t, k, **kk),
        lambda: fused.rect_tile_candidates_plain(Dd, Dd, ij, t, k, **kk),
        lambda: library_sweep(torch, Db, Cb, jb, t, k, bn=block_rows,
                              nc_valid=kk["nc_valid"], col_live=col_live, qpos=qpos),
        flop, nbytes,
    )
    split = fused.rect_work_split(B, Dd.shape[1], block_rows, block_rows)
    row.update(step=s, shape=[B, block_rows, block_rows, int(Dd.shape[1])],
               sweep_wall_ms=wall, k4_step_ms_median=statistics.median(step_ms),
               **rect_split_fields(split, block_rows))
    del Dd, Db, Cb, col_live, qpos
    torch.cuda.empty_cache()
    emit(f"{phase}/done", seconds=time.perf_counter() - t_phase)
    return row


def kernel_row(np, torch, name, phase, launches, cmp, kernel, plain, library,
               flop, nbytes, peak=PEAK_F32_FLOPS) -> dict:
    clocks_before = clocks()
    ms = time_ms(np, torch, kernel)
    clocks_after = clocks()
    plain_ms = time_ms(np, torch, plain)
    library_ms = time_ms(np, torch, library)
    bound_ms, bound_by = bound(flop, nbytes, peak)
    return dict(
        name=f"{name}[{phase}]", **KERNEL_INFO[name],
        launches=launches[name], max_abs_err=cmp["max_abs_err"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, flop=flop, bytes=nbytes,
        near_tie_swaps=cmp.get("near_tie_swaps"),
        clocks=[clocks_before, clocks_after],
    )


CLOCK_QUERY = "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature, as
    ``nvidia-smi`` prints them (``CLOCK_QUERY``)."""
    return subprocess.run(["nvidia-smi", CLOCK_QUERY, "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
