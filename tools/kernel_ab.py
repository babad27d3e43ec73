#!/usr/bin/env python3
"""Same-card A/B of design variants of the port's K1, K2, K3, K4, K6, K7 and K9 kernels.

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
``nvcc``:

    python3 tools/kernel_ab.py k1_merge     # K1: rank merge, k rounds of selection, none
    python3 tools/kernel_ab.py k1_layout    # K1: 8 x 8 scores a thread, 16 x 4, 16 x 4 in 4 stages
    python3 tools/kernel_ab.py k1_walk --base build/parent  # K1: the parent's, the chunk
                                            #     walk, the walk over every chunk
    python3 tools/kernel_ab.py k4_strip     # K4: corpus strips of up to 8 or 4 rows a thread
    python3 tools/kernel_ab.py k6_strip     # K6: the same strips on its support-width operands
    python3 tools/kernel_ab.py k9_split     # K9: 4 or 8 rows a lane in flight x split 512-4096
    python3 tools/kernel_ab.py k7_tile      # K7: 128 x 128 or 128 x 256 tiles, 4 or 3 stages,
                                            #     grouped or row-major order, stage sums or one
    python3 tools/kernel_ab.py k3_tile      # K3: 3 or 4 stages, 128 x 128 or 128 x 64 work items
    python3 tools/kernel_ab.py k2_tile      # K2: the same variants of their shared tile_items.cuh
    python3 tools/kernel_ab.py k2_tile --base build/parent  # and the parent's K2 first

Each variant is the kernel's sources in this checkout (the ``.cu`` and the
headers beside it) with one text substitution, built by ``nvcc`` with the
port's flags into ``build/kernel_ab/<experiment>/<variant>/`` and loaded in
place of the port's library, so the wrapper, the inputs and the launch
shape are the port's own (K9's split is the wrapper's
``DECODE_SPLIT_VALUES``, set per run). With ``--base CHECKOUT`` (another
checkout of the repo, such as the parent commit unpacked by ``git
archive``) the kernel's source and headers there run first, as variant
``base`` (K1's through that checkout's own wrapper, ``fused.py``, since
the two may differ in their entry points). The variants run in turns, two
(K1) or three (K2, K3, K4, K6, K7, K9) rounds, each time the median of 5
(K1, K7) or 7 CUDA-event runs after a warm-up, on the cells of
``chip_smoke.py``: K1 on clustered_65k, radikal_full, the ring step of
distributed_radikal_full and dedup_radikal_full (with the stages each
variant walked), K4 on serve_radikal_full at B = 64 and 8, K6 on the
sparse index of serve_radikal_full at B = 64 and 8 and on
serve_sparse_clustered_65k at B = 64, K9 at the decode cell's shapes (8,
16, 8, 32768, 128) bf16 and lengths, K7 on k7_radikal_full (f32), K3 on
sparse_radikal_full and sparse_clustered_65k and K2 on radikal_full and
clustered_65k, with the operands the main paths build. Every variant's
output is held to the first variant's (``same``; the variant without a
merge only in its counts; K9's to the plain version's at the smoke run's
tolerances; K7's largest |difference|, ``max_abs_diff``, since its
variants sum in other orders, and each K7 variant's largest error on 1,024
rows against float64). The library call of each cell is timed beside
them. The card's name, power limit and SM clock are printed before and
after; each variant's ``-Xptxas -v`` registers and spills after its build.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src/repro_torch/kernels"

# The k rounds of warp-wide first-in-order selection that K1 ran before its
# rank merge (merge_row), in place of the block from `int n_new` to the call.
ROUNDS = """      for (int e = lane; e < k; e += 32) {
        mv[e] = tv[e];
        mi[e] = ti[e];
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        mv[k + lane + 32 * h] = enter[h] ? s[h] : NEG_LARGE;
        mi[k + lane + 32 * h] = enter[h] ? g[h] : -1;
      }
      __syncwarp();
      for (int slot = 0; slot < k; ++slot) {
        float bv = NEG_LARGE;
        int bi = 0x7fffffff, bp = 0;
        for (int e = lane; e < k + FT; e += 32) {
          if (before(mv[e], mi[e], bv, bi)) {
            bv = mv[e];
            bi = mi[e];
            bp = e;
          }
        }
        warp_first(bv, bi, bp);
        if (bv <= VALID) {
          for (int e = slot + lane; e < k; e += 32) {
            tv[e] = NEG_LARGE;
            ti[e] = -1;
          }
          break;
        }
        if (lane == 0) {
          tv[slot] = bv;
          ti[slot] = bi;
          mv[bp] = NEG_LARGE;
          mi[bp] = -1;
        }
        __syncwarp();
      }
"""
MERGE_CALL = "      merge_row(mv, mi, k, n_new, tv, ti);\n"
COUNT = "      if (lane == 0) cnt[r] += n_ok;\n"


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the source no longer holds {old!r}: update the experiment")
    return src.replace(old, new)


def k1_merge(src: dict) -> dict:
    cu = src["apss_fused.cu"]
    a, b = cu.index("      int n_new = 0;"), cu.index(MERGE_CALL) + len(MERGE_CALL)
    return {"rank": {}, "rounds": {"apss_fused.cu": cu[:a] + ROUNDS + cu[b:]},
            "nomerge": {"apss_fused.cu": _sub(cu, COUNT, COUNT + "      continue;\n")}}


def k1_layout(src: dict) -> dict:
    tall = _sub(src["apss_fused.cu"], "constexpr int FRM = 8, FRN = 8;",
                "constexpr int FRM = 16, FRN = 4;")
    return {"sq": {}, "tall": {"apss_fused.cu": tall},
            "tall_st4": {"apss_fused.cu": _sub(tall, "sizeof(T) == 4 ? 3 : 4",
                                               "sizeof(T) == 4 ? 4 : 4")}}


def k1_walk(src: dict) -> dict:
    """K1 walking the chunks both row tiles hold (the port's), and every
    chunk (its bitmaps still made, so the step-0 launch costs alike)."""
    return {"walk": {}, "dense": {"apss_fused.cu": _sub(
        src["apss_fused.cu"], "const ChunkWalk walk(ox, occ_y + (long long)ct * 2 * words, words);",
        "const Contiguous walk{m / PK};")}}


def rect_strip(src: dict) -> dict:
    """K4's and K6's strips (rect_tiles.cuh): up to 8 corpus rows a thread,
    up to 4, and 4 in a 3-stage ring."""
    rn4 = _sub(src["rect_tiles.cuh"], "sc = block_c < 8 * txn ? block_c : 8 * txn;",
               "sc = block_c < 4 * txn ? block_c : 4 * txn;")
    return {"rn8": {}, "rn4": {"rect_tiles.cuh": rn4},
            "rn4_st3": {"rect_tiles.cuh": _sub(rn4, "constexpr int RECT_STAGES = 4;",
                                               "constexpr int RECT_STAGES = 3;")}}


def k9_rows(src: dict) -> dict:
    """K9's rows of K and V in flight per lane group: 4 (the port's) or 8."""
    return {"u4": {}, "u8": {"decode_attention.cu": _sub(
        src["decode_attention.cu"], "constexpr int U = 4;", "constexpr int U = 8;")}}


def k7_tile(src: dict) -> dict:
    """K7's output tile (128 x 128, or 128 x 256 as two accumulator halves),
    ring stages of its f32 path (4 or 3; 4 do not fit 128 x 256), tile order
    (groups of 8 row tiles, or row-major: groups of 1), and the per-stage
    sums against one tensor-core sum over all features."""
    cu = src["apss_block.cu"]
    return {"t128_s4": {},
            "t128_s3": {"apss_block.cu": _sub(cu, "constexpr int F32_STAGES = BN == NH ? 4 : 3;",
                                              "constexpr int F32_STAGES = 3;")},
            "t128_s4_rowmajor": {"apss_block.cu": _sub(cu, "constexpr int GROUP = 8;",
                                                       "constexpr int GROUP = 1;")},
            "t256_s3": {"apss_block.cu": _sub(cu, "constexpr int BN = 128;",
                                              "constexpr int BN = 256;")},
            "t128_s4_onesum": {"apss_block.cu": _sub(cu, "constexpr bool STAGE_SUMS = true;",
                                                     "constexpr bool STAGE_SUMS = false;")}}


def tile_items(src: dict) -> dict:
    """The ring stages (3 or 4) and work items (128 x 128 or 128 x 64
    scores) of K2 and K3, which share tile_items.cuh."""
    h = src["tile_items.cuh"]
    return {"i128_s3": {},
            "i128_s4": {"tile_items.cuh": _sub(h, "constexpr int ITEM_STAGES = 3;",
                                               "constexpr int ITEM_STAGES = 4;")},
            "i64_s3": {"tile_items.cuh": _sub(h, "constexpr int ITEM_C = 128;",
                                              "constexpr int ITEM_C = 64;")}}


EXPERIMENTS = {  # name: (library, source, variants, segment counts to force)
    "k1_merge": ("apss_fused", "apss_block/csrc/apss_fused.cu", k1_merge,
                 {"clustered": 9, "radikal": 5}),
    "k1_layout": ("apss_fused", "apss_block/csrc/apss_fused.cu", k1_layout, {}),
    "k1_walk": ("apss_fused", "apss_block/csrc/apss_fused.cu", k1_walk, {}),
    "k4_strip": ("rect_tile_candidates", "apss_block/csrc/rect_tile_candidates.cu", rect_strip,
                 {}),
    "k6_strip": ("rect_sparse_tile_candidates",
                 "apss_block/csrc/rect_sparse_tile_candidates.cu", rect_strip, {}),
    "k9_split": ("decode_attention", "decode_attention/csrc/decode_attention.cu", k9_rows, {}),
    "k7_tile": ("apss_block", "apss_block/csrc/apss_block.cu", k7_tile, {}),
    "k3_tile": ("sparse_tile_candidates", "apss_block/csrc/sparse_tile_candidates.cu",
                tile_items, {}),
    "k2_tile": ("tile_candidates", "apss_block/csrc/tile_candidates.cu", tile_items, {}),
}
K9_SPLITS = (512, 1024, 2048, 4096)  # positions a block at D = 128


def build(name: str, source: str, files: dict, variants: dict) -> dict:
    """Builds each variant: ``files`` (name: text; the source and its
    headers) with the variant's files in place of the checkout's."""
    from repro_torch.kernels import _build

    out = ROOT / "build" / "kernel_ab" / name
    procs = {}
    for v, override in variants.items():
        d = out / v
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in {**files, **override}.items():
            (d / fname).write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)]
        procs[v] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    libs = {}
    for v, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{v}: nvcc failed\n{log}")
        print(v, json.dumps([line.split("info    :")[-1].strip() for line in log.splitlines()
                             if "registers" in line or "spill" in line]), flush=True)
        libs[v] = ctypes.CDLL(str(out / v / "lib.so"))
    return libs


def time_ms(np, torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def k1_cells(np, torch):
    """K1's cells of the smoke's kernel table, one at a time: ``(name, x, y,
    mask, t, k, kwargs)`` with the operands the main paths build."""
    import chip_smoke as cs
    from repro_torch.core.apss import normalize_rows
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.data.synthetic import clustered_corpus, synthetic_corpus
    from repro_torch.kernels.apss_block.ops import _pad_to, _padded_pair, _pick_bk

    def join(name, D, t, k):
        n, m = D.shape
        Dp = _pad_to(D, 256, _pick_bk(m, 512))
        mask = block_prune_mask(Dp, Dp, t, 256, 256, use_minsize=False)
        return (name, Dp, Dp, mask, t, k,
                dict(block_m=256, block_n=256, n_valid_cols=n, exclude_self=True))

    yield join("clustered", torch.from_numpy(
        clustered_corpus(65536, 768, 8, n_clusters=32, seed=0)).cuda(), 0.5, 32)
    R = synthetic_corpus(6883, 136447, 1072472 / 6883, seed=0)
    yield join("radikal", torch.from_numpy(R).cuda(), 0.2, 32)
    # distributed_radikal_full's ring step: rank 2's rows against rank 1's.
    n_loc, m_pad = 7168 // 4, 136448
    Dr = np.zeros((7168, m_pad), np.float32)
    Dr[:R.shape[0], :R.shape[1]] = R
    x, y = (torch.from_numpy(Dr[a * n_loc:(a + 1) * n_loc]).cuda() for a in (2, 1))
    del Dr
    _, nc, xp, yp, mask = _padded_pair(x, y, 0.2, None, True, 256, 256, _pick_bk(m_pad, 512),
                                       x.device)
    yield ("ring_step", xp, yp, mask, 0.2, 32,
           dict(block_m=256, block_n=256, n_valid_cols=nc, row_offset=2 * n_loc,
                col_offset=n_loc, exclude_self=True))
    del x, y, xp, yp
    # dedup_radikal_full: radikal and its planted copies, normalised.
    rng = np.random.default_rng(cs.DEDUP["seed"])
    src = np.sort(rng.choice(R.shape[0], cs.DEDUP["planted"], replace=False))
    X = normalize_rows(torch.from_numpy(np.concatenate([
        R, R[src] * (1 + cs.DEDUP["noise"] * rng.random((len(src), R.shape[1]),
                                                       dtype=np.float32))])).cuda())
    yield join("dedup", X, cs.DEDUP["threshold"], 64)


def run_k1(np, torch, libs: dict, forced: dict, base=None) -> None:
    import importlib.util

    from repro_torch.kernels import _build
    from repro_torch.kernels.apss_block import fused

    wrappers = {v: fused for v in libs}
    if base is not None and "base" in libs:  # the other checkout's K1 through its own wrapper
        path = base / "src/repro_torch/kernels/apss_block/fused.py"
        spec = importlib.util.spec_from_file_location("kernel_ab_base_fused", path)
        wrappers["base"] = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(wrappers["base"])
    segments_for = {v: w.fused_segments_for for v, w in wrappers.items()}
    for cell, x, y, mask, t, k, kw in k1_cells(np, torch):
        runs = [(v, None) for v in libs] + [(v, forced[cell]) for v in libs
                                            if v != "nomerge" and cell in forced]
        res, ref = {}, None
        for _ in range(2):
            for v, s in runs:
                _build._LIBS["apss_fused"] = libs[v]
                w = wrappers[v]
                w.fused_segments_for = segments_for[v] if s is None else (lambda *a, s=s: s)
                fn = lambda: w.apss_fused_kernel(x, y, mask, t, k, **kw)  # noqa: E731
                out = fn()
                torch.cuda.synchronize()
                ref = out if ref is None else ref
                same = (bool(torch.equal(out[2], ref[2])) if v == "nomerge"
                        else all(torch.equal(a, b) for a, b in zip(out, ref)))
                key = v if s is None else f"{v}_s{s}"
                walk = getattr(w, "last_walk", lambda: None)()
                res.setdefault(key, []).append(dict(ms=time_ms(np, torch, fn, 5), same=same,
                                                    stages=walk))
                w.fused_segments_for = segments_for[v]
        print(cell, json.dumps(res), flush=True)
        del x, y, mask, ref, out
        torch.cuda.empty_cache()


def run_k4(np, torch, libs: dict) -> None:
    import chip_smoke as cs
    from repro_torch.core.sparse import from_dense
    from repro_torch.data.sparse import perturbed_queries
    from repro_torch.data.synthetic import synthetic_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.apss_block import fused
    from repro_torch.serving import build_index

    D = torch.from_numpy(synthetic_corpus(6883, 136447, 1072472 / 6883, seed=0)).cuda()
    index = build_index(D, block_rows=256, normalize=False)
    Q = torch.from_numpy(perturbed_queries(from_dense(D), 64, seed=1)).cuda()
    res = {}
    for B in (64, 8):
        Qp, _, ij, _ = cs.serving_inputs(np, torch, index, Q[:B], 0.2, B)
        kw = dict(block_q=B, block_c=256, nc_valid=index.n)
        ref = None
        for _ in range(3):
            for v, lib in libs.items():
                _build._LIBS["rect_tile_candidates"] = lib
                fn = lambda: fused.rect_tile_candidates_kernel(  # noqa: E731
                    Qp, index.corpus, ij, 0.2, 32, **kw)
                out = fn()
                torch.cuda.synchronize()
                ref = out if ref is None else ref
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                res.setdefault(f"B{B}_{v}", []).append(dict(ms=time_ms(np, torch, fn, 7),
                                                            same=same))
        res[f"B{B}_library"] = time_ms(
            np, torch, lambda: cs.library_rect(torch, Qp[:B], index.corpus, 0.2, 32), 7)
    print("serve_radikal_full", json.dumps(res), flush=True)


def run_k6(np, torch, libs: dict) -> None:
    import chip_smoke as cs
    from repro_torch.core.sparse import from_dense
    from repro_torch.data.sparse import perturbed_queries, sparse_clustered_corpus
    from repro_torch.data.synthetic import synthetic_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.apss_block import sparse
    from repro_torch.kernels.apss_block.fused import _rect_tile_packets
    from repro_torch.serving import build_index

    cells = {  # cell: (corpus, threshold, batches)
        "serve_radikal_full": (lambda: from_dense(torch.from_numpy(synthetic_corpus(
            6883, 136447, 1072472 / 6883, seed=0)).cuda()), 0.2, (64, 8)),
        "serve_sparse_clustered_65k": (lambda: sparse_clustered_corpus(
            65536, 8192, 16.0, n_clusters=32, seed=0), 0.5, (64,)),
    }
    for cell, (make, t, batches) in cells.items():
        sp = make()
        index = build_index(sp, block_rows=256, normalize=False)
        Q = torch.from_numpy(perturbed_queries(sp, 64, seed=1)).cuda()
        res = {}
        for B in batches:
            Qp, _, ij, _ = cs.serving_inputs(np, torch, index, Q[:B], t, B)
            qg = sparse.gather_query_tiles(Qp, index.bdims, ij, B)
            cj = ij[1].long()
            ref = None
            for _ in range(3):
                for v, lib in libs.items():
                    _build._LIBS["rect_sparse_tile_candidates"] = lib
                    fn = lambda: sparse.rect_sparse_tile_candidates_kernel(  # noqa: E731
                        qg, index.bx, ij, t, 32, nc_valid=index.n)
                    out = fn()
                    torch.cuda.synchronize()
                    ref = out if ref is None else ref
                    same = all(torch.equal(a, b) for a, b in zip(out, ref))
                    res.setdefault(f"B{B}_{v}", []).append(dict(ms=time_ms(np, torch, fn, 7),
                                                                same=same))
            res[f"B{B}_library"] = time_ms(np, torch, lambda: _rect_tile_packets(
                torch.bmm(qg, index.bx[cj].transpose(1, 2)), cj, threshold=t, k=32,
                block_q=B, block_c=256, nc_valid=index.n), 7)
            res[f"B{B}_support_S"] = qg.shape[2]
        print(cell, json.dumps(res), flush=True)
        del sp, index
        torch.cuda.empty_cache()


def run_k9(np, torch, libs: dict) -> None:
    import importlib

    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build

    k9 = importlib.import_module("repro_torch.kernels.decode_attention.decode_attention")
    B, Hq, Hkv, L, D = 8, 16, 8, 32768, 128
    lens = np.random.default_rng(0).integers(1, L, size=B)  # lm_decode_phase's lengths
    lens[0] = L - 1
    lens_t = torch.from_numpy(lens.astype(np.int32)).cuda()
    g = torch.Generator("cuda").manual_seed(2)
    k = torch.randn((B, Hkv, L, D), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, L, D), generator=g, device="cuda").bfloat16()
    q = torch.randn((B, Hq, D), generator=g, device="cuda").bfloat16()
    want = k9.decode_attention_plain(q, k, v, lens_t)
    default, res = k9.DECODE_SPLIT_VALUES, {}
    for _ in range(3):
        for v_name, lib in libs.items():
            _build._LIBS["decode_attention"] = lib
            for split in K9_SPLITS:
                k9.DECODE_SPLIT_VALUES = split * D
                fn = lambda: k9.decode_attention_kernel(q, k, v, lens_t)  # noqa: E731
                cmp = cs._k9_compare(torch, fn(), want)
                res.setdefault(f"{v_name}_split{split}", []).append(dict(
                    ms=time_ms(np, torch, fn, 7), ok=cs._k9_ok(cmp, "bfloat16")))
    k9.DECODE_SPLIT_VALUES = default
    mask = (torch.arange(L, device="cuda")[None, :] < lens_t[:, None])[:, None, None, :]
    res["library"] = time_ms(np, torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, scale=1.0 / D ** 0.5, enable_gqa=True), 7)
    print("lm_decode_qwen3_1_7b_32k", json.dumps(res), flush=True)


def run_k7(np, torch, libs: dict) -> None:
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.data.synthetic import synthetic_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.apss_block import apss_block
    from repro_torch.kernels.apss_block.ops import _pad_to

    D = torch.from_numpy(synthetic_corpus(6883, 136447, 1072472 / 6883, seed=0)).cuda()
    Dp = _pad_to(D, 256, 512)  # apss_block_matmul's padding
    mask = block_prune_mask(Dp, Dp, 0.2, 256, 256, use_minsize=False)
    xs = Dp[:1024]  # every score of 1,024 rows against the float64 product
    exact = xs.double() @ xs.double().T
    ones = torch.ones((4, 4), dtype=torch.int32)
    res, ref = {}, None
    for _ in range(3):
        for v, lib in libs.items():
            _build._LIBS["apss_block"] = lib
            fn = lambda: apss_block.apss_block_kernel(Dp, Dp, mask, 0.2)  # noqa: E731
            out = fn()
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            res.setdefault(v, []).append(dict(ms=time_ms(np, torch, fn, 5),
                                              max_abs_diff=float((out - ref).abs().max())))
            del out
            if v + "_f64_err" not in res:
                s64 = apss_block.apss_block_kernel(xs, xs, ones, -2.0).double()
                res[v + "_f64_err"] = float((s64 - exact).abs().max())

    def library():
        s = torch.matmul(D, D.T)
        return torch.where(s >= 0.2, s, 0.0)

    res["library"] = time_ms(np, torch, library, 5)
    print("k7_radikal_full", json.dumps(res), flush=True)


def k3_inputs(np, torch, sp, t: float, bm: int = 256):
    """K3's operands as ``apss_blocked(sp, use_kernel=True)`` builds them."""
    from repro_torch.core.pruning import live_tile_mask, sparse_block_stats
    from repro_torch.core.sparse import pad_rows_sparse
    from repro_torch.kernels.apss_block import sparse
    from repro_torch.kernels.apss_block.ops import compact_worklist

    spp, _ = pad_rows_sparse(sp, bm)
    grid = spp.n // bm
    stats = sparse_block_stats(spp, bm)
    mask, ub = live_tile_mask(stats, stats, t, return_ub=True)
    ij = torch.as_tensor(compact_worklist(mask, ub)).cuda()
    bdims, bx = sparse.block_support_gather(spp, bm)
    bx, bdims = torch.from_numpy(bx).cuda(), torch.from_numpy(bdims).cuda()
    yg = sparse.gather_tiles(bdims, spp.indices.reshape(grid, bm, spp.cap),
                             spp.values.reshape(grid, bm, spp.cap), ij)
    return bx, yg, ij


def run_k3(np, torch, libs: dict) -> None:
    from repro_torch.core.sparse import from_dense
    from repro_torch.data.sparse import sparse_clustered_corpus
    from repro_torch.data.synthetic import synthetic_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.apss_block import sparse
    from repro_torch.kernels.apss_block.fused import _tile_packets

    cells = {  # cell: (corpus, threshold)
        "sparse_radikal_full": (lambda: from_dense(torch.from_numpy(synthetic_corpus(
            6883, 136447, 1072472 / 6883, seed=0)).cuda()), 0.2),
        "sparse_clustered_65k": (lambda: sparse_clustered_corpus(
            65536, 8192, 16.0, n_clusters=32, seed=0), 0.5),
    }
    for cell, (make, t) in cells.items():
        sp = make()
        bx, yg, ij = k3_inputs(np, torch, sp, t)
        res, ref = {}, None
        for _ in range(3):
            for v, lib in libs.items():
                _build._LIBS["sparse_tile_candidates"] = lib
                fn = lambda: sparse.sparse_tile_candidates_kernel(  # noqa: E731
                    bx, yg, ij, t, 32, n_valid=sp.n)
                out = fn()
                torch.cuda.synchronize()
                ref = out if ref is None else ref
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                res.setdefault(v, []).append(dict(ms=time_ms(np, torch, fn, 7), same=same))
        ib = ij[0].long()
        res["library"] = time_ms(np, torch, lambda: _tile_packets(
            torch.bmm(bx[ib], yg.transpose(1, 2)), ij[0], ij[1], threshold=t, k=32,
            block_m=256, block_n=256, n_valid=sp.n), 7)
        res["support_S"], res["worklist_T"] = bx.shape[2], ij.shape[1]
        print(cell, json.dumps(res), flush=True)
        del sp, bx, yg, ij
        torch.cuda.empty_cache()


def run_k2(np, torch, libs: dict) -> None:
    import chip_smoke as cs
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.data.synthetic import clustered_corpus, synthetic_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.apss_block import fused
    from repro_torch.kernels.apss_block.ops import _pad_to, _pick_bk, compact_worklist

    cells = {  # cell: (corpus, threshold), as chip_smoke.py's main path
        "radikal_full": (lambda: synthetic_corpus(6883, 136447, 1072472 / 6883, seed=0), 0.2),
        "clustered_65k": (lambda: clustered_corpus(65536, 768, 8, n_clusters=32, seed=0), 0.5),
    }
    for cell, (make, t) in cells.items():
        D = torch.from_numpy(make()).cuda()
        n, m = D.shape
        Dp = _pad_to(D, 256, _pick_bk(m, 512))  # apss_fused_compacted's operands
        mask, ub = block_prune_mask(Dp, Dp, t, 256, 256, return_ub=True)
        ij = torch.as_tensor(compact_worklist(mask, ub)).cuda()
        kw = dict(block_m=256, block_n=256, n_valid=n)
        res, ref = {}, None
        for _ in range(3):
            for v, lib in libs.items():
                _build._LIBS["tile_candidates"] = lib
                fn = lambda: fused.apss_tile_candidates_kernel(Dp, ij, t, 32, **kw)  # noqa: E731
                out = fn()
                torch.cuda.synchronize()
                ref = out if ref is None else ref
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                res.setdefault(v, []).append(dict(ms=time_ms(np, torch, fn, 7), same=same))
        res["library"] = time_ms(np, torch, lambda: cs.library_topk(torch, D, t, 32), 7)
        res["worklist_T"] = ij.shape[1]
        print(cell, json.dumps(res), flush=True)
        del D, Dp, ij, ref
        torch.cuda.empty_cache()


def main() -> int:
    import numpy as np
    import torch

    args = sys.argv[1:]
    base = None
    if len(args) == 3 and args[1] == "--base":
        base, args = Path(args[2]).resolve(), args[:1]
    if len(args) != 1 or args[0] not in EXPERIMENTS:
        print(f"usage: {sys.argv[0]} {{{'|'.join(EXPERIMENTS)}}} [--base CHECKOUT]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    name = args[0]
    lib, source, variants, forced = EXPERIMENTS[name]
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    source = KERNELS / source
    files = {p.name: p.read_text() for p in [source, *source.parent.glob("*.cuh")]}
    runs = variants(files)
    if base is not None:  # the other checkout's source and headers, timed first
        other = base / source.relative_to(ROOT)
        runs = {"base": {p.name: p.read_text()
                         for p in [other, *other.parent.glob("*.cuh")]}, **runs}
    libs = build(name, source.name, files, runs)
    run = {"apss_fused": lambda: run_k1(np, torch, libs, forced, base),
           "rect_tile_candidates": lambda: run_k4(np, torch, libs),
           "rect_sparse_tile_candidates": lambda: run_k6(np, torch, libs),
           "decode_attention": lambda: run_k9(np, torch, libs),
           "apss_block": lambda: run_k7(np, torch, libs),
           "sparse_tile_candidates": lambda: run_k3(np, torch, libs),
           "tile_candidates": lambda: run_k2(np, torch, libs)}
    run[lib]()
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
