#!/usr/bin/env python3
"""Same-card A/B of design variants of the port's K1, K4, K6 and K9 kernels.

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
``nvcc``:

    python3 tools/kernel_ab.py k1_merge     # K1: rank merge, k rounds of selection, none
    python3 tools/kernel_ab.py k1_layout    # K1: 8 x 8 scores a thread, 16 x 4, 16 x 4 in 4 stages
    python3 tools/kernel_ab.py k4_strip     # K4: corpus strips of up to 8 or 4 rows a thread
    python3 tools/kernel_ab.py k6_strip     # K6: the same strips on its support-width operands
    python3 tools/kernel_ab.py k9_split     # K9: 4 or 8 rows a lane in flight x split 512-4096

Each variant is the kernel's sources in this checkout (the ``.cu`` and the
headers beside it) with one text substitution, built by ``nvcc`` with the
port's flags into ``build/kernel_ab/<experiment>/<variant>/`` and loaded in
place of the port's library, so the wrapper, the inputs and the launch
shape are the port's own (K9's split is the wrapper's
``DECODE_SPLIT_VALUES``, set per run). The variants run in turns, two (K1)
or three (K4, K6, K9) rounds, each time the median of 5 (K1) or 7 CUDA-event
runs after a warm-up, on the cells of ``chip_smoke.py``: K1 on clustered_65k
and radikal_full, K4 on serve_radikal_full at B = 64 and 8, K6 on the
sparse index of serve_radikal_full at B = 64 and 8 and on
serve_sparse_clustered_65k at B = 64, K9 at the decode cell's shapes
(8, 16, 8, 32768, 128) bf16 and lengths. Every variant's output is held to
the first variant's (``same``; the variant without a merge only in its
counts; K9's to the plain version's at the smoke run's tolerances). The
library call of each cell is timed beside them. The card's name, power
limit and SM clock are printed before and after; each variant's ``-Xptxas
-v`` registers and spills after its build.
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


EXPERIMENTS = {  # name: (library, source, variants, segment counts to force)
    "k1_merge": ("apss_fused", "apss_block/csrc/apss_fused.cu", k1_merge,
                 {"clustered": 9, "radikal": 5}),
    "k1_layout": ("apss_fused", "apss_block/csrc/apss_fused.cu", k1_layout, {}),
    "k4_strip": ("rect_tile_candidates", "apss_block/csrc/rect_tile_candidates.cu", rect_strip,
                 {}),
    "k6_strip": ("rect_sparse_tile_candidates",
                 "apss_block/csrc/rect_sparse_tile_candidates.cu", rect_strip, {}),
    "k9_split": ("decode_attention", "decode_attention/csrc/decode_attention.cu", k9_rows, {}),
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


def run_k1(np, torch, libs: dict, forced: dict) -> None:
    from repro_torch.core.pruning import block_prune_mask
    from repro_torch.data.synthetic import clustered_corpus, synthetic_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.apss_block import fused
    from repro_torch.kernels.apss_block.ops import _pad_to, _pick_bk

    segments_for = fused.fused_segments_for
    cells = {
        "clustered": (lambda: clustered_corpus(65536, 768, 8, n_clusters=32, seed=0), 0.5),
        "radikal": (lambda: synthetic_corpus(6883, 136447, 1072472 / 6883, seed=0), 0.2),
    }
    for cell, (make, t) in cells.items():
        D = torch.from_numpy(make()).cuda()
        n, m = D.shape
        Dp = _pad_to(D, 256, _pick_bk(m, 512))
        mask = block_prune_mask(Dp, Dp, t, 256, 256, use_minsize=False)
        kw = dict(block_m=256, block_n=256, n_valid_cols=n, exclude_self=True)
        runs = [(v, None) for v in libs] + [(v, forced[cell]) for v in libs
                                            if v != "nomerge" and cell in forced]
        res, ref = {}, None
        for _ in range(2):
            for v, s in runs:
                _build._LIBS["apss_fused"] = libs[v]
                fused.fused_segments_for = segments_for if s is None else (lambda *a, s=s: s)
                fn = lambda: fused.apss_fused_kernel(Dp, Dp, mask, t, 32, **kw)  # noqa: E731
                out = fn()
                torch.cuda.synchronize()
                ref = out if ref is None else ref
                same = (bool(torch.equal(out[2], ref[2])) if v == "nomerge"
                        else all(torch.equal(a, b) for a, b in zip(out, ref)))
                key = v if s is None else f"{v}_s{s}"
                res.setdefault(key, []).append(dict(ms=time_ms(np, torch, fn, 5), same=same))
        fused.fused_segments_for = segments_for
        print(cell, json.dumps(res), flush=True)
        del D, Dp
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


def main() -> int:
    import numpy as np
    import torch

    if len(sys.argv) != 2 or sys.argv[1] not in EXPERIMENTS:
        print(f"usage: {sys.argv[0]} {{{'|'.join(EXPERIMENTS)}}}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    name = sys.argv[1]
    lib, source, variants, forced = EXPERIMENTS[name]
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    source = KERNELS / source
    files = {p.name: p.read_text() for p in [source, *source.parent.glob("*.cuh")]}
    libs = build(name, source.name, files, variants(files))
    run = {"apss_fused": lambda: run_k1(np, torch, libs, forced),
           "rect_tile_candidates": lambda: run_k4(np, torch, libs),
           "rect_sparse_tile_candidates": lambda: run_k6(np, torch, libs),
           "decode_attention": lambda: run_k9(np, torch, libs)}
    run[lib]()
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
