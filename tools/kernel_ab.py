#!/usr/bin/env python3
"""Same-card A/B of design variants of the port's K1 and K4 kernels.

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
``nvcc``:

    python3 tools/kernel_ab.py k1_merge     # K1: rank merge, k rounds of selection, none
    python3 tools/kernel_ab.py k1_layout    # K1: 8 x 8 scores a thread, 16 x 4, 16 x 4 in 4 stages
    python3 tools/kernel_ab.py k4_strip     # K4: corpus strips of up to 8 or 4 rows a thread

Each variant is the kernel's source in this checkout with one text
substitution, built by ``nvcc`` with the port's flags into
``build/kernel_ab/<experiment>/<variant>/`` and loaded in place of the
port's library, so the wrapper, the inputs and the launch shape are the
port's own. The variants run in turns, two (K1) or three (K4) rounds, each
time the median of 5 (K1) or 7 (K4) CUDA-event runs after a warm-up, on
the cells of ``chip_smoke.py``: K1 on clustered_65k and radikal_full, K4 on
serve_radikal_full at B = 64 and 8. Every variant's output is held to the
first variant's (``same``; the variant without a merge only in its counts).
The card's name, power limit and SM clock are printed before and after;
each variant's ``-Xptxas -v`` registers and spills after its build.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/apss_block/csrc"

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


def k1_merge(src: str) -> dict:
    a, b = src.index("      int n_new = 0;"), src.index(MERGE_CALL) + len(MERGE_CALL)
    return {"rank": src, "rounds": src[:a] + ROUNDS + src[b:],
            "nomerge": _sub(src, COUNT, COUNT + "      continue;\n")}


def k1_layout(src: str) -> dict:
    tall = _sub(src, "constexpr int FRM = 8, FRN = 8;", "constexpr int FRM = 16, FRN = 4;")
    return {"sq": src, "tall": tall,
            "tall_st4": _sub(tall, "sizeof(T) == 4 ? 3 : 4", "sizeof(T) == 4 ? 4 : 4")}


def k4_strip(src: str) -> dict:
    rn4 = _sub(src, "sc = block_c < 8 * txn ? block_c : 8 * txn;",
               "sc = block_c < 4 * txn ? block_c : 4 * txn;")
    return {"rn8": src, "rn4": rn4,
            "rn4_st3": _sub(rn4, "constexpr int RECT_STAGES = 4;",
                            "constexpr int RECT_STAGES = 3;")}


EXPERIMENTS = {  # name: (library, source, variants, segment counts to force)
    "k1_merge": ("apss_fused", "apss_fused.cu", k1_merge, {"clustered": 9, "radikal": 5}),
    "k1_layout": ("apss_fused", "apss_fused.cu", k1_layout, {}),
    "k4_strip": ("rect_tile_candidates", "rect_tile_candidates.cu", k4_strip, {}),
}


def build(name: str, lib: str, variants: dict) -> dict:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "kernel_ab" / name
    procs = {}
    for v, text in variants.items():
        d = out / v
        d.mkdir(parents=True, exist_ok=True)
        (d / "kernel.cu").write_text(text)
        (d / "apss_common.cuh").write_text((CSRC / "apss_common.cuh").read_text())
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "kernel.cu")]
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
    libs = build(name, lib, variants((CSRC / source).read_text()))
    if lib == "apss_fused":
        run_k1(np, torch, libs, forced)
    else:
        run_k4(np, torch, libs)
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
