"""Dry run: every (arch × shape) cell as one rank of the production mesh
sees it, with no card and no other ranks.

The reference lowers and compiles each cell on 512 placeholder devices and
reads XLA's memory and cost analyses. Eager PyTorch compiles nothing, so
this plays rank 0 of the mesh in one process: a ``torch.distributed``
process group of the mesh's world size on the ``fake`` backend (every
collective returns at once) and a ``DeviceMesh`` over it, the cell's
arguments as meta tensors of rank 0's local shapes under the port's own
layout (``CellBuild.layout``: batch and cache splits, an LM's weights and
its AdamW moments by ``transformer.layout_specs``: tensor parallel over
``model`` (heads whole, zero-padded to a split where ``model`` does not
divide them: ``local_shape`` prices a rank's padded and shared head
blocks), FSDP over the data axes in ``train_4k``; a recsys model's by
``recsys.layout_specs``, tables and towers over ``model``; a graph's nodes
and edges over the data axes by ``gnn.graph_specs``),
and the cell's ``fn`` run once under ``launch.op_analysis``'s census. The
collective helpers of ``core.distributed`` see meta tensors, report to
the census and return meta results without touching the group. On the
meta device every path is the plain one (no kernel launches).

Per cell it writes JSON under ``--out``:
  - census FLOPs, HBM bytes, collectives and link bytes (per kind and per
    group size) of rank 0;
  - ``resident_bytes``: rank 0's arguments under the port's layout;
  - ``spec_bytes``: what the reference's specs (``in_shardings``) would
    place on one device, from the specs and the mesh sizes alone;
  - ``peak_live_bytes``: an estimate of the largest sum of live storages
    during the call (no allocator rounding, no workspaces);
  - the roofline terms and the dominant one.

PyTorch runs most meta kernels in Python (a few hundred µs an op), and a
32k prefill dispatches about 80,000 ops a layer. So an LM cell of more
than 2 repeated layers is counted at ``first_k_dense + 1`` and ``+ 2``
layers and every count extrapolated linearly to the full depth (exact for
identical layers, as the reference's trip-count multiplication of loop
bodies): ``layers_counted`` says so. ``peak_live_bytes`` extrapolates the
excess over the resident arguments the same way.

The APSS cells prune on data values in host numpy, which meta tensors do
not hold: for them the census is ``null`` with the reason. A cell whose
call fails on meta is recorded with the failing op and listed at the end.

Roofline constants: NVIDIA H100 SXM spec-sheet figures, not measurements.

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--subprocess]
  python -m repro_torch.launch.dryrun --table build/dryrun   # markdown table
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh data=2,model=2 --smoke        # a small mesh, the smoke config
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

# --- NVIDIA H100 SXM spec-sheet figures (not measured) ---
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12           # HBM3 bytes/s per card
NVLINK_BW = 450e9          # NVLink bytes/s per direction, within one node
IB_BW = 50e9               # bytes/s per card between nodes (400 Gb/s InfiniBand)
NODE_RANKS = 8             # cards in one NVLink node

APSS_REASON = ("the APSS cells prune on data values in host numpy "
               "(core/pruning.py); meta tensors hold none")


def roofline_terms(flops: float, hbm_bytes: float, link_by_group: dict) -> dict:
    """Compute, memory and collective seconds and the dominant term. A
    collective over a group of at most :data:`NODE_RANKS` ranks is taken to
    run on NVLink, a larger one on InfiniBand (a 16-rank axis of the
    production mesh spans two nodes)."""
    nvlink = sum(b for g, b in link_by_group.items() if int(g) <= NODE_RANKS)
    ib = sum(b for g, b in link_by_group.items() if int(g) > NODE_RANKS)
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": nvlink / NVLINK_BW + ib / IB_BW,
    }
    terms["dominant"] = max(("compute", terms["compute_s"]), ("memory", terms["memory_s"]),
                            ("collective", terms["collective_s"]), key=lambda kv: kv[1])[0]
    terms["link_bytes_nvlink"], terms["link_bytes_ib"] = nvlink, ib
    return terms


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "true"):
        return k, True
    if v in ("False", "false"):
        return k, False
    return k, v


def apply_overrides(cfg, overrides: list):
    """``key=value`` overrides onto a dataclass or dict config."""
    kv = dict(_parse_override(o) for o in overrides)
    if not kv:
        return cfg
    if isinstance(cfg, dict):
        out = dict(cfg)
        out.update(kv)
        return out
    return dataclasses.replace(cfg, **kv)


def parse_mesh(text: str) -> dict:
    """``"data=2,model=2"`` → ``{"data": 2, "model": 2}``."""
    return {k: int(v) for k, v in (part.split("=") for part in text.split(","))}


def mesh_name(sizes: dict) -> str:
    return "x".join(str(v) for v in sizes.values())


def fake_mesh(sizes: dict):
    """A ``DeviceMesh`` of ``sizes`` on which this process is rank 0 of a
    ``fake`` process group (created once per process)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for v in sizes.values():
        world *= v
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a fake group of {dist.get_world_size()} ranks exists; "
                               f"this mesh needs {world} (use --subprocess)")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", tuple(sizes.values()), mesh_dim_names=tuple(sizes))


def _materialize(args, layout, mesh, device="cpu"):
    """Rank-local arguments as real zero tensors (token ids 0): what a rank
    of a real mesh would hold, for a census on real ranks."""
    import torch

    from repro_torch.configs.base import local_args

    from repro_torch.models.layers import ParamTree

    def real(a):
        if isinstance(a, torch.nn.Module):
            # rebuilt, not moved: a rank's blocks carry their spec and mesh
            if getattr(a, "mesh", None) is None:
                a = a.to_empty(device=device)
            elif isinstance(a, ParamTree):
                a = a.rebuild(device, a.mesh)
            else:
                a = type(a)(a.cfg, device, a.mesh)
            with torch.no_grad():
                for p in a.parameters():
                    p.zero_()
            return a
        if isinstance(a, torch.Tensor):
            return torch.zeros(a.shape, dtype=a.dtype, device=device)
        if isinstance(a, dict):
            return {k: real(v) for k, v in a.items()}
        if hasattr(a, "_fields"):
            return type(a)(*(real(v) for v in a))
        return a

    return tuple(real(a) for a in local_args(args, layout, mesh))


def census_on_ranks(arch_name: str, shape: str, mesh, *, smoke: bool = True,
                    overrides: list = ()) -> dict:
    """The census of a cell's ``fn`` on this rank of a real ``mesh`` (every
    rank calls it), on zero arguments of the rank's local shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.op_analysis import analyze

    arch = get_arch(arch_name)
    cfg = apply_overrides(arch.make_smoke_config() if smoke else arch.make_config(),
                          list(overrides))
    build = arch.cell(shape).build(cfg, mesh)
    layout = build.layout or (None,) * len(build.args)
    args = _materialize(build.args, layout, mesh)
    with use_mesh(mesh):
        _, counts = analyze(build.fn, *args)
    return counts


def run_cell(arch_name: str, shape: str, *, multi_pod: bool = False, overrides: list = (),
             mesh_sizes: dict | None = None, smoke: bool = False) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import arg_bytes
    from repro_torch.launch.mesh import make_production_mesh

    sizes = dict(mesh_sizes) if mesh_sizes else make_production_mesh(multi_pod=multi_pod)
    ranks = 1
    for v in sizes.values():
        ranks *= v
    arch = get_arch(arch_name)
    cfg = apply_overrides(arch.make_smoke_config() if smoke else arch.make_config(),
                          list(overrides))
    mesh = fake_mesh(sizes)
    t0 = time.time()
    build = arch.cell(shape).build(cfg, mesh)
    t_build = time.time() - t0
    layout = build.layout or (None,) * len(build.args)
    result = {
        "arch": arch_name, "shape": shape, "mesh": mesh_name(sizes), "mesh_axes": sizes,
        "ranks": ranks, "rank": 0, "config": "smoke" if smoke else "full",
        "overrides": list(overrides),
        "resident_bytes": arg_bytes(build.args, layout, sizes),
        "spec_bytes": arg_bytes(build.args, build.in_shardings, sizes),
        "static_info": {k: v for k, v in build.static_info.items() if not callable(v)},
        "t_build_s": round(t_build, 2),
        "constants": {"peak_flops_bf16": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW, "ib_bw": IB_BW, "node_ranks": NODE_RANKS,
                      "source": "NVIDIA H100 SXM spec sheet"},
    }
    if arch.family == "apss":
        result.update(status="no_census", census=None, census_reason=APSS_REASON)
        return result
    t0 = time.time()
    try:
        counts, counted = _census(arch, shape, cfg, mesh, sizes)
    except Exception as e:  # noqa: BLE001 (recorded: a cell that fails on meta is listed)
        tb = traceback.extract_tb(e.__traceback__)
        where = next((f"{f.filename.split('src/')[-1]}:{f.lineno}" for f in reversed(tb)
                      if "repro_torch" in f.filename), "")
        result.update(status="failed_on_meta", census=None,
                      census_reason=f"{type(e).__name__}: {e} (at {where})")
        return result
    result["t_census_s"] = round(time.time() - t0, 2)
    result["layers_counted"] = counted
    result["peak_live_bytes"] = result["resident_bytes"] + counts.pop("peak_excess_bytes")
    result["peak_live_note"] = "estimate: no allocator rounding, no workspaces"
    result["census"] = counts
    result["roofline"] = roofline_terms(counts["flops"], counts["hbm_bytes"],
                                        counts["link_bytes_by_group"])
    model_flops = build.static_info.get("model_flops", 0)
    result["model_flops_per_rank"] = model_flops / ranks
    result["useful_flops_ratio"] = (model_flops / ranks) / counts["flops"] if counts["flops"] \
        else 0.0
    result["status"] = "ok"
    return result


def _census_at(arch, shape, cfg, mesh, sizes) -> dict:
    """One census of ``cfg``'s cell on rank 0's meta arguments, with the
    peak's excess over the resident arguments."""
    from repro_torch.configs.base import arg_bytes, local_args
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.op_analysis import analyze_live

    build = arch.cell(shape).build(cfg, mesh)
    layout = build.layout or (None,) * len(build.args)
    resident = arg_bytes(build.args, layout, sizes)
    with use_mesh(mesh):
        _, counts = analyze_live(build.fn, *local_args(build.args, layout, mesh),
                                 resident=resident)
    counts["peak_excess_bytes"] = counts.pop("peak_live_bytes") - resident
    return counts


def _extrapolate(a, b, steps: float):
    """``a + steps · (b − a)`` through dicts of numbers (``b`` elsewhere)."""
    if isinstance(b, dict):
        keys = set(a) | set(b)
        return {k: _extrapolate(a.get(k, 0), b.get(k, 0), steps) for k in sorted(keys, key=str)}
    if isinstance(b, (int, float)) and not isinstance(b, bool):
        return a + steps * (b - a)
    return b


def _census(arch, shape, cfg, mesh, sizes) -> tuple[dict, list]:
    """The cell's census and the depths counted (see the module doc)."""
    depth = getattr(cfg, "n_layers", 0)
    k = getattr(cfg, "first_k_dense", 0)
    if arch.family != "lm" or depth - k <= 2:
        return _census_at(arch, shape, cfg, mesh, sizes), [depth] if depth else []
    one, two = (_census_at(arch, shape, dataclasses.replace(cfg, n_layers=k + i), mesh, sizes)
                for i in (1, 2))
    return _extrapolate(one, two, depth - k - 1), [k + 1, k + 2]


def cell_list(arch_names=None) -> list:
    from repro_torch.configs import ASSIGNED, get_arch

    return [(a, s) for a in (arch_names or ASSIGNED + ["apss"]) for s in get_arch(a).shapes]


def _summary(res: dict) -> str:
    head = f"[dryrun] {res['arch']} × {res['shape']} @ {res['mesh']}"
    gib = 2 ** 30
    mem = (f"resident {res['resident_bytes'] / gib:.2f} GiB, "
           f"spec {res['spec_bytes'] / gib:.2f} GiB")
    if res["census"] is None:
        return f"{head}: {res['status']} | {mem} | {res['census_reason']}"
    r = res["roofline"]
    return (f"{head}: {mem}, peak live ~{res['peak_live_bytes'] / gib:.2f} GiB | "
            f"flops/rank {res['census']['flops']:.3e} | compute {r['compute_s'] * 1e3:.2f} ms "
            f"memory {r['memory_s'] * 1e3:.2f} ms collective {r['collective_s'] * 1e3:.2f} ms "
            f"→ {r['dominant']}")


def table(out_dir: str) -> str:
    """A markdown table of the cells' JSON under ``out_dir``: one row per
    arch, one column per cell in :func:`cell_list` order, each entry
    ``shape: TFLOP · resident / spec / peak-live GiB · dominant (ms)``."""
    gib = 2 ** 30
    rows: dict = {}
    for name in sorted(os.listdir(out_dir), key=_order):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            res = json.load(f)
        mem = f"{_num(res['resident_bytes'] / gib)} / {_num(res['spec_bytes'] / gib)}"
        if res["census"] is None:
            entry = f"{res['shape']}: — · {mem} / — · no census"
        else:
            r = res["roofline"]
            entry = (f"{res['shape']}: {_num(res['census']['flops'] / 1e12)} · {mem} / "
                     f"{_num(res['peak_live_bytes'] / gib)} · {r['dominant'][:4]} "
                     f"({_num(r[r['dominant'] + '_s'] * 1e3)})")
        rows.setdefault(res["arch"], []).append(entry)
    width = max(len(v) for v in rows.values())
    lines = ["| arch | " + " | ".join(f"cell {i + 1}" for i in range(width)) + " |",
             "|---|" + "---|" * width]
    lines += [f"| {arch} | " + " | ".join(cells) + " |" for arch, cells in rows.items()]
    return "\n".join(lines)


def _num(x: float) -> str:
    return f"{x:,.0f}" if x >= 100 else f"{x:.3g}"


def _order(filename: str):
    cells = cell_list()
    arch, shape = filename.split("__")[:2]
    return cells.index((arch, shape)) if (arch, shape) in cells else len(cells)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, help="axis sizes, e.g. data=2,model=2")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a process of its own (with --all)")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--override", action="append", default=[],
                    help="config overrides key=value (perf variants)")
    ap.add_argument("--tag", default="", help="suffix for the output json (perf variants)")
    ap.add_argument("--table", metavar="DIR", help="print a markdown table of DIR's results")
    args = ap.parse_args(argv)

    if args.table:
        print(table(args.table))
        return 0
    if args.list:
        for a, s in cell_list():
            print(f"{a:24s} {s}")
        return 0
    from repro_torch.launch.mesh import make_production_mesh

    sizes = parse_mesh(args.mesh) if args.mesh else make_production_mesh(
        multi_pod=args.multi_pod)
    os.makedirs(args.out, exist_ok=True)

    def out_path(a, s):
        tag = f"__{args.tag}" if args.tag else ""
        return os.path.join(args.out, f"{a}__{s}__{mesh_name(sizes)}{tag}.json")

    def one(a, s):
        res = run_cell(a, s, overrides=args.override, mesh_sizes=sizes, smoke=args.smoke)
        if args.tag:
            res["variant"] = {"tag": args.tag, "overrides": args.override}
        with open(out_path(a, s), "w") as f:
            json.dump(res, f, indent=1)
        print(_summary(res), flush=True)
        return res

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, are required")
        res = one(args.arch, args.shape)
        return 0 if res["status"] in ("ok", "no_census") else 1
    failures, no_census = [], []
    for a, s in cell_list():
        if os.path.exists(out_path(a, s)):
            print(f"[dryrun] skip (cached): {a} × {s}")
            continue
        if args.subprocess:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
                   "--out", args.out, "--mesh", ",".join(f"{k}={v}" for k, v in sizes.items())]
            cmd += [f"--override={o}" for o in args.override]
            cmd += (["--smoke"] if args.smoke else []) + (["--tag", args.tag] if args.tag else [])
            if subprocess.run(cmd, timeout=args.timeout).returncode != 0:
                failures.append((a, s))
            continue
        try:
            res = one(a, s)
        except Exception:  # noqa: BLE001 (a builder's fault: listed, the others go on)
            traceback.print_exc()
            failures.append((a, s))
            continue
        if res["status"] == "failed_on_meta":
            failures.append((a, s))
        elif res["status"] == "no_census":
            no_census.append((a, s))
    if no_census:
        print("[dryrun] no census (APSS):", no_census)
    if failures:
        print("[dryrun] FAILURES:", failures)
        return 1
    print("[dryrun] every cell ran")
    return 0


if __name__ == "__main__":
    sys.exit(main())
