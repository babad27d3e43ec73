"""The paper's own workload as a selectable arch: distributed APSS cells.

Each cell runs one distributed APSS variant of ``core/distributed.py`` at
the scale of a paper Table-4 dataset (padded to mesh-divisible shapes).
Thresholds follow Table 4.

Variants (paper §5-§6 + extensions):
  h_allgather   1-D horizontal, paper-faithful Alg. 6 (corpus all-gather)
  h_ring        1-D horizontal, hierarchical nested ring (beyond-paper)
  v_compressed  1-D vertical w/ local pruning (Lemma 1) + top-C compaction
  grid_2d       2-D checkerboard (Alg. 7), compressed accumulation

Scales:
  wikipedia-like  n=71680  m=1351680  t=0.9   (horizontal / 2-D)
  20news-like     n=20480  m=315392   t=0.4   (vertical — the paper also
                  found the vertical distribution viable only at smaller n)

A cell's ``fn(D, device=...)`` runs in every rank of the mesh it was built
on: ``D`` is the global corpus (an array, a tensor, or anything
``core.distributed`` slices a rank's cell from), each rank takes its own
cell of it, and every rank returns the global ``Matches``, as the
reference's cell returns the global array. Like the reference's cells,
they pass no ``use_kernel``: the blocks are scored on the plain path.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import (
    ArchDef, CellBuild, ShapeCell, axis_sizes, meta, register, shardings_for,
)
from repro_torch.core.distributed import (
    apss_2d,
    apss_horizontal,
    apss_horizontal_hierarchical,
    apss_vertical,
    gather_matches,
)

K_MATCHES = 64


def config() -> dict:
    return {
        "wikipedia": dict(n=71680, m=1351680, t=0.9),
        "20news": dict(n=20480, m=315392, t=0.4),
        "dtype": "f32",       # "bf16" halves block traffic
        "block_rows": 512,    # n_loc reads each ring block once
    }


def smoke_config() -> dict:
    return {"synthetic": dict(n=256, m=192, t=0.35)}


def _row_axes(mesh):
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data", "model") if a in sizes)


def _dtype(cfg):
    return torch.bfloat16 if cfg.get("dtype") == "bf16" else torch.float32


def _static_info(spec) -> dict:
    return {"kind": "apss", "model_flops": 2 * spec["n"] ** 2 * spec["m"],
            "n": spec["n"], "m": spec["m"]}


def _build(cfg, mesh, data: str, spec_of, run, **kw) -> CellBuild:
    spec = cfg[data]
    D = meta((spec["n"], spec["m"]), _dtype(cfg))
    fn = functools.partial(run, mesh=mesh, t=spec["t"], k=K_MATCHES, **kw)
    return CellBuild(fn=fn, args=(D,), in_shardings=(shardings_for(mesh, spec_of),),
                     out_shardings=None, static_info=_static_info(spec))


def _h_allgather_cell(cfg, mesh) -> CellBuild:
    axes = _row_axes(mesh)
    return _build(cfg, mesh, "wikipedia", (axes, None), _run_h_allgather, axes=axes)


def _run_h_allgather(D, *, mesh, axes, t, k, device="cuda"):
    out = apss_horizontal(D, t, k, mesh, axis_name=axes, schedule="allgather",
                          block_rows=512, device=device)
    return gather_matches(out, mesh, axes)


def _h_ring_cell(cfg, mesh) -> CellBuild:
    axes = _row_axes(mesh)
    return _build(cfg, mesh, "wikipedia", (axes, None), _run_h_ring, axes=axes)


def _run_h_ring(D, *, mesh, axes, t, k, device="cuda"):
    out = apss_horizontal_hierarchical(D, t, k, mesh, axes, block_rows=512, device=device)
    return gather_matches(out, mesh, axes)


def _v_compressed_cell(cfg, mesh) -> CellBuild:
    return _build(cfg, mesh, "20news", (None, "model"), _run_v_compressed)


def _run_v_compressed(D, *, mesh, t, k, device="cuda"):
    return apss_vertical(D, t, k, mesh, axis_name="model", accumulation="compressed",
                         block_rows=512, candidate_capacity=256, device=device)


def _2d_cell(cfg, mesh) -> CellBuild:
    return _build(cfg, mesh, "wikipedia", ("data", "model"), _run_2d,
                  block_rows=int(cfg.get("block_rows", 512)))


def _run_2d(D, *, mesh, t, k, block_rows=512, device="cuda"):
    out = apss_2d(D, t, k, mesh, row_axis="data", col_axis="model",
                  accumulation="compressed", block_rows=block_rows,
                  candidate_capacity=256, device=device)
    return gather_matches(out, mesh, "data")


ARCH = register(ArchDef(
    name="apss",
    family="apss",
    source="this paper (Özkural & Aykanat 2014)",
    make_config=config,
    make_smoke_config=smoke_config,
    shapes={
        "h_allgather": ShapeCell(
            kind="apss", desc="1-D horizontal Alg.6 (paper-faithful), "
            "wikipedia-scale n=71680 m=1351680 t=0.9",
            build=_h_allgather_cell,
        ),
        "h_ring": ShapeCell(
            kind="apss", desc="1-D horizontal hierarchical ring "
            "(beyond-paper), wikipedia-scale",
            build=_h_ring_cell,
        ),
        "v_compressed": ShapeCell(
            kind="apss", desc="1-D vertical + local pruning (Lemma 1), "
            "20news-scale n=20480 m=315392 t=0.4",
            build=_v_compressed_cell,
        ),
        "grid_2d": ShapeCell(
            kind="apss", desc="2-D checkerboard Alg.7, wikipedia-scale",
            build=_2d_cell,
        ),
    },
))
