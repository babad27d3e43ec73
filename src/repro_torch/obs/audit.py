"""Model-vs-program audit: does the cost model price the work the port runs?

``planner.costmodel`` prices variants from closed-form FLOP and wire-byte
formulas; ``obs.drift`` checks those predictions against measured *time*,
which cannot tell a model that counts the wrong work from a card that does
the right work slowly. This module answers the first question without
timing anything: it runs every plannable variant family once
(``planner.plan.execute``) under ``obs.compile.measure``, whose op census
(``launch.op_analysis``) counts what the program really does, and compares

- model FLOPs          vs census FLOPs (aten products and the kernels'
  reported work, at the padded shapes they compute),
- model collective B   vs census link bytes (per rank, the same wire
  convention as ``telemetry.CollectiveHop.total_bytes``),
- a streaming HBM lower bound vs census HBM bytes,

as per-family ratios in an :class:`AuditReport`. The ratios also feed
:func:`AuditReport.residuals` → ``obs.drift.drift_report`` as
``source="audit"`` rows (unit-free: the Residual convention is ratios, so
FLOPs work as well as seconds).

Coverage: every family ``candidate_configs`` can plan on the given meshes
— dense/sparse × blocked / horizontal allgather / ring / halfring /
vertical / hierarchical / 2-D checkerboard — plus the serving
``query_topk`` inners and the live index's delta join, captured from real
calls (``obs.compile.capture_calls``: their worklists are built on the
host, so the audit replays the exact call the hot path made). With
``meshes`` (``DeviceMesh``es) the audit is collective: every rank calls
:func:`run_audit` and runs the same families in the same order, and rank
0's report is the result; its numbers are rank 0's, per device as in the
reference.

This is the reference's ``repro.obs.audit``, with its names and formulas;
by design it differs in that each family runs once on ``device`` (the
reference lowers without running: eager PyTorch has nothing to lower),
the measured fields are named ``measured_*`` (not ``hlo_*``), and census
HBM bytes bill every op eager PyTorch runs unfused, elementwise ones too.

Known, documented gaps (entry notes, not failures):

- the sparse gather-dot materializes a ``(block, block, 32)`` gathered
  slab per tile and 32-slot chunk of the corpus's ELL width, HBM the
  streaming model does not charge (ROADMAP: in-kernel gather);
- HBM ratios are informational: the census bills every op's operands,
  which legitimately re-reads what the streaming bound counts once.

CLI: ``python -m repro_torch.obs.audit [--n N] [--m M] [--k K] [--threshold
T] [--density D] [--json PATH] [--device cpu|cuda] [--ranks P]``; exits 1
when :meth:`AuditReport.gated_ok` fails.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import compile as obs_compile
from repro_torch.obs import drift, trace

# Families whose census FLOPs must sit within this factor of the model
# (both directions). Only the dense blocked and ring families are gated, as
# in the reference.
FLOP_RATIO_BAND = 1.5
GATED_FAMILIES = ("blocked[dense]", "horizontal/ring[dense]")
_GATHER_CHUNK = 32  # core.sparse.gather_dot's slots per gathered slab


@dataclasses.dataclass
class AuditEntry:
    """One variant family: model prediction vs census measurement."""

    family: str
    config: str
    mesh: Optional[dict]
    predicted_flops: float
    measured_flops: float
    predicted_link_bytes: float
    measured_link_bytes: float
    predicted_hbm_bytes: float
    measured_hbm_bytes: float
    record: obs_compile.CompileRecord
    notes: tuple = ()

    @staticmethod
    def _ratio(measured: float, predicted: float) -> Optional[float]:
        if predicted <= 0:
            return None
        return measured / predicted

    @property
    def flop_ratio(self) -> Optional[float]:
        return self._ratio(self.measured_flops, self.predicted_flops)

    @property
    def link_ratio(self) -> Optional[float]:
        return self._ratio(self.measured_link_bytes, self.predicted_link_bytes)

    @property
    def hbm_ratio(self) -> Optional[float]:
        return self._ratio(self.measured_hbm_bytes, self.predicted_hbm_bytes)

    @property
    def kernels(self) -> dict:
        """The census's kernel launches: ``{name: {launches, flops, bytes}}``."""
        return self.record.analysis.get("kernels", {})

    def as_dict(self) -> dict:
        return {
            "family": self.family,
            "config": self.config,
            "mesh": self.mesh,
            "predicted_flops": self.predicted_flops,
            "measured_flops": self.measured_flops,
            "flop_ratio": self.flop_ratio,
            "predicted_link_bytes": self.predicted_link_bytes,
            "measured_link_bytes": self.measured_link_bytes,
            "link_ratio": self.link_ratio,
            "predicted_hbm_bytes": self.predicted_hbm_bytes,
            "measured_hbm_bytes": self.measured_hbm_bytes,
            "hbm_ratio": self.hbm_ratio,
            "host_copy_bytes": self.record.analysis.get("host_copy_bytes", 0.0),
            "kernels": self.kernels,
            "compile": self.record.as_dict(),
            "notes": list(self.notes),
        }


@dataclasses.dataclass
class AuditReport:
    """Every audited family + the corpus/mesh context they ran on."""

    entries: list
    n: int
    m: int
    k: int
    threshold: float
    meshes: list
    device: str = "cuda"

    def families(self) -> list:
        return [e.family for e in self.entries]

    def entry(self, family: str) -> AuditEntry:
        for e in self.entries:
            if e.family == family:
                return e
        raise KeyError(family)

    def gated_ok(self, band: float = FLOP_RATIO_BAND) -> bool:
        """Do the gated dense families' census FLOPs sit within ``band``?"""
        for fam in GATED_FAMILIES:
            try:
                r = self.entry(fam).flop_ratio
            except KeyError:
                return False
            if r is None or r > band or r < 1.0 / band:
                return False
        return True

    def residuals(self) -> list:
        """FLOP-ratio rows for ``obs.drift.drift_report`` (``source="audit"``,
        unit-free by the Residual ratio convention)."""
        out = []
        for e in self.entries:
            if e.predicted_flops > 0 and e.measured_flops > 0:
                out.append(drift.Residual(
                    variant=e.family,
                    predicted_s=e.predicted_flops,
                    measured_s=e.measured_flops,
                    source="audit",
                ))
        return out

    def as_dict(self) -> dict:
        return {
            "n": self.n, "m": self.m, "k": self.k,
            "threshold": self.threshold,
            "meshes": self.meshes,
            "device": self.device,
            "flop_ratio_band": FLOP_RATIO_BAND,
            "gated_families": list(GATED_FAMILIES),
            "gated_ok": self.gated_ok(),
            "entries": [e.as_dict() for e in self.entries],
        }

    def describe(self) -> str:
        lines = [
            f"AuditReport: n={self.n} m={self.m} k={self.k} "
            f"t={self.threshold} meshes={self.meshes} device={self.device}",
            f"{'family':<36} {'flopsx':>7} {'linkx':>7} {'hbmx':>7} "
            f"{'peakMB':>8} {'wall':>8}",
        ]
        fmt = lambda r: "   -  " if r is None else f"{r:6.2f}"  # noqa: E731
        for e in self.entries:
            lines.append(
                f"{e.family:<36} {fmt(e.flop_ratio):>7} "
                f"{fmt(e.link_ratio):>7} {fmt(e.hbm_ratio):>7} "
                f"{e.record.total_bytes / 1e6:>7.1f}M "
                f"{e.record.t_lower_s * 1e3:>6.0f}ms"
            )
            for note in e.notes:
                lines.append(f"    note: {note}")
        gate = "PASS" if self.gated_ok() else "FAIL"
        lines.append(
            f"gate[{', '.join(GATED_FAMILIES)}] within "
            f"{FLOP_RATIO_BAND}x: {gate}"
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Prediction helpers
# ---------------------------------------------------------------------------


def _family_name(cfg) -> str:
    base = cfg.kind
    if cfg.schedule:
        base += f"/{cfg.schedule}"
    if cfg.accumulation:
        base += f"/{cfg.accumulation}"
    return f"{base}[{'sparse' if cfg.sparse else 'dense'}]"


def _predicted_hbm(cfg, s, p: int, k: int) -> float:
    """Streaming lower bound: each device scores a ``rows × n`` strip by
    reading its resident row block plus every counterpart block once, and
    writes its matches. Deliberately optimistic — the census bills every
    op's operands on top — so ``hbm_ratio ≥ 1`` is the healthy regime and
    the ratio is informational, not gated."""
    from repro_torch.planner import telemetry

    depth = s.cap if cfg.sparse else s.m
    itemb = 8 if cfg.sparse else s.itemsize  # CSR slot = i32 idx + f32 val
    rows = s.n if cfg.kind == "vertical" else s.n // max(1, p)
    corpus_pass = (rows + s.n) * depth * itemb
    return float(corpus_pass + telemetry.matches_bytes(rows, k))


def _sparse_scan_note(cfg, s) -> str:
    """Quantify the sparse gather-dot's gathered slabs — the ``(b, b, 32)``
    HBM intermediate per tile and 32-slot chunk that the streaming model
    does not charge (ROADMAP: in-kernel gather)."""
    b = min(cfg.block_rows, s.n)
    tiles = (-(-s.n // b)) ** 2
    chunks = -(-s.cap // _GATHER_CHUNK)
    slab = 2 * tiles * chunks * b * b * _GATHER_CHUNK * 4
    return (
        f"sparse gather-dot gather intermediate ~(T={tiles}, b={b}, b, "
        f"{_GATHER_CHUNK}) x {chunks} chunks x2 (written, read) = "
        f"{slab / 1e6:.1f}MB HBM not in the streaming model "
        "(ROADMAP: in-kernel gather)"
    )


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------


def _audit_planned(cfg, s, data, threshold: float, k: int, mesh, sizes,
                   device) -> AuditEntry:
    """Run one planner config once under ``obs.compile.measure``."""
    from repro_torch.planner import costmodel
    from repro_torch.planner.plan import execute

    p = 1
    for v in (sizes or {}).values():
        p *= v
    if cfg.kind == "blocked":
        p = 1
    name = _family_name(cfg)
    _, record = obs_compile.measure(
        execute, cfg, data, float(threshold), k,
        mesh if cfg.kind != "blocked" else None, prepared=True, device=device, name=name,
    )
    hops = costmodel.variant_hops(cfg, s, sizes, k) if sizes and p > 1 else ()
    notes = []
    if cfg.sparse and cfg.kind in ("blocked", "horizontal"):
        notes.append(_sparse_scan_note(cfg, s))
    a = record.analysis
    return AuditEntry(
        family=name,
        config=cfg.name,
        mesh=dict(sizes) if sizes else None,
        predicted_flops=costmodel.variant_flops(cfg, s, p),
        measured_flops=a["flops"],
        predicted_link_bytes=float(sum(h.total_bytes for h in hops)),
        measured_link_bytes=a["link_bytes"],
        predicted_hbm_bytes=_predicted_hbm(cfg, s, p, k),
        measured_hbm_bytes=a["hbm_bytes"],
        record=record,
        notes=tuple(notes),
    )


def _audit_serving(D: np.ndarray, threshold: float, k: int, device, batch: int) -> list:
    """query_topk's inner and the live index's forward delta join, from real
    calls (``capture_calls``), so the audit replays exactly what serving
    ran, worklist length ``T`` included. On a card ``query_topk`` runs its
    kernels (K4, K6) and the live index K4's masked entry."""
    from repro_torch.core.sparse import from_dense
    from repro_torch.serving import build_index, query_topk
    from repro_torch.serving.mutable import MutableAPSSIndex

    n, m = D.shape
    use_kernel = device.type == "cuda"
    entries = []

    Q = D[: min(batch, n)]
    calls: dict = {}
    for data in (D, from_dense(D, device=device)):
        index = build_index(data, block_rows=min(64, n), device=device)
        with obs_compile.capture_calls() as got:
            query_topk(index, Q, threshold, k, use_kernel=use_kernel)
        calls.update(got)
    for cap_name, fam in (
        ("serving.dense_inner", "serving.query_topk[dense]"),
        ("serving.sparse_inner", "serving.query_topk[sparse]"),
    ):
        call = calls.get(cap_name)
        if call is not None:
            entries.append(_audit_captured(call, fam, m))

    br = 64 if use_kernel else min(64, 1 << (n // 2 - 1).bit_length())  # K4 takes 64-256
    mut = MutableAPSSIndex(
        D[: n // 2], threshold=threshold, k=k, kind="dense", block_rows=br, device=device,
    )
    with obs_compile.capture_calls() as calls:
        mut.append(D[n // 2:])  # append runs the forward delta join
    for cap_name, fam in (
        ("mutable.dense_inner", "mutable.delta_join[dense]"),
        ("mutable.sparse_inner", "mutable.delta_join[sparse]"),
    ):
        call = calls.get(cap_name)
        if call is not None:
            entries.append(_audit_captured(call, fam, m))
    return entries


def _audit_captured(call, family: str, m: int) -> AuditEntry:
    """Worklist-path prediction: ``2·T·block_q·block_c·depth`` FLOPs over
    the captured tile list (the host ``(2, T)`` worklist), one query-block +
    corpus-block read per tile for HBM."""
    kw = call.kwargs
    T = next(int(a.shape[1]) for a in call.args
             if isinstance(a, np.ndarray) and a.ndim == 2 and a.shape[0] == 2)
    bq, bc = int(kw["block_q"]), int(kw["block_c"])
    predicted_flops = 2.0 * T * bq * bc * m
    predicted_hbm = float(T * (bq + bc) * m * 4 + T * bq * bc * 4)
    _, record = obs_compile.measure(call.fn, *call.args, name=family, **call.kwargs)
    a = record.analysis
    return AuditEntry(
        family=family,
        config=f"{call.name}(T={T}, block_q={bq}, block_c={bc})",
        mesh=None,
        predicted_flops=predicted_flops,
        measured_flops=a["flops"],
        predicted_link_bytes=0.0,
        measured_link_bytes=a["link_bytes"],
        predicted_hbm_bytes=predicted_hbm,
        measured_hbm_bytes=a["hbm_bytes"],
        record=record,
        notes=(),
    )


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def default_meshes() -> list:
    """The reference's meshes over every device, as ``DeviceMesh``es over
    the process group's ranks: ``(P,)`` ``("data",)`` and, for even P ≥ 4,
    ``(P/2, 2)`` ``("data", "model")``; none outside a process group.
    Every rank must call it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    if not dist.is_initialized():
        return []
    p = dist.get_world_size()
    meshes = [make_mesh((p,), ("data",))]
    if p >= 4 and p % 2 == 0:
        meshes.append(make_mesh((p // 2, 2), ("data", "model")))
    return meshes


def run_audit(
    corpus=None,
    *,
    n: int = 64,
    m: int = 64,
    k: int = 8,
    threshold: float = 0.3,
    density: float = 0.2,
    seed: int = 0,
    meshes=None,
    include_serving: bool = True,
    batch: int = 32,
    device="cuda",
) -> AuditReport:
    """Audit every plannable variant family (one config per family — block
    sizes within a family run the same program shape) on ``device``
    (default ``"cuda"``, which raises without a card: nothing falls back).

    ``meshes=None`` takes :func:`default_meshes`. With meshes every rank
    calls this, and rank 0 also audits serving (``batch`` queries) and the
    live index, which have no collectives. Pass ``corpus`` to audit real
    data; the default is the synthetic power-law corpus at a size every
    family's divisibility gates accept.
    """
    import torch.distributed as dist

    from repro_torch.core.sparse import from_dense
    from repro_torch.data.synthetic import synthetic_corpus
    from repro_torch.interop import device_of
    from repro_torch.planner.costmodel import mesh_sizes
    from repro_torch.planner.plan import candidate_configs, summarize_corpus

    dev = device_of(device)
    if corpus is None:
        corpus = synthetic_corpus(n, m, density * m, seed=seed)
    D = np.asarray(corpus, np.float32)
    n, m = D.shape
    if meshes is None:
        meshes = default_meshes()
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    s = summarize_corpus(D, threshold)
    reps = {False: torch.from_numpy(D).to(dev)}
    entries: list = []
    seen: set = set()
    mesh_list = []
    with trace.span("obs/audit", n=n, m=m, k=k):
        for mesh in [None] + list(meshes):
            sizes = mesh_sizes(mesh) if mesh is not None else None
            if sizes:
                mesh_list.append(sizes)
            for cfg in candidate_configs(s, mesh, k, include_kernel=False, device=dev):
                fam = (cfg.kind, cfg.schedule, cfg.accumulation, cfg.sparse)
                if fam in seen:
                    continue
                if cfg.kind == "blocked" and mesh is not None:
                    continue  # identical program regardless of mesh
                seen.add(fam)
                if cfg.sparse not in reps:
                    reps[True] = from_dense(reps[False], device=dev)
                entries.append(_audit_planned(
                    cfg, s, reps[cfg.sparse], threshold, k, mesh, sizes, dev,
                ))
        if include_serving and rank0:
            entries.extend(_audit_serving(D, threshold, k, dev, batch))
    return AuditReport(
        entries=entries, n=n, m=m, k=k, threshold=float(threshold),
        meshes=mesh_list, device=str(dev),
    )


def audit_ranks(rank, world, dev, options: dict):
    """Rank function (``launch.mesh.spawn``): :func:`run_audit` on the
    :func:`default_meshes` of the ranks with ``options``; rank 0's report,
    None on the others."""
    report = run_audit(device=dev, **options)
    return report if rank == 0 else None


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="model-vs-program audit over every plannable variant family"
    )
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.3)
    ap.add_argument("--density", type=float, default=0.2)
    ap.add_argument("--json", default=None, help="write AuditReport JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=0,
                    help="spawn this many ranks (launch.mesh.spawn) and audit "
                         "the distributed families on their meshes too")
    args = ap.parse_args(argv)
    options = dict(n=args.n, m=args.m, k=args.k, threshold=args.threshold,
                   density=args.density)
    if args.ranks:
        from repro_torch.launch.mesh import spawn

        report = spawn("repro_torch.obs.audit:audit_ranks", args.ranks, options,
                       device=args.device)[0]
    else:
        report = run_audit(device=args.device, **options)
    print(report.describe())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.as_dict(), f, indent=2)
            f.write("\n")
    rep = drift.drift_report(report.residuals(), band=4.0)
    print(rep.describe())
    return 0 if report.gated_ok() else 1


if __name__ == "__main__":
    raise SystemExit(main())
