"""Cost-model drift detection: predicted-vs-measured residuals per variant.

``planner.costmodel`` prices every variant from a
:class:`~repro_torch.planner.costmodel.CalibrationProfile` measured once and
cached to JSON. A new card, a new PyTorch or CUDA, and corpus regimes the
calibration never saw all rot that profile silently: the planner keeps
ranking with stale constants. This module closes the loop at run time:

- :func:`predict_seconds` prices a single runtime
  :class:`~repro_torch.planner.telemetry.ApssStats` record with a profile:
  the same formula shape as ``estimate_cost`` (latency·hops + bytes/bw for
  comm; FLOPs/throughput for compute; ``max`` when the schedule overlaps)
  fed by the hops and FLOPs the call recorded, not corpus summaries;
- :func:`residuals_from_trace` joins each record with its measured span
  (the span ``obs.trace`` pinned it to) into :class:`Residual` rows,
  ``ratio = measured / predicted``;
- :func:`residuals_from_estimates` does the same join for planner
  :class:`~repro_torch.planner.costmodel.CostEstimate` lists that carry
  ``measured_s`` (autotune);
- :func:`drift_report` folds residuals into a :class:`DriftReport`:
  per-variant median ratios, an overall median, and ``stale=True`` when
  the overall median leaves ``[1/band, band]``, with a recalibration
  recommendation naming the worst offenders.

Residual convention: ratios, not differences. A profile that is uniformly
2× optimistic is consistent (the argmin ranking survives) but shows as a
median ratio ≈ 2; the band says how much uniform error the planner's
within-2× rule can absorb. Span clocks are host clocks (``obs.trace``): a
span measures device work only where the code inside it waits for it.

This is the reference's ``repro.obs.drift``, formula for formula.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Iterable, Optional

from repro_torch.obs.trace import Tracer
from repro_torch.planner.costmodel import CalibrationProfile, CostEstimate
from repro_torch.planner.telemetry import ApssStats

# Schedules that overlap collective hops with compute (the ring family, the
# checkerboard and the nested hierarchical rings): the same set as
# ``costmodel.estimate_cost``, keyed here by runtime variant string.
_OVERLAPPED_PREFIXES = (
    "horizontal/ring", "horizontal/halfring", "hierarchical", "2d/",
)


@dataclasses.dataclass
class Residual:
    """One predicted-vs-measured pair."""

    variant: str
    predicted_s: float
    measured_s: float
    source: str = "trace"   # "trace" | "estimate" | "audit" (obs.audit: FLOPs, not seconds)

    @property
    def ratio(self) -> float:
        return self.measured_s / max(self.predicted_s, 1e-12)


@dataclasses.dataclass
class DriftReport:
    """Aggregated residuals and a staleness verdict for one profile."""

    residuals: list[Residual]
    band: float
    per_variant: dict[str, float]          # median ratio per variant
    median_ratio: float
    stale: bool
    profile_kind: str
    recommendation: str

    def as_dict(self) -> dict:
        return {
            "band": self.band,
            "median_ratio": self.median_ratio,
            "stale": self.stale,
            "profile_kind": self.profile_kind,
            "per_variant": dict(sorted(self.per_variant.items())),
            "n_residuals": len(self.residuals),
            "recommendation": self.recommendation,
            "residuals": [
                {
                    "variant": r.variant,
                    "predicted_s": r.predicted_s,
                    "measured_s": r.measured_s,
                    "ratio": r.ratio,
                    "source": r.source,
                }
                for r in self.residuals
            ],
        }

    def describe(self) -> str:
        lines = [
            f"DriftReport(profile={self.profile_kind}, "
            f"median ratio {self.median_ratio:.2f}x, band {self.band:.1f}x, "
            f"{'STALE' if self.stale else 'fresh'})"
        ]
        for v, r in sorted(self.per_variant.items()):
            lines.append(f"  {v:<44} median measured/predicted {r:8.2f}x")
        lines.append(f"  {self.recommendation}")
        return "\n".join(lines)


def predict_seconds(stats: ApssStats, profile: CalibrationProfile) -> float:
    """Price one runtime record with ``profile`` (see module docstring)."""
    comm_s = (
        stats.hop_count * profile.collective_latency_us * 1e-6
        + stats.wire_bytes / (max(profile.collective_gbps, 1e-3) * 1e9)
    )
    compute_s = stats.flops / profile.throughput(
        sparse=stats.sparse, distributed=stats.devices > 1
    )
    if stats.imbalance is not None:
        compute_s *= stats.imbalance
    overlapped = stats.variant.startswith(_OVERLAPPED_PREFIXES)
    body = max(compute_s, comm_s) if overlapped else compute_s + comm_s
    return body + profile.overhead_us * 1e-6


def residuals_from_trace(tracer: Tracer, profile: CalibrationProfile) -> list[Residual]:
    """Join each ``ApssStats`` with its enclosing measured span.

    A span's wall-clock is attributed evenly across the records pinned to
    it (one record per span in every instrumented path today); a span whose
    children (the ring steps a ``StepTicker`` settled) end after it uses
    their extent instead, so the measurement covers the device work.
    """
    tracer.finalize()
    out: list[Residual] = []
    for sp in tracer.walk():
        if not sp.records:
            continue
        end = sp.t1 if sp.t1 is not None else sp.t0
        for c in sp.children:
            if c.t1 is not None:
                end = max(end, c.t1)
        measured = max(0.0, end - sp.t0) / len(sp.records)
        for stats in sp.records:
            out.append(Residual(
                variant=stats.variant,
                predicted_s=predict_seconds(stats, profile),
                measured_s=measured,
                source="trace",
            ))
    return out


def residuals_from_estimates(estimates: Iterable[CostEstimate]) -> list[Residual]:
    """Residuals from planner estimates that carry ``measured_s`` (filled
    by autotuning); unmeasured entries are skipped."""
    return [
        Residual(variant=e.config.name, predicted_s=e.total_s,
                 measured_s=e.measured_s, source="estimate")
        for e in estimates if e.measured_s is not None
    ]


def drift_report(
    residuals: list[Residual],
    *,
    band: float = 4.0,
    profile: Optional[CalibrationProfile] = None,
) -> DriftReport:
    """Fold residuals into a :class:`DriftReport` (see module docstring).

    ``band`` is the acceptable median measured/predicted ratio envelope:
    ``stale`` iff the overall median falls outside ``[1/band, band]``.
    """
    kind = profile.device_kind if profile is not None else "unknown"
    if not residuals:
        return DriftReport(
            residuals=[], band=band, per_variant={}, median_ratio=1.0,
            stale=False, profile_kind=kind,
            recommendation="no measured spans joined any model record",
        )
    per_variant: dict[str, list[float]] = {}
    for r in residuals:
        per_variant.setdefault(r.variant, []).append(r.ratio)
    medians = {v: statistics.median(rs) for v, rs in per_variant.items()}
    overall = statistics.median([r.ratio for r in residuals])
    stale = overall > band or overall < 1.0 / band
    if stale:
        worst = sorted(medians.items(), key=lambda kv: abs(math.log(max(kv[1], 1e-12))),
                       reverse=True)[:3]
        names = ", ".join(f"{v} ({r:.1f}x)" for v, r in worst)
        recommendation = (
            f"calibration profile '{kind}' looks stale "
            f"(median measured/predicted {overall:.2f}x outside "
            f"[{1/band:.2f}, {band:.2f}]); worst: {names}. "
            "Re-run repro_torch.planner.calibrate.calibrate(save=True) on this "
            "hardware before trusting plan rankings."
        )
    else:
        recommendation = (
            f"profile '{kind}' within band "
            f"(median measured/predicted {overall:.2f}x)"
        )
    return DriftReport(
        residuals=residuals, band=band, per_variant=medians,
        median_ratio=overall, stale=stale, profile_kind=kind,
        recommendation=recommendation,
    )
