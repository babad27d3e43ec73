"""The port's model-vs-program audit (``repro_torch.obs.audit``) on the CPU.

One audit, in 4 gloo ranks at the reference's defaults (n = m = 64, t =
0.3, k = 8; meshes ``(4,)`` and ``(2, 2)``, serving and the live index on
rank 0; ``_torch_dist.obs_ranks``), backs every case: the counterparts of
the reference's ``tests/test_obs_audit.py`` (the same family set as its
``test_audit_covers_every_plannable_family``, the gated FLOP band, the ring's
link ratio, the sparse gather note, the records, the drift feed, JSON);
every predicted number against the reference's own formulas
(``repro.planner.costmodel`` and ``repro.obs.audit``) on the same summary;
and the gated families' census FLOPs against the reference's
``launch.hlo_analysis.analyze`` of those two programs.
"""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import jax_mesh, obs_runs  # noqa: E402
from repro_torch.obs import drift  # noqa: E402
from repro_torch.obs.audit import FLOP_RATIO_BAND, GATED_FAMILIES, _family_name  # noqa: E402

N = M = 64
T, K = 0.3, 8


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    return obs_runs(tmp_path_factory.mktemp("audit"))[0]["audit"]


@pytest.fixture(scope="module")
def corpus():
    from repro_torch.data.synthetic import synthetic_corpus

    return synthetic_corpus(N, M, 0.2 * M, seed=0)


def test_audit_covers_every_plannable_family(report):
    fams = set(report.families())
    for rep in ("dense", "sparse"):
        assert f"blocked[{rep}]" in fams
        for sched in ("allgather", "ring", "halfring"):
            assert f"horizontal/{sched}[{rep}]" in fams
        for acc in ("allreduce", "scatter", "compressed", "recursive"):
            assert f"vertical/{acc}[{rep}]" in fams
        assert f"hierarchical[{rep}]" in fams
        for acc in ("allreduce", "compressed"):
            assert f"2d/{acc}[{rep}]" in fams
    assert "serving.query_topk[dense]" in fams
    assert "serving.query_topk[sparse]" in fams
    assert "mutable.delta_join[dense]" in fams
    assert len(report.entries) == 25 and report.device == "cpu"
    assert report.meshes == [{"data": 4}, {"data": 2, "model": 2}]


def test_dense_blocked_and_ring_flops_within_band(report):
    for fam in GATED_FAMILIES:
        r = report.entry(fam).flop_ratio
        assert r is not None, fam
        assert 1.0 / FLOP_RATIO_BAND <= r <= FLOP_RATIO_BAND, (fam, r)
    assert report.gated_ok()


def test_collective_link_bytes_match_wire_model(report):
    e = report.entry("horizontal/ring[dense]")
    assert e.predicted_link_bytes > 0 and e.measured_link_bytes > 0
    assert 0.5 <= e.link_ratio <= 2.0, e.link_ratio


def test_sparse_blocked_quantifies_gather_intermediate(report):
    e = report.entry("blocked[sparse]")
    assert any("gather intermediate" in n and "ROADMAP" in n for n in e.notes), e.notes


def test_every_entry_carries_compile_record(report):
    for e in report.entries:
        assert e.record.t_lower_s > 0, e.family
        assert e.record.argument_bytes > 0, e.family
        assert e.record.t_compile_s == 0 and e.record.code_bytes == 0  # no kernels here
        assert e.measured_flops > 0, e.family
        assert e.kernels == {}, e.family  # the plain paths: aten ops only


def test_residuals_feed_drift_as_audit_source(report):
    res = report.residuals()
    assert len(res) == len(report.entries)
    assert all(r.source == "audit" for r in res)
    rep = drift.drift_report(res, band=4.0)
    assert set(rep.per_variant) == set(report.families())
    assert rep.per_variant["blocked[dense]"] == pytest.approx(
        report.entry("blocked[dense]").flop_ratio
    )


def test_report_serializes(report):
    d = report.as_dict()
    text = json.dumps(d)
    assert "gated_ok" in d and d["entries"] and d["gated_ok"]
    assert "flop_ratio" in d["entries"][0] and "measured_flops" in d["entries"][0]
    assert len(text) > 100
    desc = report.describe()
    assert "blocked[dense]" in desc and "gate[" in desc


def _planned(corpus):
    """Family name → (port config, p, mesh sizes), as ``run_audit`` picks
    them: the first config of each family, blocked once."""
    from repro_torch.planner.plan import candidate_configs, summarize_corpus

    s = summarize_corpus(corpus, T)
    out = {}
    for sizes in (None, {"data": 4}, {"data": 2, "model": 2}):
        mesh = sizes and types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                               shape=tuple(sizes.values()))
        for cfg in candidate_configs(s, mesh, K, include_kernel=False, device="cpu"):
            fam = _family_name(cfg)
            if fam in out or (cfg.kind == "blocked" and sizes):
                continue
            p = 1 if cfg.kind == "blocked" else int(np.prod(list((sizes or {}).values())))
            out[fam] = (cfg, p, sizes)
    return s, out


def test_predictions_equal_the_reference_formulas(report, corpus):
    import dataclasses

    from repro.obs.audit import _predicted_hbm
    from repro.planner import costmodel as rcm

    s, planned = _planned(corpus)
    rs = rcm.CorpusSummary(**dataclasses.asdict(s))
    assert len(planned) == 22
    for fam, (cfg, p, sizes) in planned.items():
        e = report.entry(fam)
        rc = rcm.VariantConfig(**dataclasses.asdict(cfg))
        assert e.config == cfg.name == rc.name
        assert e.predicted_flops == rcm.variant_flops(rc, rs, p), fam
        hops = rcm.variant_hops(rc, rs, sizes, K) if sizes and p > 1 else ()
        assert e.predicted_link_bytes == float(sum(h.total_bytes for h in hops)), fam
        assert e.predicted_hbm_bytes == _predicted_hbm(rc, rs, p, K), fam
    for e in report.entries[len(planned):]:  # serving and the live index
        kw = dict(x.split("=") for x in e.config.split("(")[1].rstrip(")").split(", "))
        tiles, bq, bc = (int(kw[x]) for x in ("T", "block_q", "block_c"))
        assert e.predicted_flops == 2.0 * tiles * bq * bc * M
        assert e.predicted_hbm_bytes == tiles * (bq + bc) * M * 4 + tiles * bq * bc * 4


def test_gated_flops_equal_the_reference_hlo_analysis(report, corpus):
    """The reference's analyzer on its own blocked and ring programs (4
    devices) counts the products the port's census counts: both sides are
    the model's ``2·rows·n·m`` per device."""
    import dataclasses

    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze
    from repro.obs.audit import _lower_planned
    from repro.planner import costmodel as rcm

    _, planned = _planned(corpus)
    for fam, mesh in (("blocked[dense]", None),
                      ("horizontal/ring[dense]", jax_mesh((4,), ("data",)))):
        rc = rcm.VariantConfig(**dataclasses.asdict(planned[fam][0]))
        compiled, _ = _lower_planned(rc, jnp.asarray(corpus), T, K, mesh)
        ref = analyze(compiled.as_text())["flops"]
        assert report.entry(fam).measured_flops == pytest.approx(ref, rel=0.10), fam
