"""The port's execution planner (``repro_torch.planner``) against the JAX
package's, on the CPU, with ``default_profile()`` passed explicitly.

Summaries, candidate lists, cost estimates and plans (ranking and choice)
equal the reference's on the same corpora; what a plan runs is exact
against the oracle (``variant="auto"``, ``execute``, ``Plan.run`` on an
index, ``build_index(plan=)``, ``query_topk(plan=)``); the guards raise the
reference's messages; the calibration profile round-trips through its JSON
cache and the calibration runs on the CPU. The distributed
``distribution="auto"`` rides the rank fixture of
``test_torch_distributed_sparse.py``. Corpora are small and no Pallas
kernel runs, so the file takes seconds.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_dist import jax_mesh  # noqa: E402
from _torch_parity import assert_clear_of_threshold  # noqa: E402
from repro.core.apss import normalize_rows as jnormalize  # noqa: E402
from repro.data.sparse import sparse_zipfian_corpus as jzipf  # noqa: E402
from repro.planner import costmodel as jcost  # noqa: E402
from repro.planner import plan as jplan  # noqa: E402
from repro.serving import build_index as jbuild  # noqa: E402
from repro_torch.core.apss import apss_reference, similarity_topk  # noqa: E402
from repro_torch.core.graph import match_set  # noqa: E402
from repro_torch.core.matches import extract_matches  # noqa: E402
from repro_torch.core.precision import dot_f32  # noqa: E402
from repro_torch.core.sparse import to_dense  # noqa: E402
from repro_torch.interop import sparse_corpus_from_numpy, sparse_corpus_to_numpy  # noqa: E402
from repro_torch.planner import (  # noqa: E402
    QueryPlan,
    VariantConfig,
    default_profile,
    estimate_cost,
    mesh_sizes,
    plan_apss,
    plan_query_topk,
)
from repro_torch.planner import calibrate as calibrate_mod  # noqa: E402
from repro_torch.planner.plan import (  # noqa: E402
    candidate_configs,
    execute,
    summarize_corpus,
)
from repro_torch.serving import build_index, query_topk  # noqa: E402

T, K = 0.5, 16
MESHES = {"single": None, "8": ((8,), ("data",)), "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


@pytest.fixture(scope="module")
def lowdens():
    """The reference test's paper-regime corpus (density ≈ 0.6 %): the JAX
    one and the port's, made from its arrays."""
    jsp = jzipf(512, 2048, 12.0, seed=0)
    return jsp, sparse_corpus_from_numpy(*sparse_corpus_to_numpy(jsp), device="cpu")


@pytest.fixture(scope="module")
def middens():
    """20 % density: sparse representation offered, but gather-dot loses."""
    rng = np.random.default_rng(1)
    D = np.abs(rng.standard_normal((256, 128))).astype(np.float32)
    D *= rng.random((256, 128)) < 0.2
    return np.asarray(jnormalize(jnp.asarray(D)))


def _stand_in(shape, names):
    """What the planner reads of a port mesh: no ranks needed to price."""
    return SimpleNamespace(shape=shape, mesh_dim_names=names)


def _meshes(key):
    if MESHES[key] is None:
        return None, None
    return _stand_in(*MESHES[key]), jax_mesh(*MESHES[key])


def _inputs(which, lowdens, middens):
    if which == "lowdens":
        return lowdens[1], lowdens[0]
    return middens, jnp.asarray(middens)


def _check_exact(got, ref):
    assert match_set(got) == match_set(ref)
    np.testing.assert_array_equal(got.counts.cpu().numpy(), ref.counts.cpu().numpy())


def _same_summary(got, ref):
    g, r = got.as_dict(), ref.as_dict()
    for key in ("density", "avg_nnz", "zipf_alpha"):
        assert g.pop(key) == pytest.approx(r.pop(key), rel=1e-12, abs=0), key
    assert g == r  # live_fraction, tile_counts and cap exactly


# -- summaries ------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["lowdens", "middens"])
def test_summarize_equals_reference(lowdens, middens, which):
    got_in, ref_in = _inputs(which, lowdens, middens)
    for t in (T, 0.2):
        _same_summary(summarize_corpus(got_in, t), jplan.summarize_corpus(ref_in, t))
    # a sample smaller than the corpus takes the same rows
    _same_summary(summarize_corpus(got_in, T, sample_rows=100, seed=3),
                  jplan.summarize_corpus(ref_in, T, sample_rows=100, seed=3))


@pytest.mark.parametrize("which", ["lowdens", "middens"])
@pytest.mark.parametrize("p", [1, 2])
def test_summarize_index_equals_reference(lowdens, middens, which, p):
    """From the index's exact stats; a sharded index (p = 2) is counted
    shard by shard and must give the unsharded summary."""
    got_in, ref_in = _inputs(which, lowdens, middens)
    index = build_index(got_in, block_rows=64, normalize=False, device="cpu",
                        devices=["cpu"] * p)
    ref = jplan.summarize_corpus(jbuild(ref_in, block_rows=64, normalize=False), T)
    _same_summary(summarize_corpus(index, T), ref)


# -- candidates, costs, plans ------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("include_kernel", [False, True])
@pytest.mark.parametrize("which", ["lowdens", "middens"])
def test_candidates_and_costs_equal_reference(lowdens, middens, mesh, include_kernel, which):
    got_in, ref_in = _inputs(which, lowdens, middens)
    tmesh, jmesh = _meshes(mesh)
    s, js = summarize_corpus(got_in, T), jplan.summarize_corpus(ref_in, T)
    got = candidate_configs(s, tmesh, K, include_kernel=include_kernel)
    ref = jplan.candidate_configs(js, jmesh, K, include_kernel=include_kernel)
    assert [c.name for c in got] == [c.name for c in ref]
    sizes = mesh_sizes(tmesh) if tmesh is not None else None
    assert sizes == (dict(jmesh.shape) if jmesh is not None else None)
    prof, jprof = default_profile(), jcost.default_profile()
    for c, jc in zip(got, ref):
        g = estimate_cost(c, s, sizes, prof, K).as_dict()
        r = jcost.estimate_cost(jc, js, sizes, jprof, K).as_dict()
        assert g.pop("config") == r.pop("config")
        assert g.pop("wire_bytes") == r.pop("wire_bytes")
        assert g.pop("hop_count") == r.pop("hop_count")
        assert g == pytest.approx(r, rel=1e-12, abs=0)


@pytest.mark.parametrize("mesh", ["single", "8", "4x2"])
@pytest.mark.parametrize("include_kernel", [False, True])
@pytest.mark.parametrize("which", ["lowdens", "middens"])
def test_plan_ranks_and_chooses_as_reference(lowdens, middens, mesh, include_kernel, which):
    got_in, ref_in = _inputs(which, lowdens, middens)
    tmesh, jmesh = _meshes(mesh)
    kw = dict(include_kernel=include_kernel)
    got = plan_apss(got_in, T, K, tmesh, profile=default_profile(), device="cpu", **kw)
    ref = jplan.plan_apss(ref_in, T, K, jmesh, profile=jcost.default_profile(), **kw)
    assert [e.config.name for e in got.estimates] == [e.config.name for e in ref.estimates]
    assert got.config.name == ref.config.name
    assert got.cost.total_s == pytest.approx(ref.cost.total_s, rel=1e-12)
    if mesh == "single":  # the reference test's findings
        assert got.config.sparse == (which == "lowdens")


def test_blocked_priced_single_device_under_mesh(lowdens):
    s = summarize_corpus(lowdens[1], T)
    cfg = VariantConfig("blocked", True, 128)
    with_mesh = estimate_cost(cfg, s, {"data": 8}, default_profile(), K)
    without = estimate_cost(cfg, s, None, default_profile(), K)
    assert with_mesh.flops == without.flops and with_mesh.total_s == without.total_s


# -- what a plan runs is exact ----------------------------------------------------------


@pytest.mark.parametrize("which", ["lowdens", "middens"])
def test_variant_auto_dispatch_exact(lowdens, middens, which):
    D = to_dense(lowdens[1]) if which == "lowdens" else torch.from_numpy(middens)
    assert_clear_of_threshold(D.numpy(), D.numpy(), T, exclude_self=True)
    C = lowdens[1] if which == "lowdens" else D
    got = similarity_topk(C, C, T, K, exclude_self=True, variant="auto", device="cpu")
    _check_exact(got, apss_reference(D, T, K, device="cpu"))


def test_variant_auto_guards():
    rng = np.random.default_rng(2)
    D = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    Q = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="self-join"):
        similarity_topk(Q, D, T, K, exclude_self=True, variant="auto", device="cpu")
    with pytest.raises(ValueError, match="exclude_self"):
        similarity_topk(D, D, T, K, variant="auto", device="cpu")
    with pytest.raises(ValueError, match="variant"):
        similarity_topk(D, D, T, K, variant="ring", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        execute(VariantConfig("horizontal", False, 16, schedule="ring"), D, T, K,
                device="cpu")
    with pytest.raises(ValueError, match="plan must be"):
        query_topk(build_index(D, block_rows=16, device="cpu"), D[:2], T, K, plan="fast")


def test_plan_runs_on_the_planned_device_and_never_falls_back(middens):
    plan = plan_apss(torch.from_numpy(middens), T, K, profile=default_profile())
    assert plan.device == torch.device("cpu") and not any(
        e.config.use_kernel for e in plan.estimates)  # no kernel candidate off the card
    with pytest.raises(RuntimeError, match="is_available"):
        plan_apss(middens, T, K, profile=default_profile())  # numpy: the default, "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        plan.run(device="cuda")


def test_execute_representation_conversion(middens):
    """A sparse config on a dense input converts on its device and stays exact."""
    got = execute(VariantConfig("blocked", True, 64), middens, T, K, device="cpu")
    _check_exact(got, apss_reference(middens, T, K, device="cpu"))


def test_plan_on_index_returns_valid_rows_only():
    """Indexes pad rows to the block multiple; planning from an index must
    run on the VALID corpus, sharded or not."""
    jsp = jzipf(200, 512, 8.0, seed=6)
    sp = sparse_corpus_from_numpy(*sparse_corpus_to_numpy(jsp), device="cpu")
    ref = apss_reference(to_dense(sp), T, K, device="cpu")
    for p in (1, 2):
        index = build_index(sp, block_rows=64, normalize=False, device="cpu",
                            devices=["cpu"] * p)
        assert index.n_padded == 256
        plan = plan_apss(index, T, K, profile=default_profile())
        got = plan.run()
        assert got.counts.shape[0] == 200
        _check_exact(got, ref)
        dense = build_index(to_dense(sp), block_rows=64, normalize=False, device="cpu",
                            devices=["cpu"] * p)
        _check_exact(plan_apss(dense, T, K, profile=default_profile()).run(), ref)


def test_autotune_promotes_measured_winner():
    jsp = jzipf(256, 1024, 8.0, seed=3)
    sp = sparse_corpus_from_numpy(*sparse_corpus_to_numpy(jsp), device="cpu")
    plan = plan_apss(sp, T, K, profile=default_profile(), include_kernel=False,
                     autotune=True)
    assert plan.autotuned
    measured = [e for e in plan.estimates if e.measured_s is not None]
    assert len(measured) >= 2
    assert plan.estimates[0].measured_s == min(e.measured_s for e in measured)
    _check_exact(plan.run(), apss_reference(to_dense(sp), T, K, device="cpu"))


def test_autotune_lets_a_kernel_error_raise(monkeypatch):
    """The reference prices a failing candidate ``inf``; the port raises,
    so that a kernel that does not build or launch cannot lose in silence.
    Two disjoint clusters of dimensions: half the tiles are dead, so the
    kernel candidate is the dense family's best and autotune times it."""
    from repro_torch.kernels._build import KernelError
    from repro_torch.kernels.apss_block import ops

    D = np.zeros((256, 128), np.float32)
    D[:128, :64] = np.random.default_rng(4).random((128, 64))
    D[128:, 64:] = np.random.default_rng(5).random((128, 64))
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    plan = plan_apss(torch.from_numpy(D), T, K, profile=default_profile(),
                     include_kernel=True, block_rows_choices=(128,))
    dense = [e.config for e in plan.estimates if not e.config.sparse]
    assert dense[0].use_kernel  # the family's first: autotune takes it

    def broken(*a, **kw):
        raise KernelError("apss_fused: no such kernel")

    monkeypatch.setattr(ops, "apss_fused_kernel", broken)
    with pytest.raises(KernelError, match="no such kernel"):
        plan_apss(torch.from_numpy(D), T, K, profile=default_profile(),
                  include_kernel=True, autotune=True, block_rows_choices=(128,))


def test_build_index_with_plan(lowdens):
    jsp, sp = lowdens
    plan = plan_apss(sp, T, K, profile=default_profile())
    index = build_index(sp, normalize=False, plan=plan, device="cpu")
    assert index.block_rows == plan.config.block_rows
    assert index.is_sparse == plan.config.sparse
    D = to_dense(sp)
    index2 = build_index(D, normalize=False, plan=plan, device="cpu")  # dense → planned CSR
    assert index2.is_sparse == plan.config.sparse
    dense_cfg = VariantConfig("blocked", False, 64)
    index3 = build_index(sp, normalize=False, plan=dense_cfg, device="cpu")  # CSR → dense
    assert not index3.is_sparse and index3.block_rows == 64
    Q = D[:4]
    ref = extract_matches(dot_f32(Q, D), T, K, exclude_self=False)
    for ix in (index, index2, index3):
        _check_exact(query_topk(ix, Q, T, K), ref)


def test_plan_describe_and_dict(lowdens):
    plan = plan_apss(lowdens[1], T, K, profile=default_profile())
    text = plan.describe()
    assert plan.config.name in text and "density" in text and "single device" in text
    d = plan.as_dict()
    assert d["chosen"] == plan.config.name
    assert {"config", "predicted_s", "wire_bytes"} <= d["estimates"][0].keys()
    assert d["summary"]["n"] == 512
    mesh_plan = plan_apss(lowdens[1], T, K, _stand_in((8,), ("data",)),
                          profile=default_profile())
    assert "on mesh {'data': 8}" in mesh_plan.describe()
    assert mesh_plan.result_layout() in {(None, False), ("data", False), ("data", True)}


# -- per-batch query plans ----------------------------------------------------------


def _query_case(kind, lowdens):
    jsp, sp = lowdens
    D = to_dense(sp)
    corpus, jcorpus = (sp, jsp) if kind == "sparse" else (D, jnp.asarray(D.numpy()))
    index = build_index(corpus, block_rows=64, normalize=False, device="cpu")
    return D, index, jbuild(jcorpus, block_rows=64, normalize=False)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("allow_kernel", [False, True])
def test_query_plan_equals_reference(lowdens, kind, batch, allow_kernel):
    _, index, jindex = _query_case(kind, lowdens)
    got = plan_query_topk(index, batch, 0.3, K, allow_kernel=allow_kernel).as_dict()
    ref = jcost.plan_query_topk(jindex, batch, 0.3, K, allow_kernel=allow_kernel).as_dict()
    assert got.pop("predicted_us") == pytest.approx(ref.pop("predicted_us"), rel=1e-12)
    assert got == ref
    assert plan_query_topk(index, batch, 0.3, K).use_kernel is False  # a CPU index


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("p", [1, 2])
def test_query_topk_plan_exact(lowdens, kind, p):
    D, _, _ = _query_case(kind, lowdens)
    corpus = D if kind == "dense" else lowdens[1]
    index = build_index(corpus, block_rows=64, normalize=False, device="cpu",
                        devices=["cpu"] * p)
    Q = D[100:110]
    ref = extract_matches(dot_f32(Q, D), 0.3, K, exclude_self=False)
    _check_exact(query_topk(index, Q, 0.3, K, plan="auto"), ref)
    fixed = QueryPlan(batch=10, block_q=16, use_kernel=False, predicted_us=0.0,
                      live_block_fraction=1.0)
    _check_exact(query_topk(index, Q, 0.3, K, plan=fixed), ref)


# -- calibration ------------------------------------------------------------------------


@pytest.fixture
def calib_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIB_DIR", str(tmp_path))
    calibrate_mod._MEMO.clear()
    yield tmp_path
    calibrate_mod._MEMO.clear()


def test_calibrate_on_cpu_and_profile_roundtrip(calib_dir):
    prof = calibrate_mod.calibrate(n=128, m=128, cap=8, iters=1, save=True)
    assert calibrate_mod.device_kind() == prof.device_kind == "cpu_x1"
    for name in ("matmul_gflops", "gather_gflops", "score_cost_ns"):
        value = getattr(prof, name)
        assert np.isfinite(value) and value >= 0, name
    assert prof.matmul_gflops > 0 and prof.gather_gflops > 0
    path = calibrate_mod.profile_path()
    assert path == calib_dir / "calibration_torch_cpu_x1.json" and path.exists()
    calibrate_mod._MEMO.clear()
    loaded = calibrate_mod.get_profile()
    assert loaded == prof
    # the reference's JSON carries over field by field
    assert jcost.CalibrationProfile.from_json(path.read_text()).matmul_gflops == \
        pytest.approx(prof.matmul_gflops)


def test_get_profile_defaults_without_cache(calib_dir):
    prof = calibrate_mod.get_profile()
    assert prof.matmul_gflops == default_profile().matmul_gflops
    assert prof.device_kind == "cpu_x1"
    (calib_dir / "calibration_torch_cpu_x1.json").write_text("{not json")
    assert calibrate_mod.get_profile(refresh=True).matmul_gflops == 40.0


def test_serve_auto_mode_runs_on_cpu(calib_dir, capsys):
    from repro_torch.launch import serve

    report = serve.main(["--mode", "auto", "--device", "cpu", "--corpus-n", "256",
                         "--corpus-m", "512", "--threshold", "0.5"])
    out = capsys.readouterr().out
    assert "Plan: " in out and "[auto] ran" in out
    assert report["chosen"] == report["plan"]["chosen"] and report["matches"] >= 0
    assert (calib_dir / "calibration_torch_cpu_x1.json").exists()
