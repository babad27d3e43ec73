"""Shared setup of the port's distributed parity tests.

The port runs a list of variants in gloo ranks spawned on the CPU
(``repro_torch.launch.apss_mesh.run_variants``); the reference runs the same
``apss`` call (same distribution, mesh and keyword arguments) on a JAX mesh
over the first ``p`` of the test session's virtual CPU devices.
"""

from __future__ import annotations

import numpy as np

T, K = 0.35, 16
PG_TIMEOUT_S = 60.0     # a collective that waits longer raises
JOIN_TIMEOUT_S = 240.0  # one set of ranks, every variant


def variant(name, distribution, shape, names, corpus="dense", *, gather=None,
            scatter=False, threshold=T, ticks=False, **kwargs) -> dict:
    return dict(name=name, distribution=distribution, mesh=(shape, names), corpus=corpus,
                gather=gather, scatter=scatter, threshold=threshold, ticks=ticks,
                kwargs=kwargs)


def run_ranks(run_dir, p: int, corpora: dict, variants: list) -> dict:
    """Rank 0's records of ``variants``, run in ``p`` spawned gloo ranks."""
    from repro_torch.launch.mesh import spawn

    return spawn(
        "repro_torch.launch.apss_mesh:run_variants", p, corpora, variants, T, K,
        device="cpu", threads=1, run_dir=run_dir, pg_timeout=PG_TIMEOUT_S,
        join_timeout=JOIN_TIMEOUT_S,
    )[0]


def jax_mesh(shape, names):
    import jax

    from repro.compat import make_mesh

    return make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])


_RUNS: dict = {}


def _digest(corpus) -> str:
    import hashlib

    h = hashlib.sha1()
    for x in (corpus.indices, corpus.values, corpus.nnz) if hasattr(corpus, "nnz") else (corpus,):
        h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    return h.hexdigest()


def jax_run(corpus, v: dict, *, records: bool = False):
    """The reference's ``apss`` on the same variant: ``(Matches, stats)``,
    and with ``records`` its telemetry records too. Each (variant, corpus)
    runs once per test process: the call runs under a telemetry log and its
    result and records are kept for the next asker."""
    from repro.core.distributed import apss
    from repro.planner import CommLog

    key = (v["name"], _digest(corpus))
    if key not in _RUNS:
        with CommLog() as log:
            out = apss(corpus, v["threshold"], K, jax_mesh(*v["mesh"]),
                       distribution=v["distribution"], **v["kwargs"])
        _RUNS[key] = (out if isinstance(out, tuple) and len(out) == 2 else (out, None),
                      log.records)
    out, recs = _RUNS[key]
    return (*out, recs) if records else out


def record_fields(r) -> dict:
    """A record of either package (a port record as ``run_variants``
    returns it, or a JAX ``ApssStats``) as comparable values."""
    import dataclasses

    if not isinstance(r, dict):
        r = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        r["hops"] = [dataclasses.asdict(h) for h in r["hops"]]
    keep = ("variant", "n", "m", "devices", "block_rows", "sparse", "hops", "flops",
            "live_tiles", "total_tiles", "tile_counts", "extra")
    return {key: r[key] for key in keep}


def assert_same_records(got: list, ref: list) -> None:
    import pytest

    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = record_fields(g), record_fields(r)
        assert g.pop("flops") == pytest.approx(r.pop("flops"), rel=1e-12, abs=0)
        assert g == r


def elastic_ranks(rank, world, dev) -> dict:
    """Rank function (``launch.mesh.spawn``) of ``tests/test_torch_elastic.py``:
    the reference's elastic cases (``tests/test_substrates.py``) on this
    rank, and ``mesh_after_eviction``'s edges. Every rank takes part in
    creating every mesh, those outside it too."""
    from types import SimpleNamespace

    from repro_torch.distributed.elastic import (
        ElasticPlan,
        make_elastic_mesh,
        reshard_tree,
        rescale,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.robust import mesh_after_eviction

    state = {"w": np.arange(32, dtype=np.float32).reshape(8, 4),
             "b": (np.arange(3, dtype=np.int32), np.ones((5, 2), np.float32))}
    specs = {"w": ("data", "model"), "b": (("data",), ("expert", None))}
    big = make_elastic_mesh(4, model_parallel=2)
    small = make_elastic_mesh(2, model_parallel=2)
    odd = make_elastic_mesh(3, model_parallel=2)
    out = {"big": tuple(big.mesh.shape), "small": tuple(small.mesh.shape),
           "odd": tuple(odd.mesh.shape), "describe": ElasticPlan(small, "lost 2").describe()}
    try:
        make_elastic_mesh(1, model_parallel=2)
    except ValueError as e:
        out["too_few"] = str(e)
    on_big = reshard_tree(state, specs, big)
    out["big_full"] = on_big["w"].full_tensor().numpy()
    out["big_local"] = on_big["w"].to_local().numpy()
    out["big_placements"] = [str(p) for p in on_big["w"].placements]
    out["b_placements"] = [[str(p) for p in x.placements] for x in on_big["b"]]
    out["b_full"] = [x.full_tensor().numpy() for x in on_big["b"]]
    if small.get_coordinate() is not None:
        on_small = rescale(lambda: state, specs, ElasticPlan(small))
        out["small_full"] = on_small["w"].full_tensor().numpy()
        out["small_local"] = on_small["w"].to_local().numpy()
        out["small_devices"] = on_small["w"].device_mesh.mesh.numel()
    flat = make_mesh((world,), ("data",))
    out["noop"] = mesh_after_eviction(flat, SimpleNamespace(evict=[])) is flat
    try:
        mesh_after_eviction(flat, SimpleNamespace(evict=list(range(world))))
    except ValueError as e:
        out["all_evicted"] = str(e)
    return out


_OBS: dict = {}


def obs_runs(run_dir) -> list:
    """Every rank's :func:`obs_ranks` result, run once per test process (in 4
    gloo ranks) for ``tests/test_torch_op_analysis.py`` and
    ``tests/test_torch_audit.py``."""
    from repro_torch.launch.mesh import spawn

    if "ranks" not in _OBS:
        _OBS["ranks"] = spawn("_torch_dist:obs_ranks", 4, device="cpu", threads=1,
                              run_dir=str(run_dir), pg_timeout=PG_TIMEOUT_S,
                              join_timeout=JOIN_TIMEOUT_S)
    return _OBS["ranks"]


def obs_ranks(rank, world, dev) -> dict:
    """Rank function (``launch.mesh.spawn``): :func:`census_ranks`, then the
    port's audit at the reference's defaults (``obs.audit.audit_ranks``:
    n = m = 64, t = 0.3, k = 8, meshes ``(4,)`` and ``(2, 2)``; rank 0's
    report, with serving and the live index)."""
    from repro_torch.obs.audit import audit_ranks

    return {"census": census_ranks(rank, world, dev),
            "audit": audit_ranks(rank, world, dev, {})}


def census_ranks(rank, world, dev) -> dict:
    """Each of the collective helpers of ``core.distributed`` alone under an
    op census, over the ``(world,)`` mesh and over the size-2 ``model`` axis
    of a ``(world / 2, 2)`` mesh, on a (16, 8) float32 tensor. Returns the
    census of each as ``{(helper, p): counts}``."""
    import torch

    from repro_torch.core import distributed as dd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_analysis import analyze

    flat = make_mesh((world,), ("data",))
    grid = make_mesh((world // 2, 2), ("data", "model"))
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8) + rank
    out = {}
    for mesh, axis in ((flat, "data"), (grid, "model")):
        p = dd._axis_size(mesh, axis)
        calls = {
            "ppermute": lambda: dd._ppermute((x,), mesh, axis, dd._ring_perm(p)),
            "psum": lambda: dd._psum(x, mesh, axis),
            "pmax": lambda: dd._pmax(x, mesh, axis),
            "psum_scatter": lambda: dd._psum_scatter(x, mesh, axis),
            "all_gather": lambda: dd._all_gather(x, mesh, axis),
        }
        for name, call in calls.items():
            out[(name, p)] = analyze(call)[1]
    return out


APSS_CELLS = dict(n=512, m=192, t=0.35)  # v_compressed's block_rows=512 needs n ≥ 512
_CELLS: dict = {}


def apss_cell_config(config: dict) -> dict:
    """``config`` (the ``apss`` arch's full config, either package) with both
    datasets cut to :data:`APSS_CELLS`."""
    cfg = dict(config)
    cfg["wikipedia"] = dict(APSS_CELLS)
    cfg["20news"] = dict(APSS_CELLS)
    return cfg


def apss_cell_runs(run_dir, corpus_path: str) -> dict:
    """Rank 0's ``launch.apss_mesh.run_cells`` result for every cell of the
    port's ``apss`` arch at :data:`APSS_CELLS` on a (2, 2) ``("data",
    "model")`` mesh, run once per test process in 4 gloo ranks
    (``tests/test_torch_configs.py``), and every rank's matches."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import spawn

    if "ranks" not in _CELLS:
        arch = get_arch("apss")
        cells = [(name, corpus_path) for name in arch.shapes]
        _CELLS["ranks"] = spawn(
            "repro_torch.launch.apss_mesh:run_cells", 4, cells,
            apss_cell_config(arch.make_config()), device="cpu", threads=1,
            run_dir=str(run_dir), pg_timeout=PG_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S)
    return _CELLS["ranks"]
