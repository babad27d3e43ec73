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
