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


def jax_run(corpus, v: dict):
    """The reference's ``apss`` on the same variant: ``(Matches, stats)``."""
    from repro.core.distributed import apss

    out = apss(corpus, v["threshold"], K, jax_mesh(*v["mesh"]),
               distribution=v["distribution"], **v["kwargs"])
    return out if isinstance(out, tuple) and len(out) == 2 else (out, None)
