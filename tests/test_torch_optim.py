"""The port's optimizer (``repro_torch.optim``) against the reference's on
the CPU: ``adamw_update`` on f32 and bf16 trees at a learning rate whose
update spans many bf16 ulps (params and their change, ``m``, ``v``, ``grad_norm`` and ``lr``
within relative 1e-6; each bf16 param the reference's f32 update rounded
to nearest, either neighbour only within 1e-6 of a midpoint),
``clip_by_global_norm``, the schedules,
``AdamWState`` across packages by ``interop``, and top-k gradient
compression in 4 gloo ranks (``tests/_torch_dist.compression_ranks``, one
spawn) against the reference's ``shard_map`` on 4 virtual CPU devices: the
error-feedback state bit for bit, the synced mean within f32 rounding, the
invariant ``synced + mean(error) = mean(grad + old error)``, and
``compression_comm_bytes`` equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_dist import JOIN_TIMEOUT_S, PG_TIMEOUT_S, jax_mesh  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

REL = 1e-6
# Peak learning rate of the update tests: with params of scale 0.1 the median
# param moves by 5 bf16 ulps or more, from the first step (lr = LR_PEAK / 100).
LR_PEAK = 1.0
SHAPES = {"a": (64, 32), "b": [(100,), (3, 5, 7)], "c": {"d": (9, 4)}}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v, scale) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    return jax.tree.leaves(tree)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def _bf16_ulp(x):
    """The spacing of bf16 values in the binade of each ``x`` (f64)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(np.maximum(e, -126) - 7)


def _state(rng):
    m = _tree(rng, SHAPES, 0.01)
    v = _map(lambda a: np.abs(a) * 1e-3, _tree(rng, SHAPES))
    return m, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 3, 150])
def test_adamw_update_matches_the_reference(dtype, step):
    rng = np.random.default_rng(step)
    p32, g32 = _tree(rng, SHAPES, 0.1), _tree(rng, SHAPES, 0.3)
    m, v = _state(rng)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    jp, jg = (_map(lambda a: jnp.asarray(a).astype(jdt), t) for t in (p32, g32))
    jstate = jopt.AdamWState(step=jnp.int32(step), m=_map(jnp.asarray, m),
                             v=_map(jnp.asarray, v))
    jlr = jopt.cosine_schedule(jstate.step, LR_PEAK, 100, 1000)
    _, _, wmet = jopt.adamw_update(jg, jstate, jp, lr=jlr, weight_decay=0.1)

    # copies: the port writes in place, and jnp.asarray may share numpy's memory
    tp, tg = (_map(lambda a: torch.from_numpy(a.copy()).to(tdt), t) for t in (p32, g32))
    before = [x.double().numpy() for x in optim.tree_leaves(tp)]
    tstate = optim.AdamWState(step=torch.tensor(step, dtype=torch.int32),
                              m=_map(lambda a: torch.from_numpy(a.copy()), m),
                              v=_map(lambda a: torch.from_numpy(a.copy()), v))
    tlr = optim.cosine_schedule(tstate.step, LR_PEAK, 100, 1000)
    gp, gstate, gmet = optim.adamw_update(tg, tstate, tp, lr=tlr, weight_decay=0.1)

    assert gp is tp and int(gstate.step) == step + 1
    _close(gmet["lr"], wmet["lr"])
    _close(gmet["grad_norm"], wmet["grad_norm"])
    # The clip's scale rests on the norm's last f32 bits, and each library
    # (on each CPU) sums the squares in its own order: XLA's sum here is
    # 1e-6 below the float64 norm. A bf16 gradient rounded after a scale one
    # bit off moves by a whole bf16 ulp. So the clip is held to the
    # reference's rule at the port's norm bit for bit, and the update to the
    # reference's on the gradients that clip gives.
    scale = jnp.minimum(1.0, 1.0 / jnp.maximum(jnp.float32(float(gmet["grad_norm"])), 1e-9))
    jg = jax.tree.map(lambda g: (g.astype(jnp.float32) * scale).astype(g.dtype), jg)
    for got, want in zip(optim.tree_leaves(tg), _leaves(jg)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    wp, wstate, _ = jopt.adamw_update(jg, jstate, jp, lr=jlr, weight_decay=0.1,
                                      clip_norm=None)
    # the reference's update before its rounding to the params' dtype
    exact, _, _ = jopt.adamw_update(jg, jstate, _map(lambda a: a.astype(jnp.float32), jp),
                                    lr=jlr, weight_decay=0.1, clip_norm=None)
    for got, want in zip(optim.tree_leaves(gstate.m), _leaves(wstate.m)):
        _close(got, want)
    for got, want in zip(optim.tree_leaves(gstate.v), _leaves(wstate.v)):
        _close(got, want)
    for got, want, want32, old in zip(optim.tree_leaves(gp), _leaves(wp), _leaves(exact),
                                      before):
        assert got.dtype == tdt
        got = got.double().numpy()
        want32 = np.asarray(want32, np.float64)
        if dtype == "bfloat16":  # round to nearest of values equal within 1e-6
            assert np.median(np.abs(want32 - old) / _bf16_ulp(old)) >= 5
            err = np.abs(got - want32)
            assert (err <= _bf16_ulp(want32) / 2 + REL * np.abs(want32)).all()
            assert (np.abs(got - np.asarray(want, np.float64)) <= _bf16_ulp(want32)).all()
        else:
            _close(got, want)
            _close(got - old, want32 - old)


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng, SHAPES, 2.0)
    want, wnorm = jax.block_until_ready(jopt.clip_by_global_norm(_map(jnp.asarray, g), 0.5))
    # copies: the port scales in place, and jnp.asarray may share numpy's memory
    got, gnorm = optim.clip_by_global_norm(_map(lambda a: torch.from_numpy(a.copy()), g), 0.5)
    _close(gnorm, wnorm)
    assert float(gnorm) > 0.5
    for a, b in zip(optim.tree_leaves(got), _leaves(want)):
        _close(a, b)


def test_schedules_match_the_reference():
    for step in (0, 1, 5, 9, 10, 11, 400, 999, 1000, 1500):
        _close(optim.linear_warmup(torch.tensor(step), 3e-4, 10),
               jopt.linear_warmup(jnp.int32(step), 3e-4, 10))
        _close(optim.cosine_schedule(torch.tensor(step), 3e-4, 10, 1000),
               jopt.cosine_schedule(jnp.int32(step), 3e-4, 10, 1000))


def test_adamw_init_and_state_interop():
    from repro_torch.models.gnn import GATConfig

    cfg = GATConfig(d_feat=12, d_hidden=4, n_heads=2, n_classes=3)
    rng = np.random.default_rng(2)
    tree = {"layers": [{"w": _tree(rng, (12, 8)), "a_src": _tree(rng, (2, 4)),
                        "a_dst": _tree(rng, (2, 4))},
                       {"w": _tree(rng, (8, 3)), "a_src": _tree(rng, (1, 3)),
                        "a_dst": _tree(rng, (1, 3))}]}
    model = interop.gat_params_from_numpy(tree, cfg, "cpu")
    state = optim.adamw_init(dict(model.named_parameters()))
    assert int(state.step) == 0 and state.m is not state.v
    assert all(not t.any() and t.dtype == torch.float32 for t in optim.tree_leaves(state.m))
    jstate = jopt.AdamWState(step=np.int32(7), m=tree,
                             v=jax.tree.map(lambda a: a * 2, tree))

    def from_numpy(t):
        return interop.gat_params_from_numpy(t, cfg, "cpu")

    port = interop.adamw_state_from_numpy(jstate, from_numpy)
    assert int(port.step) == 7 and sorted(port.m) == sorted(dict(model.named_parameters()))
    back = interop.adamw_state_to_numpy(port, model, interop.gat_params_to_numpy)
    assert int(back.step) == 7
    for a, b in zip(_leaves(back.v), _leaves(jstate.v)):
        np.testing.assert_array_equal(a, b)


# -- gradient compression ----------------------------------------------------------

P_RANKS = 4
RATIO = 0.05
MIN_SIZE = 1024
_RUN: dict = {}


def _compression_inputs():
    rng = np.random.default_rng(3)
    shapes = {"w": (P_RANKS, 8192), "b": (P_RANKS, 2, 1536), "small": (P_RANKS, 64)}
    grads = [_tree(rng, shapes) for _ in range(2)]
    grads[1]["w"][:, :16] = 1.0  # equal magnitudes: the lower index wins the tie
    errors = _map(lambda a: a * 0.1, _tree(rng, shapes))
    return grads, errors


@pytest.fixture(scope="module")
def compression_runs(tmp_path_factory):
    """The port's and the reference's ``compress_tree`` over 4 ranks, two
    calls carrying the error state, one spawn for the whole module."""
    grads, errors = _compression_inputs()
    port = spawn("_torch_dist:compression_ranks", P_RANKS, grads, errors, RATIO, MIN_SIZE,
                 device="cpu", threads=1, run_dir=str(tmp_path_factory.mktemp("comp")),
                 pg_timeout=PG_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S)
    mesh = jax_mesh((P_RANKS,), ("data",))

    def f(g, err):
        synced, new = jcomp.compress_tree(g, jcomp.CompressionState(error=err), "data",
                                          ratio=RATIO, min_size=MIN_SIZE)
        return synced, new.error

    run = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                            out_specs=(P(), P("data")), check_vma=False))
    ref, err = [], _map(jnp.asarray, errors)
    for g in grads:
        synced, err = run(_map(jnp.asarray, g), err)
        ref.append((jax.tree.map(np.asarray, synced), jax.tree.map(np.asarray, err)))
    return grads, errors, port, ref


def test_compress_tree_matches_the_reference(compression_runs):
    grads, _, port, ref = compression_runs
    for call, (want_synced, want_err) in enumerate(ref):
        for rank in range(P_RANKS):
            synced, err = port[rank][call]
            for key in grads[call]:
                np.testing.assert_array_equal(err[key], want_err[key][rank:rank + 1],
                                              err_msg=f"{key} rank {rank}")
                np.testing.assert_allclose(synced[key], want_synced[key], rtol=1e-6,
                                           atol=1e-7, err_msg=key)
                np.testing.assert_array_equal(synced[key], port[0][call][0][key])


def test_compression_error_feedback_invariant(compression_runs):
    grads, errors, port, _ = compression_runs
    old = errors
    for call, g in enumerate(grads):
        for key in g:
            synced = port[0][call][0][key][0]
            new_err = np.stack([port[r][call][1][key][0] for r in range(P_RANKS)])
            want = (g[key] + old[key]).mean(0) if g[key][0].size >= MIN_SIZE else \
                g[key].mean(0)
            np.testing.assert_allclose(synced + new_err.mean(0), want, atol=1e-5)
            if g[key][0].size < MIN_SIZE:
                assert not new_err.any()
        old = {k: np.concatenate([port[r][call][1][k] for r in range(P_RANKS)])
               for k in g}


def test_compression_comm_bytes_matches_the_reference():
    shapes = {"big": (1 << 20,), "mid": (5000,), "small": (64,)}
    tree = _tree(np.random.default_rng(4), shapes)
    for p in (2, 4, 16):
        got = optim.compression_comm_bytes(_map(torch.from_numpy, tree), ratio=0.01, p=p)
        want = jcomp.compression_comm_bytes(_map(jnp.asarray, tree), ratio=0.01, p=p)
        assert got == want
        assert got["compressed_bytes"] < got["dense_bytes"]
