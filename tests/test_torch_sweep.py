"""The port's resumable sweep (``repro_torch.robust.sweep``) on the CPU.

On the reference tests' corpus (128 × 96, ``BN`` = 32, so B = 4 blocks):

- **Port against the JAX package and the oracle**: the sweep equals the
  reference's ``ResumableSweep`` and the port's ``apss_reference`` under
  ``_torch_parity``'s rule (every float64 score more than 1e-5 from t;
  counts and sets exact, values within 1e-6). The reference's own sweep
  tests compare with ``apss_reference`` bit for bit and fail under this
  jax (values one f32 ulp apart; ROADMAP queue 3).
- **Port against port, bit for bit**: kill then resume; a fallback past a
  corrupt step; the meta mismatch; a corrupted caravan; one step time per
  step; 4 gloo ranks (sharded, one block each), killed at step 2 with a
  delay fault on rank 1, the gathered ledger evicting rank 1 and the
  survivors resuming on 3 ranks (replicated).
- **Across packages**: the meta file is the reference's byte for byte, the
  spans and counters are the reference's, and a directory either package
  wrote is resumed by the other.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_clear_of_threshold, assert_same_matches  # noqa: E402
from repro.obs import Tracer as RTracer  # noqa: E402
from repro.planner import telemetry as rtelemetry  # noqa: E402
from repro.robust import Fault as RFault  # noqa: E402
from repro.robust import FaultPlan as RFaultPlan  # noqa: E402
from repro.robust import ResumableSweep as RSweep  # noqa: E402
from repro.robust import SweepKilled as RSweepKilled  # noqa: E402
from repro_torch.checkpoint import CheckpointCorruptionError  # noqa: E402
from repro_torch.core.apss import apss_reference  # noqa: E402
from repro_torch.distributed.straggler import StepTimer  # noqa: E402
from repro_torch.kernels.apss_block import fused  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.planner import telemetry  # noqa: E402
from repro_torch.robust import Fault, FaultPlan, ResumableSweep, SweepKilled  # noqa: E402
from repro_torch.robust import sweep as tsweep  # noqa: E402

T, K, BN = 0.35, 16, 32
PG_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0


def _sweep(D, directory, **kw):
    return ResumableSweep(D, threshold=T, k=K, block_rows=BN, directory=str(directory),
                          device="cpu", **kw)


def _rsweep(D, directory, **kw):
    return RSweep(D, threshold=T, k=K, block_rows=BN, directory=str(directory), **kw)


def _bits(m):
    return tuple(np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in m)


def _same_bits(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(_bits(a), _bits(b)))


@pytest.fixture(scope="module")
def solo(corpus, tmp_path_factory):
    """The uninterrupted one-process port sweep."""
    return _sweep(corpus, tmp_path_factory.mktemp("solo")).run()


def test_sweep_equals_jax_sweep_and_oracle(corpus, solo, tmp_path):
    assert_clear_of_threshold(corpus, corpus, T, exclude_self=True)
    assert_same_matches(solo, _rsweep(corpus, tmp_path).run())
    assert_same_matches(solo, apss_reference(corpus.copy(), T, K, device="cpu"))


def test_each_step_is_one_k4_call_of_every_block(corpus, tmp_path, monkeypatch):
    """Step s is one call of K4's masked entry over the (i, (i - s) mod B)
    worklist with qpos = global row ids and col_live = column < n."""
    calls = []
    real = tsweep.rect_tile_candidates_kernel

    def spy(Q, C, ij, *a, **kw):
        calls.append((ij.numpy().copy(), kw["col_live"].clone(), kw["qpos"].clone()))
        return real(Q, C, ij, *a, **kw)

    monkeypatch.setattr(tsweep, "rect_tile_candidates_kernel", spy)
    sweep = _sweep(corpus[:120], tmp_path)  # 120 rows: 8 padded rows in block 3
    sweep.run()
    assert sweep.B == 4 and len(calls) == 4
    for s, (ij, col_live, qpos) in enumerate(calls):
        np.testing.assert_array_equal(ij, [[0, 1, 2, 3], [(i - s) % 4 for i in range(4)]])
        assert col_live.tolist() == [True] * 120 + [False] * 8
        assert qpos.tolist() == list(range(120)) + [-1] * 8


def test_default_device_is_the_card_and_blocks_are_checked(corpus, tmp_path):
    with pytest.raises(RuntimeError, match="is_available"):
        ResumableSweep(corpus, threshold=T, directory=str(tmp_path))
    with pytest.raises(ValueError, match="power of two"):
        ResumableSweep(corpus, threshold=T, block_rows=48, directory=str(tmp_path),
                       device="cpu")
    assert ResumableSweep(corpus, threshold=T, directory=str(tmp_path / "d"),
                          device="cpu").bn == 128


def test_sweep_meta_is_the_reference_file_byte_for_byte(corpus, tmp_path):
    _sweep(corpus, tmp_path / "port")
    _rsweep(corpus, tmp_path / "jax")
    names = ("port", "jax")
    a, b = ((tmp_path / d / "sweep_meta.json").read_bytes() for d in names)
    assert a == b


def test_sweep_meta_mismatch_refuses_resume(corpus, tmp_path):
    _sweep(corpus, tmp_path).run()
    with pytest.raises(ValueError, match="meta mismatch"):
        ResumableSweep(corpus, threshold=0.5, k=K, block_rows=BN, directory=str(tmp_path),
                       device="cpu")


def test_kill_then_resume_is_bit_for_bit(corpus, solo, tmp_path):
    plan = FaultPlan([Fault("kill", step=2)])
    with pytest.raises(SweepKilled):
        _sweep(corpus, tmp_path, fault_plan=plan).run()
    assert plan.fired["kill:sweep"] == 1
    with telemetry.CommLog() as log:
        resumed = _sweep(corpus, tmp_path)
        got = resumed.run()
    assert resumed.resumed_from == 2
    assert _same_bits(got, solo)
    assert log.counters["sweep.resumed_steps"] == 2
    assert log.counters["sweep.checkpoints"] == 2


def test_restore_falls_back_past_corrupt_step(corpus, solo, tmp_path):
    killer = _sweep(corpus, tmp_path, fault_plan=FaultPlan([Fault("kill", step=3)]))
    with pytest.raises(SweepKilled):
        killer.run()
    latest = killer.manager.latest_step()
    assert latest == 3
    step_dir = os.path.join(str(tmp_path), f"step_{latest:010d}")
    leaf = sorted(f for f in os.listdir(step_dir) if f.endswith(".npy"))[0]
    FaultPlan(seed=1).corrupt_file(os.path.join(step_dir, leaf))
    with pytest.raises(CheckpointCorruptionError):
        killer.manager.restore(step=latest)
    with pytest.warns(UserWarning, match="falling back"):
        resumed = _sweep(corpus, tmp_path)
        got = resumed.run()
    assert resumed.resumed_from == 2  # one checkpoint window lost, not the job
    assert _same_bits(got, solo)


def test_corrupted_caravan_changes_result(corpus, solo, tmp_path):
    plan = FaultPlan([Fault("corrupt", scope="sweep.caravan", step=1)])
    got = _sweep(corpus, tmp_path, fault_plan=plan).run()
    assert plan.fired["corrupt:sweep.caravan"] == 1
    assert not _same_bits(got, solo)


def test_sweep_records_one_step_time_per_step(corpus, tmp_path):
    timer = StepTimer()
    sweep = _sweep(corpus, tmp_path, timer=timer)
    sweep.run()
    assert len(timer.history[0]) == sweep.B


def test_spans_and_counters_are_the_reference(corpus, tmp_path):
    """Killed at step 2, then resumed: the same ``sweep/step`` and
    ``checkpoint/save`` spans (names and attributes, in order) and the same
    counters in both packages."""
    def run(tracer, log, make, plan, killed, directory):
        with tracer, log:
            with pytest.raises(killed):
                make(corpus, directory, fault_plan=plan).run()
            make(corpus, directory).run()
        spans = [(s.name, s.attrs) for s in tracer.walk()
                 if s.name in ("sweep/step", "checkpoint/save")]
        return spans, dict(log.counters)

    got = run(Tracer(), telemetry.CommLog(), _sweep, FaultPlan([Fault("kill", step=2)]),
              SweepKilled, tmp_path / "p")
    ref = run(RTracer(), rtelemetry.CommLog(), _rsweep, RFaultPlan([RFault("kill", step=2)]),
              RSweepKilled, tmp_path / "j")
    assert got == ref
    assert [a["i"] for n, a in got[0] if n == "sweep/step"] == [0, 1, 2, 2, 3]


def test_jax_checkpoint_resumed_by_the_port(corpus, solo, tmp_path):
    with pytest.raises(RSweepKilled):
        _rsweep(corpus, tmp_path, fault_plan=RFaultPlan([RFault("kill", step=2)])).run()
    resumed = _sweep(corpus, tmp_path)
    got = resumed.run()
    assert resumed.resumed_from == 2
    assert_same_matches(got, solo)


def test_port_checkpoint_resumed_by_jax(corpus, solo, tmp_path):
    with pytest.raises(SweepKilled):
        _sweep(corpus, tmp_path, fault_plan=FaultPlan([Fault("kill", step=2)])).run()
    with rtelemetry.CommLog() as log:
        resumed = _rsweep(corpus, tmp_path)
        got = resumed.run()
    assert resumed.resumed_from == 2 and log.counters["sweep.resumed_steps"] == 2
    assert_same_matches(got, solo)


def test_ranks_killed_evict_the_straggler_and_resume_bit_for_bit(corpus, solo, tmp_path):
    """4 gloo ranks score one block each; a kill fires at step 2 on every
    rank and a delay fault slows rank 1 at every step. The gathered ledger
    evicts rank 1 on every rank, the 3 survivors resume from step 2 with
    every block (4 % 3 ≠ 0: replicated), and the result is the
    one-process sweep's bit for bit."""
    from repro_torch.launch.mesh import spawn

    path = str(tmp_path / "corpus.npy")
    np.save(path, corpus)
    faults = [Fault("kill", step=2), Fault("delay", rank=1, seconds=0.05, times=-1)]
    outs = spawn("repro_torch.launch.sweep:run_ranks", 4, path, str(tmp_path / "ranks"),
                 dict(threshold=T, k=K, block_rows=BN), faults, device="cpu", threads=1,
                 run_dir=str(tmp_path), pg_timeout=PG_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S)
    assert [o["blocks"] for o in outs] == [[0], [1], [2], [3]]
    assert all(o["sharded"] and o["killed"] for o in outs)
    assert all(o["evict"] == [1] for o in outs)
    assert outs[1]["fired"]["delay:sweep"] == 2 and outs[0]["fired"].get("delay:sweep") is None
    assert [o["resumed"] for o in outs] == [True, False, True, True]
    for o in (outs[0], outs[2], outs[3]):
        assert o["resumed_from"] == 2 and o["resumed_ranks"] == 3
        assert not o["resumed_sharded"] and o["resumed_blocks"] == [0, 1, 2, 3]
    assert _same_bits(outs[0]["matches"], solo)
    assert all("matches" not in o for o in outs[1:])


def test_plain_step_is_one_product_per_tile(corpus):
    """A step's packets equal K4's plain version called one tile at a time
    (each tile one (bn × m)·(m × bn) product), bit for bit."""
    Dd = torch.from_numpy(np.pad(corpus, ((0, 0), (0, 0))))
    ids = torch.arange(128, dtype=torch.int32)
    kw = dict(B=4, bn=BN, n=128, threshold=T, k=K, col_live=ids < 128, qpos=ids)
    step = tsweep.sweep_step(Dd, np.arange(4), 3, **kw)
    for i in range(4):
        fv, fi, fc = fused.rect_tile_candidates_plain(
            Dd, Dd, torch.tensor([[i], [(i - 3) % 4]]), T, K, block_q=BN, block_c=BN,
            nc_valid=128, col_live=ids < 128, qpos=ids)
        rows = slice(i * BN, (i + 1) * BN)
        assert torch.equal(step.indices[rows], fi[0])
        assert torch.equal(step.counts[rows], fc[0, :, 0])
        assert torch.equal(step.values[rows][fi[0] >= 0], fv[0][fi[0] >= 0])
