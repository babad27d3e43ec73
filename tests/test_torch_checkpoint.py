"""The port's checkpointer (``repro_torch.checkpoint``) and fault plan
(``repro_torch.robust``), on the CPU, against the reference's.

The on-disk format is the reference's byte for byte: a state saved by
either package is read by the other's ``load_checkpoint``, and the same
state saved by both gives identical files. Integrity (digest mismatch,
truncation), ``restore(fallback=True)`` past a corrupt step, keep-last-k,
async write errors raised on the next call, and the preemption handler
follow the reference's contract; each corruption case is also read by the
reference's loader, which must refuse the same files. The fault plan's
determinism and firing rules equal the reference's for the same seeds.
"""

import filecmp
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointCorruptionError as RCorrupt  # noqa: E402
from repro.checkpoint import load_checkpoint as rload  # noqa: E402
from repro.checkpoint import save_checkpoint as rsave  # noqa: E402
from repro.robust.faults import FaultPlan as RFaultPlan  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointCorruptionError,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.obs import FlightRecorder  # noqa: E402
from repro_torch.robust import Fault, FaultPlan, InjectedFault  # noqa: E402


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(8, 8)).astype(np.float32),
        "opt": {"step": np.int64(seed), "m": [rng.normal(size=3), np.arange(4, dtype=np.int32)]},
        "mask": rng.random(5) < 0.5,
    }


def _leaf_path(directory, step, name="w"):
    return os.path.join(directory, f"step_{step:010d}", f"{name}.npy")


# -- format -----------------------------------------------------------------------


def test_same_state_gives_identical_files(tmp_path):
    state = _state(1)
    a = save_checkpoint(state, str(tmp_path / "port"), 3)
    b = rsave(state, str(tmp_path / "ref"), 3)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == errors == []


def test_tensors_are_saved_from_the_host_as_their_arrays(tmp_path):
    state = _state(2)
    as_tensors = {"w": torch.from_numpy(state["w"]), "opt": {
        "step": state["opt"]["step"],
        "m": [torch.from_numpy(state["opt"]["m"][0]), torch.from_numpy(state["opt"]["m"][1])]},
        "mask": torch.from_numpy(state["mask"])}
    a = save_checkpoint(as_tensors, str(tmp_path / "t"), 1)
    b = save_checkpoint(state, str(tmp_path / "n"), 1)
    names = sorted(os.listdir(a))
    assert filecmp.cmpfiles(a, b, names, shallow=False)[0] == names


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_package_reads_the_others_checkpoint(tmp_path, writer):
    state = _state(3)
    (save_checkpoint if writer == "port" else rsave)(state, str(tmp_path), 7)
    flat = (rload if writer == "port" else load_checkpoint)(str(tmp_path), 7)
    assert sorted(flat) == ["mask", "opt/m/0", "opt/m/1", "opt/step", "w"]
    np.testing.assert_array_equal(flat["w"], state["w"])
    np.testing.assert_array_equal(flat["opt/m/1"], state["opt"]["m"][1])
    assert flat["mask"].dtype == bool
    tree = load_checkpoint(str(tmp_path), 7, like=state)
    assert isinstance(tree["opt"]["m"], list)
    np.testing.assert_array_equal(tree["opt"]["m"][0], state["opt"]["m"][0])


def test_like_with_another_structure_raises(tmp_path):
    save_checkpoint(_state(4), str(tmp_path), 1)
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(str(tmp_path), 1, like={"w": 0})


# -- integrity ----------------------------------------------------------------------


def test_checksum_detects_bitflip(tmp_path):
    save_checkpoint(_state(5), str(tmp_path), 1)
    FaultPlan(seed=3).corrupt_file(_leaf_path(str(tmp_path), 1))
    with pytest.raises(CheckpointCorruptionError, match="checksum mismatch"):
        load_checkpoint(str(tmp_path), 1)
    with pytest.raises(RCorrupt, match="checksum mismatch"):
        rload(str(tmp_path), 1)


def test_truncated_leaf_is_refused(tmp_path):
    save_checkpoint(_state(6), str(tmp_path), 1)
    path = _leaf_path(str(tmp_path), 1)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 16)
    with pytest.raises(CheckpointCorruptionError):
        load_checkpoint(str(tmp_path), 1)
    with pytest.raises(RCorrupt):
        rload(str(tmp_path), 1)


def test_restore_falls_back_past_corrupt_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in (1, 2, 3):
        mgr.save(_state(s), s)
    FaultPlan(seed=1).corrupt_file(_leaf_path(str(tmp_path), 3))
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(step=3)
    with FlightRecorder() as fr, pytest.warns(UserWarning, match="falling back"):
        state, step = mgr.restore(like=_state(0), fallback=True)
    assert step == 2
    np.testing.assert_array_equal(state["w"], _state(2)["w"])
    assert [r for r, _, _ in fr.dumps] == ["checkpoint.corruption_fallback"]
    with pytest.raises(RCorrupt):  # the reference refuses the same step
        rload(str(tmp_path), 3)
    np.testing.assert_array_equal(rload(str(tmp_path), 2)["w"], _state(2)["w"])


def test_restore_raises_when_all_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save({"x": np.ones(4, np.float32)}, 1)
    FaultPlan(seed=1).corrupt_file(_leaf_path(str(tmp_path), 1, "x"))
    with pytest.warns(UserWarning):
        with pytest.raises(CheckpointCorruptionError, match="every kept"):
            mgr.restore(fallback=True)


def test_restore_of_an_empty_directory(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore() == (None, None)


def test_keep_last_k_and_existing_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(_state(s), s)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    mgr.save(_state(9), 4)  # an existing step is not rewritten
    np.testing.assert_array_equal(load_checkpoint(str(tmp_path), 4)["w"], _state(4)["w"])
    wal = CheckpointManager(str(tmp_path / "wal"), keep=0)  # keep=0: keep every step
    for s in (1, 2, 3):
        wal.save({"op": np.int64(s)}, s)
    assert wal.all_steps() == [1, 2, 3]


# -- async writes ---------------------------------------------------------------------


def test_async_save_writes_a_host_copy(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    x = torch.arange(6, dtype=torch.float32)
    mgr.save({"x": x}, 1, blocking=False)
    x += 100  # the caller's next step may write its tensors at once
    mgr.wait()
    np.testing.assert_array_equal(rload(str(tmp_path), 1)["x"], np.arange(6, dtype=np.float32))


def test_async_write_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=2)

    def boom(state, directory, step):
        raise OSError("disk full")

    monkeypatch.setattr(checkpointer, "save_checkpoint", boom)
    mgr.save({"x": np.ones(4, np.float32)}, 1, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once, then cleared


def test_async_write_error_surfaces_on_next_save(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    real = checkpointer.save_checkpoint

    def boom(state, directory, step):
        raise OSError("quota exceeded")

    monkeypatch.setattr(checkpointer, "save_checkpoint", boom)
    mgr.save({"x": np.ones(4, np.float32)}, 1, blocking=False)
    mgr._writer.join()
    monkeypatch.setattr(checkpointer, "save_checkpoint", real)
    with pytest.raises(OSError, match="quota exceeded"):
        mgr.save({"x": np.ones(4, np.float32)}, 2)
    assert mgr.all_steps() == []


def test_preemption_handler_checkpoints_then_exits(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        mgr.install_preemption_handler(lambda: ({"x": np.arange(3)}, 5))
        with pytest.raises(SystemExit) as e:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert e.value.code == 128 + signal.SIGTERM
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    np.testing.assert_array_equal(rload(str(tmp_path), 5)["x"], np.arange(3))


# -- the fault plan ---------------------------------------------------------------------


def test_chaos_plan_is_deterministic_and_the_references():
    a = FaultPlan.chaos(7, steps=16, kill=True)
    assert a.faults == FaultPlan.chaos(7, steps=16, kill=True).faults
    assert a.faults != FaultPlan.chaos(8, steps=16, kill=True).faults
    ref = RFaultPlan.chaos(7, steps=16, kill=True)
    assert [vars(f) for f in a.faults] == [vars(f) for f in ref.faults]


def test_fault_times_are_consumed():
    plan = FaultPlan([Fault("error", scope="s", times=2)])
    for _ in range(2):
        with pytest.raises(InjectedFault):
            plan.fail_point("s")
    plan.fail_point("s")  # exhausted: no-op
    assert plan.fired["error:s"] == 2
    assert not plan.armed("error", "s")


def test_unmatched_hooks_are_noops():
    plan = FaultPlan([Fault("kill", step=3)])
    plan.kill_point(2)
    plan.fail_point("anything")
    assert plan.delay("sweep", step=0) == 0.0
    x = np.ones(4)
    assert plan.corrupt_array(x, step=0) is x
    assert plan.total_fired == 0


def test_corruption_is_seeded_like_the_references(tmp_path):
    x = np.linspace(0, 1, 32, dtype=np.float32)
    a = FaultPlan([Fault("corrupt", scope="sweep.caravan")], seed=5).corrupt_array(x.copy(), step=3)
    b = RFaultPlan([Fault("corrupt", scope="sweep.caravan")], seed=5).corrupt_array(x.copy(),
                                                                                 step=3)
    assert np.array_equal(a, b) and not np.array_equal(a, x)
    for plan, name in ((FaultPlan(seed=4), "p"), (RFaultPlan(seed=4), "r")):
        (tmp_path / name).write_bytes(bytes(range(256)))
        assert plan.corrupt_file(str(tmp_path / name)) >= 128
    assert (tmp_path / "p").read_bytes() == (tmp_path / "r").read_bytes()
