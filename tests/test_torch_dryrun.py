"""The port's dry run (``launch/dryrun.py``): overrides as the reference's
``tests/test_perf_variants.py`` parses them, and cells run as rank 0 of a
``fake`` process group in a subprocess (the group is global state): an LM
and a GNN cell at the production mesh, an LM training cell whose rank holds
its blocks of the weights and moments (within 1.25× of the reference's
specs), and an override that changes what the census counts. The census
against real ranks is in ``tests/test_torch_mesh.py``."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.dryrun import apply_overrides, parse_mesh, roofline_terms  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _dryrun(tmp_path, *argv) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC)
    out = str(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                           "--out", out], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (name,) = [f for f in os.listdir(out) if f.endswith(".json")]
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def test_dryrun_overrides_parse():
    cfg = get_arch("qwen3-1.7b").make_smoke_config()
    out = apply_overrides(cfg, ["grad_accum=4", "bf16_probs=True"])
    assert out.grad_accum == 4 and out.bf16_probs is True
    d = apply_overrides({"a": 1}, ["a=2", "b=x"])
    assert d == {"a": 2, "b": "x"}
    assert parse_mesh("pod=2,data=16,model=16") == {"pod": 2, "data": 16, "model": 16}


def test_roofline_terms_split_links_by_node():
    r = roofline_terms(989e12, 3.35e12, {"8": 450e9, "16": 50e9})
    assert r["compute_s"] == pytest.approx(1.0) and r["memory_s"] == pytest.approx(1.0)
    assert r["collective_s"] == pytest.approx(2.0) and r["dominant"] == "collective"


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "decode_32k"),
                                        ("gat-cora", "full_graph_sm")])
def test_dryrun_cell_at_the_production_mesh(tmp_path, arch, shape):
    res = _dryrun(tmp_path, "--arch", arch, "--shape", shape)
    assert res["status"] == "ok" and res["mesh"] == "16x16" and res["ranks"] == 256
    assert res["census"]["flops"] > 0 and res["census"]["hbm_bytes"] > 0
    assert res["resident_bytes"] > 0 and res["spec_bytes"] > 0
    assert res["peak_live_bytes"] >= res["resident_bytes"]
    assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
    if arch == "qwen3-1.7b":
        # batch 128 over data (8 rows), cache 32,768 over model (2,048 positions)
        # on every rank; weights split over model as the reference's specs, but
        # for the 8 kv heads: each rank holds the one its q head reads, which
        # two ranks share (GSPMD would cut it in halves)
        cache = 28 * 8 * 8 * 2048 * 128 * 2 * 2
        assert res["resident_bytes"] > cache
        assert res["spec_bytes"] < res["resident_bytes"] <= 1.25 * res["spec_bytes"]
        assert res["layers_counted"] == [1, 2]
        # a layer's q heads and new k/v rows (one gather) and K9's partials;
        # the embedding's width, the vocab
        assert res["census"]["collectives"]["all-gather"]["count"] == 2 * 28 + 2
    else:
        assert res["census"]["collectives"]["all-reduce"]["count"] > 0  # gradient mean


def test_dryrun_override_changes_the_census(tmp_path):
    """A rank that holds its experts runs ``moe_ffn_ep`` whatever
    ``moe_impl`` says (three all-reduces a MoE layer: ``y`` over ``model``,
    the aux loss over ``data``, the drop fraction over both), so
    ``moe_impl=ep`` changes nothing; ``n_shared_experts=0`` takes away the
    shared experts' row-parallel sum over ``model``, one a MoE layer, and
    their FLOPs."""
    argv = ("--arch", "deepseek-moe-16b", "--shape", "decode_32k", "--smoke",
            "--mesh", "data=2,model=2")
    base = _dryrun(tmp_path / "gspmd", *argv)
    ep = _dryrun(tmp_path / "ep", *argv, "--override", "moe_impl=ep")
    plain = _dryrun(tmp_path / "shared", *argv, "--override", "n_shared_experts=0")
    n_moe = get_arch("deepseek-moe-16b").make_smoke_config()
    n_moe = n_moe.n_layers - n_moe.first_k_dense
    assert ep["census"] == base["census"]
    assert (plain["census"]["collectives"]["all-reduce"]["count"]
            == base["census"]["collectives"]["all-reduce"]["count"] - n_moe)
    assert plain["census"]["flops"] < base["census"]["flops"]


def test_dryrun_train_cell_holds_the_ranks_blocks(tmp_path):
    """``train_4k`` at 16 × 16: the rank's weights and AdamW moments are its
    blocks (tensor parallel and FSDP), within 1.25× of what the reference's
    specs place on a device; only the 8 kv heads are held whole, each by
    the 2 ranks whose q heads read it."""
    res = _dryrun(tmp_path, "--arch", "qwen3-1.7b", "--shape", "train_4k")
    assert res["status"] == "ok"
    assert res["spec_bytes"] <= res["resident_bytes"] <= 1.25 * res["spec_bytes"]
    assert res["census"]["collectives"]["reduce-scatter"]["count"] > 0  # FSDP gradients
    assert res["useful_flops_ratio"] > 0.5


@pytest.mark.parametrize("arch,shape", [("two-tower-retrieval", "train_batch"),
                                        ("gat-cora", "minibatch_lg")])
def test_dryrun_recsys_and_graph_cells_hold_their_blocks(tmp_path, arch, shape):
    """At 16 × 16 a rank holds its blocks: the two-tower's tables (rows) and
    towers (columns) over model with their AdamW moments, GAT's minibatch
    graph by nodes and edges over data; resident within 1.25× of what the
    reference's specs place on a device. The two-tower gathers its in-batch
    negatives over data and the tower activations over model; GAT's
    aggregation partials reduce-scatter onto the nodes' owners."""
    res = _dryrun(tmp_path, "--arch", arch, "--shape", shape)
    assert res["status"] == "ok"
    assert res["spec_bytes"] <= res["resident_bytes"] <= 1.25 * res["spec_bytes"]
    coll = res["census"]["collectives"]
    assert coll["all-gather"]["count"] > 0
    if arch == "gat-cora":
        assert coll["reduce-scatter"]["count"] >= 2  # one a layer's aggregation


@pytest.mark.parametrize("arch", ["minicpm3-4b", "arctic-480b"])
def test_dryrun_padded_heads_hold_their_blocks(tmp_path, arch):
    """``train_4k`` at 16 × 16 where ``model`` does not divide the heads
    (minicpm3-4b's 40, arctic-480b's 56 q heads on 8 kv heads): the heads
    zero-padded to 48 and 64, 3 and 4 a rank (arctic's kv head shared by 2
    ranks), so a rank's weights and moments stay within 1.25× of what the
    reference's specs place on a device, and attention's work splits over
    model: a third or more of the census is the model's own FLOPs (with
    attention whole on every rank it was 0.075 and 0.105)."""
    res = _dryrun(tmp_path, "--arch", arch, "--shape", "train_4k")
    assert res["status"] == "ok" and res["mesh"] == "16x16"
    assert res["spec_bytes"] <= res["resident_bytes"] <= 1.25 * res["spec_bytes"]
    assert res["useful_flops_ratio"] > 0.3
