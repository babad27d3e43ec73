"""The port's sharding context (``distributed/sharding.py``) against the
reference's: spec filtering on ``(data, model)``, ``(pod, data, model)``
and no mesh, ``shard`` as the identity, the axis helpers under nested
``use_mesh``, the specs of every model family keyed by the port's
parameter names, and the collective helpers on meta tensors (a dry run)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_dist import jax_mesh  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

MESHES = {"data_model": ((2, 2), ("data", "model")),
          "pod_data_model": ((2, 2, 2), ("pod", "data", "model"))}
SPECS = [(("pod", "data"), None), (None, "model"), ("model", ("pod", "data")),
         (("data", "model"),), ("pod",), (None, None, "model"), ()]


def _norm(part):
    """A spec entry with a one-axis tuple written as the axis (JAX's
    ``PartitionSpec`` prints ``("data",)`` as ``"data"``; both mean one axis)."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return part[0] if len(part) == 1 else (part or None)
    return part


def _as_tuple(spec) -> tuple:
    return tuple(_norm(p) for p in spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_filter_spec_matches_the_reference(mesh, spec):
    shape, names = MESHES[mesh]
    want = _as_tuple(jsh._filter_spec(jax_mesh(shape, names), P(*spec)))
    assert _as_tuple(sh._filter_spec(dict(zip(names, shape)), spec)) == want


def test_shard_is_the_identity_and_no_mesh_keeps_everything():
    x = torch.arange(6.0).reshape(2, 3)
    assert sh.shard(x, "data", None) is x and sh.shard_batch(x, None) is x
    assert sh.active_mesh() is None
    assert sh.data_axes() == () and sh.model_axis() is None
    assert sh.batch_spec(None) == (None, None)
    assert sh.named_sharding(("data",)) is None
    tree = {"w": x}
    assert sh.shard_params(tree, {"w": ("data", None)}) is tree


def test_axis_helpers_under_nested_use_mesh():
    outer, inner = {"pod": 2, "data": 4, "model": 2}, {"data": 8}
    with sh.use_mesh(outer):
        assert sh.active_mesh() is outer
        assert sh.data_axes() == ("pod", "data") and sh.model_axis() == "model"
        assert sh.batch_spec(None, "model") == (("pod", "data"), None, "model")
        assert sh.named_sharding((("pod", "data"), "expert")) == (("pod", "data"), None)
        with sh.use_mesh(inner):
            assert sh.data_axes() == ("data",) and sh.model_axis() is None
            assert sh.batch_spec() == (("data",),)
            with sh.use_mesh(None):
                assert sh.active_mesh() is None and sh.data_axes() == ()
            assert sh.active_mesh() is inner
        assert sh.active_mesh() is outer
    assert sh.active_mesh() is None


def test_local_shape():
    sizes = {"data": 2, "model": 4}
    assert sh.local_shape((8, 12), ("data", "model"), sizes) == (4, 3)
    assert sh.local_shape((8, 12), (("data", "model"), None), sizes) == (1, 12)
    assert sh.local_shape((6, 12), (("data", "model"),), sizes) == (6, 12)  # 8 ∤ 6
    assert sh.local_shape((8, 12), ("pod", None), sizes) == (8, 12)


def _ref_names(jtree) -> dict:
    """The reference's spec tree as ``{path: spec}`` (lists by index)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, P):
            out[prefix] = _as_tuple(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
        else:
            for k, v in zip(node._fields, node):
                walk(v, f"{prefix}.{k}")

    walk(jtree, "")
    return out


@pytest.mark.parametrize("name", ["two-tower-retrieval", "bert4rec", "din", "bst", "gat-cora"])
def test_recsys_and_gnn_specs_are_the_references(name):
    cfg, jcfg = get_arch(name).make_smoke_config(), jget_arch(name).make_smoke_config()
    fn = {"two-tower-retrieval": "two_tower_param_specs", "bert4rec": "bert4rec_param_specs",
          "din": "din_param_specs", "bst": "bst_param_specs", "gat-cora": "gat_param_specs"}[name]
    module = gnn if name == "gat-cora" else recsys
    jmodule = jgnn if name == "gat-cora" else jrecsys
    got = getattr(module, fn)(cfg)
    assert got == _ref_names(getattr(jmodule, fn)(jcfg))
    init = (gnn.init_gat if name == "gat-cora" else
            {"two-tower-retrieval": recsys.init_two_tower, "bert4rec": recsys.init_bert4rec,
             "din": recsys.init_din, "bst": recsys.init_bst}[name])
    assert sorted(got) == sorted(n for n, _ in init(cfg, device="meta").named_parameters())


def test_moe_param_specs_are_the_references():
    from repro.models import moe as jmoe
    from repro_torch.models import moe

    want = {k: _as_tuple(v) for k, v in jmoe.moe_param_specs(P)._asdict().items()}
    assert moe.moe_param_specs() == want
    assert sorted(want) == sorted(n for n, _ in moe.MoEParams(4, 2, 2, torch.float32,
                                                               "meta").named_parameters())


@pytest.mark.parametrize("name", ["qwen3-1.7b", "minicpm3-4b", "deepseek-moe-16b",
                                  "arctic-480b"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_transformer_specs_are_the_references(name, fsdp):
    """Every parameter's spec is the reference's, reversed for an
    ``nn.Linear`` weight (the transpose of the reference's matrix), with
    the stacked layer dim dropped."""
    import dataclasses

    cfg = dataclasses.replace(get_arch(name).make_smoke_config(), fsdp=fsdp)
    jcfg = dataclasses.replace(jget_arch(name).make_smoke_config(), fsdp=fsdp)
    ref = _ref_names(jt.param_specs(jcfg))
    got = tt.param_specs(cfg)
    assert sorted(got) == sorted(n for n, _ in tt.Transformer(cfg, "meta").named_parameters())
    for key, spec in got.items():
        parts = key.split(".")
        weight = parts[-1] == "weight"
        if parts[0] == "layers":  # the reference stacks these: drop the layer index
            parts = ["layers", *parts[2:]]
        path = ".".join(parts[:-1] if weight else parts)
        want = ref[path]
        if parts[0] == "layers":
            want = want[1:]
        if weight:
            want = tuple(reversed(want))
        assert spec == want, key


@pytest.mark.parametrize("name", ["qwen3-1.7b", "minicpm3-4b", "deepseek-moe-16b"])
def test_cache_specs_are_the_references(name):
    cfg, jcfg = get_arch(name).make_smoke_config(), jget_arch(name).make_smoke_config()
    for seq, bat in ((("model",), ("pod", "data")), (("data", "model"), ())):
        want = _ref_names(jt.cache_specs(jcfg, seq_axes=seq, batch_axes=bat))
        got = tt.cache_specs(cfg, seq_axes=seq, batch_axes=bat)
        assert {k: _as_tuple(v) for k, v in got.items()} == want
        assert set(tt.make_cache(cfg, 1, 4, device="meta")) == set(want)


def test_collectives_on_meta_report_and_return_meta():
    """On meta tensors (a dry run) each collective helper reports to the
    census and returns a meta tensor of its result's shape; the process
    group is never touched (the stand-in mesh has none)."""
    from repro_torch.core import distributed as dd
    from repro_torch.launch.op_analysis import analyze

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (4, 2)

        def get_group(self, axis):
            raise AssertionError("a meta collective touched the process group")

    mesh, x = Mesh(), torch.empty(8, 3, device="meta")
    calls = {
        "all-gather": lambda: dd._all_gather(x, mesh, "data", dim=1),
        "all-reduce": lambda: dd._psum(x, mesh, "model"),
        "reduce-scatter": lambda: dd._psum_scatter(x, mesh, "data"),
        "collective-permute": lambda: dd._ppermute((x,), mesh, "data", dd._ring_perm(4))[0],
    }
    shapes = {"all-gather": (8, 12), "all-reduce": (8, 3), "reduce-scatter": (2, 3),
              "collective-permute": (8, 3)}
    for kind, call in calls.items():
        out, counts = analyze(call)
        assert out.is_meta and tuple(out.shape) == shapes[kind], kind
        assert counts["collectives"][kind]["count"] == 1
    out, counts = analyze(lambda: dd.psum_in_order(x, mesh, ("data", "model")))
    assert out.is_meta and counts["collectives"]["all-reduce"]["payload_bytes"] == 96
    assert counts["link_bytes_by_group"] == {"8": 2 * 96 * 7 / 8}
    assert np.isclose(counts["link_bytes"], 2 * 96 * 7 / 8)
