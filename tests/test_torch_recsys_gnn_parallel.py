"""The recsys and GNN families split as the reference's specs split them,
against the port's one process and the reference under GSPMD, on the CPU.

One spawn of 4 gloo ranks (``tests/_torch_dist.recsys_gnn_ranks``) runs
every case on a ``data=2 × model=2``, a ``model=4`` and (GAT only) a
``data=4`` mesh in the same ranks. Each rank holds its blocks of one numpy
tree of the reference's structure per smoke config (``interop`` with
``mesh=``): the recsys tables' rows and the tower columns over ``model``,
BERT4Rec's and BST's blocks as Megatron pairs (whole heads only: at
``model=4`` their 2 heads are zero-padded to 4, one a rank), GAT's weights
whole and its graph cut by nodes and edges over ``data``. Tolerances:

- parameter and AdamW moment blocks are ``local_shape`` of
  ``recsys.layout_specs`` (the reference's specs but for the listed padded
  heads), exactly; a padded head's weights and moments are exactly 0
  after the step;
- the scores of the rank's rows, the loss and metrics, the gradients
  (averaged over the data ranks, gathered), and one ``make_*_train_step``
  (metrics, the parameters and moments after it, gathered) against the
  port's one-process step on the whole batch within 1e-5 relative (a
  leaf's entries within 1e-5 of its largest |value|);
- the same against the reference's jitted step with its specs as
  ``in_shardings`` on ``jax_mesh((2, 2))`` (GSPMD), within 1e-5; the
  parameters after the step within 1e-5 of their leaf's largest plus the
  first step's slope in the gradient times the gradients' 1e-5, as
  ``tests/test_torch_tensor_parallel.py`` holds them (AdamW's first step
  moves an entry by ``lr · g / (|g| + eps)``: a gradient entry near
  ``eps`` turns a last-bit difference of ``g`` into one of up to ``lr``;
  one BERT4Rec entry moves 1.4e-5 against the reference);
- the two-tower's in-batch negatives and BERT4Rec's masked mean are the
  global batch's: the mesh's loss is the whole batch's and not the mean of
  each data shard's own;
- the vocab-parallel lookup equals one process's ``take`` bit for bit, and
  its gradient is the rank's rows of the whole table's;
- ``interop`` round trips with ``mesh=`` return the tree bit for bit, as
  ``sharding.cut_tree``/``gather_tree`` of a ``ParamTree`` do;
  ``train_loop(mesh=)`` on gat-cora and two-tower stopped and resumed
  equals the straight run bit for bit; the two-tower's ``retrieval_cand``
  cell (``sharded_retrieval``, tables over ``model``, candidates over
  ``data``) equals one process's ``retrieval_scores`` under the parity rule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_dist import JOIN_TIMEOUT_S, PG_TIMEOUT_S, RG_MESHES, jax_mesh  # noqa: E402
from _torch_parity import assert_same_matches  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import shardings_for as jshardings_for  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import GraphPipeline, RecsysPipeline  # noqa: E402
from repro_torch.distributed.sharding import local_shape  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.optim.optimizer import tree_leaves  # noqa: E402

REL = 1e-5
HP = train.TrainHyperparams(warmup_steps=2, total_steps=10)
B = 8  # recsys batch rows: 4 a data rank at data=2

# arch -> (reference init, specs, loss, score; port loss, score; pipeline kind)
FAMILY = {
    "two-tower-retrieval": (jrec.init_two_tower, jrec.two_tower_param_specs,
                            jrec.two_tower_loss, jrec.two_tower_score,
                            recsys.two_tower_loss, recsys.two_tower_score, "two-tower"),
    "bert4rec": (jrec.init_bert4rec, jrec.bert4rec_param_specs, jrec.bert4rec_loss,
                 jrec.bert4rec_score, recsys.bert4rec_loss, recsys.bert4rec_score, "seq"),
    "din": (jrec.init_din, jrec.din_param_specs, jrec.din_loss, jrec.din_logits,
            recsys.din_loss, recsys.din_logits, "ctr"),
    "bst": (jrec.init_bst, jrec.bst_param_specs, jrec.bst_loss, jrec.bst_logits,
            recsys.bst_loss, recsys.bst_logits, "ctr"),
}
RECSYS_MESHES = ("data2_model2", "model4")
GAT_NODES, GAT_EDGES = 64, 512


def _fill(init, jcfg, seed=0):
    """A reference tree from numpy at init scales: 0.1 × normal, norm scales
    1 + 0.1 × normal."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.key(0))

    def fill(path, s):
        a = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return a + 1 if "norm" in jax.tree_util.keystr(path) else a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(cfg, kind, seed=3):
    if kind == "two-tower":
        pipe = RecsysPipeline(n_items=cfg.n_items, batch_size=B, history_len=cfg.history_len,
                              n_user_fields=cfg.n_user_fields, user_vocab=cfg.user_vocab,
                              kind=kind, seed=0)
    else:
        hist = cfg.seq_len - 1 if isinstance(cfg, recsys.BSTConfig) else cfg.seq_len
        pipe = RecsysPipeline(n_items=cfg.n_items, batch_size=B, history_len=hist, kind=kind,
                              seed=0)
    batch = pipe.get_batch(seed)
    if "history" in batch:
        batch["history"][::2, -3:] = -1  # padded history slots
    if "mask" in batch:  # the data shards' mask counts differ
        batch["mask"][:B // 2, ::2] = False
    return batch


def _graph():
    cfg = get_arch("gat-cora").make_smoke_config()
    g = GraphPipeline(GAT_NODES, GAT_EDGES, cfg.d_feat, n_classes=cfg.n_classes).full_graph()
    g["edge_mask"][::7] = 0  # masked edges, and nodes with no live in-edge
    g["label_mask"][::3] = 0
    return g


def _cases():
    out = {}
    for arch, (jinit, *_, tloss, tscore, kind) in FAMILY.items():
        jcfg, cfg = jget_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()
        out[arch] = dict(cfg=cfg, tree=_fill(jinit, jcfg), batch=_batch(cfg, kind),
                         score_fn=tscore, loss_fn=tloss, hp=HP)
    jcfg = jget_arch("gat-cora").make_smoke_config()
    gat = dict(cfg=get_arch("gat-cora").make_smoke_config(), tree=_fill(jgnn.init_gat, jcfg),
               graph=_graph(), hp=HP)
    return out, gat


CASES, GAT = _cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    tt = CASES["two-tower-retrieval"]
    spec = {"recsys": CASES, "gat": GAT,
            "lookup": dict(table=np.random.default_rng(7).standard_normal((16, 3)).astype(
                np.float32), ids=np.array([[0, 5, 9, 5], [15, 4, 8, 12]])),
            "retrieval": dict(cfg=tt["cfg"], tree=tt["tree"],
                              query={k: v[:1] for k, v in tt["batch"].items()},
                              candidates=np.arange(tt["cfg"].n_items, dtype=np.int32)),
            "loops": {arch: str(tmp_path_factory.mktemp(arch))
                      for arch in ("gat-cora", "two-tower-retrieval")}}
    return spawn("_torch_dist:recsys_gnn_ranks", 4, spec, device="cpu", threads=1,
                 run_dir=str(tmp_path_factory.mktemp("ranks")), pg_timeout=PG_TIMEOUT_S,
                 join_timeout=JOIN_TIMEOUT_S)


# -- the port's one process, the reference under GSPMD ---------------------------------

_ONE: dict = {}


def _one_process(arch) -> dict:
    """The port's one-process results on the whole batch, as the ranks'."""
    if arch in _ONE:
        return _ONE[arch]
    if arch == "gat-cora":
        cfg, model = GAT["cfg"], interop.gat_params_from_numpy(GAT["tree"], GAT["cfg"], "cpu")
        batch = {k: torch.as_tensor(v) for k, v in GAT["graph"].items()}
        to_numpy, step = interop.gat_params_to_numpy, train.make_gat_train_step(cfg, HP)

        def loss_fn(p, b):
            return gnn.gat_loss(p, cfg, b)
        with torch.no_grad():
            score = gnn.gat_forward(model, cfg, batch).numpy()
    else:
        case = CASES[arch]
        cfg = case["cfg"]
        model = interop.recsys_params_from_numpy(case["tree"], cfg, "cpu")
        batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
        to_numpy, step = interop.recsys_params_to_numpy, train.make_recsys_train_step(cfg, HP)

        def loss_fn(p, b):
            return case["loss_fn"](p, cfg, b)
        with torch.no_grad():
            score = case["score_fn"](model, cfg, batch).numpy()
    loss, aux, grads = train.grads_of(loss_fn, model, batch)
    opt = optim.adamw_init(train.params_of(model))
    _, opt, metrics = step(model, opt, batch)
    _ONE[arch] = {"score": score, "loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
                  "grads": interop.named_to_numpy(model, grads, to_numpy),
                  "metrics": {k: float(v) for k, v in metrics.items()},
                  "params": to_numpy(model),
                  "m": interop.named_to_numpy(model, opt.m, to_numpy),
                  "v": interop.named_to_numpy(model, opt.v, to_numpy)}
    return _ONE[arch]


_GSPMD: dict = {}


def _gspmd(arch) -> dict:
    """The reference's step jitted on ``jax_mesh((2, 2))`` with its specs as
    ``in_shardings`` (the batch over ``data``): gradients, parameters after
    the step, metrics."""
    if arch in _GSPMD:
        return _GSPMD[arch]
    mesh = jax_mesh((2, 2), ("data", "model"))
    if arch == "gat-cora":
        jcfg, tree, batch = jget_arch(arch).make_smoke_config(), GAT["tree"], GAT["graph"]
        specs = jgnn.gat_param_specs(jcfg)

        def loss_fn(p, b):
            return jgnn.gat_loss(p, jcfg, b)
    else:
        jinit, jspecs, jloss, *_ = FAMILY[arch]
        jcfg, tree, batch = jget_arch(arch).make_smoke_config(), CASES[arch]["tree"], \
            CASES[arch]["batch"]
        specs = jspecs(jcfg)

        def loss_fn(p, b):
            return jloss(p, jcfg, b)

    def step(p, b):
        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        o = jopt.adamw_init(p)
        lr = jopt.cosine_schedule(o.step, HP.lr, HP.warmup_steps, HP.total_steps)
        new_p, new_o, om = jopt.adamw_update(g, o, p, lr=lr, b1=HP.b1, b2=HP.b2,
                                             weight_decay=HP.weight_decay, clip_norm=HP.clip_norm)
        return g, new_p, new_o, {"loss": loss, **aux, **om}

    p_sh = jshardings_for(mesh, specs)
    b_sh = {k: NamedSharding(mesh, P("data", *([None] * (np.ndim(v) - 1))))
            for k, v in batch.items()}
    fn = jax.jit(step, in_shardings=(p_sh, b_sh))
    g, new_p, new_o, met = fn(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    _GSPMD[arch] = {"grads": jax.tree.map(np.asarray, g), "params": jax.tree.map(np.asarray, new_p),
                    "m": jax.tree.map(np.asarray, new_o.m),
                    "metrics": {k: float(v) for k, v in met.items()}}
    return _GSPMD[arch]


def _close_trees(got, want):
    """Each leaf within 1e-5 of its largest |value|."""
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * max(float(np.abs(b).max()), 1e-30))


def _first_step_slack(m, lr, b1=HP.b1, eps=1e-8):
    """How far a first AdamW step moves a parameter when its gradient ``g``
    moves by ``δ = REL · max|g|``: the step is ``lr · g / (|g| + eps)``,
    whose slope ``lr · eps / (|g| + eps)²`` is ``lr / eps`` near ``g = 0``.
    ``g`` is the clipped gradient, ``m / (1 − b1)``."""
    g = np.abs(np.asarray(m, np.float64)) / (1 - b1)
    return lr * eps * REL * g.max() / (g + eps) ** 2


def _close_params(got, want, m, lr):
    """Parameters after a first step: 1e-5 of the leaf's largest, plus
    :func:`_first_step_slack` of the reference's moment ``m``."""
    for a, b, mm in zip(tree_leaves(got), tree_leaves(want), tree_leaves(m), strict=True):
        b = np.asarray(b, np.float64)
        err = np.abs(np.asarray(a, np.float64) - b)
        assert (err <= REL * np.abs(b).max() + _first_step_slack(mm, lr)).all()


def _close_metrics(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=REL, atol=1e-7, err_msg=key)


def _result(ranks, mesh_name, arch):
    r = ranks[0][mesh_name]
    return r["gat"] if arch == "gat-cora" else r["recsys"][arch]


PAIRS = [(m, a) for m in RECSYS_MESHES for a in FAMILY] + \
    [(m, "gat-cora") for m in RG_MESHES]


# -- blocks ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name,arch", PAIRS)
def test_blocks_are_the_local_shapes_of_the_layout(ranks, mesh_name, arch):
    shape, names = RG_MESHES[mesh_name]
    sizes = dict(zip(names, shape))
    if arch == "gat-cora":
        axes = ranks[0][mesh_name]["gat"]["axes"]
        want = {k: local_shape(np.shape(v), spec, sizes)
                for (k, v), spec in zip(GAT["graph"].items(),
                                        (gnn.graph_specs(axes)[k] for k in GAT["graph"]))}
        for r in ranks:
            assert r[mesh_name]["gat"]["block"] == want
        assert axes == ((("data",), ("data",)) if "data" in sizes else ((), ()))
        return
    cfg = CASES[arch]["cfg"]
    layout, base = recsys.layout_specs(cfg, sizes), recsys.param_specs(cfg)
    repl = recsys.layout_replications(cfg, sizes)
    whole = recsys._FAMILY[type(cfg)][0](cfg, device="meta")
    for r in ranks:
        got = r[mesh_name]["recsys"][arch]
        for name, p in whole.named_parameters():
            local = local_shape(tuple(p.shape), layout[name], sizes)
            assert got["shapes"][name] == local == got["moment_shapes"][name], name
            if name not in repl:
                assert local == local_shape(tuple(p.shape), base[name], sizes), name
    heads_split = getattr(cfg, "n_heads", 1) % sizes["model"] == 0
    assert bool(repl) == (arch in ("bert4rec", "bst") and not heads_split)
    table = dict(whole.named_parameters())["item_table"].shape[0]
    assert ranks[0][mesh_name]["recsys"][arch]["shapes"]["item_table"][0] == \
        table // sizes["model"]


# -- against one process ----------------------------------------------------------------


@pytest.mark.parametrize("mesh_name,arch", PAIRS)
def test_mesh_step_matches_one_process(ranks, mesh_name, arch):
    want = _one_process(arch)
    for r in ranks:
        got = r[mesh_name]["gat"] if arch == "gat-cora" else r[mesh_name]["recsys"][arch]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
        _close_metrics(got["aux"], want["aux"])
        _close_metrics(got["metrics"], want["metrics"])
        for key in ("grads", "m", "v"):
            _close_trees(got[key], want[key])
        _close_params(got["params"], want["params"], want["m"], want["metrics"]["lr"])


@pytest.mark.parametrize("mesh_name,arch", PAIRS)
def test_mesh_scores_match_one_process(ranks, mesh_name, arch):
    """Each rank's scores (recsys) or logits (GAT) are its rows' or nodes'."""
    want = _one_process(arch)["score"]
    shape, names = RG_MESHES[mesh_name]
    q = dict(zip(names, shape)).get("data", 1)
    n = want.shape[0] // q
    for r in ranks:
        d = r[mesh_name]["coord"][0] if "data" in names else 0
        got = _result([r], mesh_name, arch)["logits" if arch == "gat-cora" else "score"]
        np.testing.assert_allclose(got, want[d * n:(d + 1) * n], rtol=REL, atol=1e-6)


# -- against the reference under GSPMD ----------------------------------------------------


@pytest.mark.parametrize("arch", [*FAMILY, "gat-cora"])
def test_mesh_step_matches_the_reference_under_gspmd(ranks, arch):
    want = _gspmd(arch)
    got = _result(ranks, "data2_model2", arch)
    _close_metrics(got["metrics"], want["metrics"])
    for key in ("grads", "m"):
        _close_trees(got[key], want[key])
    _close_params(got["params"], want["params"], want["m"], want["metrics"]["lr"])


# -- the global batch -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "bert4rec"])
def test_loss_is_the_global_batchs_not_each_shards(ranks, arch):
    """Each data shard's own in-batch softmax (two-tower) or masked mean
    (BERT4Rec) gives another loss; the mesh gives the whole batch's."""
    case = CASES[arch]
    model = interop.recsys_params_from_numpy(case["tree"], case["cfg"], "cpu")
    halves = []
    with torch.no_grad():
        for lo in (0, B // 2):
            part = {k: torch.as_tensor(v[lo:lo + B // 2]) for k, v in case["batch"].items()}
            halves.append(float(case["loss_fn"](model, case["cfg"], part)[0]))
    whole = _one_process(arch)["loss"]
    assert abs(np.mean(halves) - whole) > 100 * REL * abs(whole)
    np.testing.assert_allclose(_result(ranks, "data2_model2", arch)["loss"], whole, rtol=REL)


# -- lookups, interop, loops, retrieval ---------------------------------------------------


def test_vocab_parallel_lookup_is_one_process_bit_for_bit(ranks):
    table = np.random.default_rng(7).standard_normal((16, 3)).astype(np.float32)
    ids = np.array([[0, 5, 9, 5], [15, 4, 8, 12]])
    whole = np.zeros_like(table)
    np.add.at(whole, ids.reshape(-1), 1.0)
    for r in ranks:
        got = r["data2_model2"]["lookup"]
        np.testing.assert_array_equal(got["got"], got["want"])
        np.testing.assert_array_equal(got["want"], table[ids])
        m = r["data2_model2"]["coord"][1]
        np.testing.assert_array_equal(got["grad"], whole[m * 8:(m + 1) * 8])


@pytest.mark.parametrize("mesh_name,arch", PAIRS)
def test_interop_round_trip_with_a_mesh(ranks, mesh_name, arch):
    tree = GAT["tree"] if arch == "gat-cora" else CASES[arch]["tree"]
    for r in ranks:
        got = _result([r], mesh_name, arch)["round_trip"]
        for a, b in zip(tree_leaves(got), tree_leaves(tree), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("mesh_name,arch", [p for p in PAIRS if p[1] != "gat-cora"])
def test_cut_tree_and_gather_tree_take_a_param_tree(ranks, mesh_name, arch):
    """``sharding.cut_tree`` of a whole ``ParamTree`` is ``interop``'s blocks
    (values and tags), and ``gather_tree`` brings it back whole."""
    assert all(r[mesh_name]["recsys"][arch]["cut_tree"] for r in ranks)


@pytest.mark.parametrize("arch", ["gat-cora", "two-tower-retrieval"])
def test_resumed_train_loop_on_a_mesh_is_bit_for_bit(ranks, arch):
    for r in ranks:
        loop = r["data2_model2"]["loops"][arch]
        assert loop["straight"] == loop["resumed"]
        assert loop["straight_ck"].keys() == loop["resumed_ck"].keys()
        for k in loop["straight_ck"]:
            np.testing.assert_array_equal(loop["straight_ck"][k], loop["resumed_ck"][k])
    # whole tensors in the checkpoint: the two-tower's tables gathered
    cfg = get_arch("two-tower-retrieval").make_smoke_config()
    ck = ranks[0]["data2_model2"]["loops"]["two-tower-retrieval"]["straight_ck"]
    if arch == "two-tower-retrieval":
        (table,) = [v for k, v in ck.items() if k.endswith("item_table") and "params" in k]
        assert table.shape == (cfg.n_items, cfg.embed_dim)


def test_sharded_retrieval_with_tables_over_model(ranks):
    tt = CASES["two-tower-retrieval"]
    model = interop.recsys_params_from_numpy(tt["tree"], tt["cfg"], "cpu")
    query = {k: v[:1] for k, v in tt["batch"].items()}
    want = recsys.retrieval_scores(model, tt["cfg"], query,
                                   np.arange(tt["cfg"].n_items, dtype=np.int32), k=256)
    for r in ranks:
        got = r["data2_model2"]["retrieval"]
        assert_same_matches(type(want)(*(torch.as_tensor(got[k])
                                         for k in ("values", "indices", "counts"))), want)


def test_layout_replications_name_the_heads_that_do_not_split():
    for arch, cfg in ((a, CASES[a]["cfg"]) for a in ("bert4rec", "bst")):
        assert recsys.layout_replications(cfg, {"data": 2, "model": 2}) == {}
        repl = recsys.layout_replications(cfg, {"model": 4})
        assert sorted(n.rsplit(".", 1)[-1] for n in repl) == ["wk", "wo", "wq", "wv"], arch
        # 2 heads zero-padded to 4: one head a rank, not the whole matrix
        hd = cfg.embed_dim // cfg.n_heads
        layout = recsys.layout_specs(cfg, {"model": 4})
        for name in repl:
            dim = 0 if name.endswith("wo") else 1
            whole = (cfg.embed_dim, cfg.embed_dim)
            assert local_shape(whole, layout[name], {"model": 4})[dim] == hd, name
            assert "zero-padded to 4" in repl[name], name
    for arch in ("two-tower-retrieval", "din"):
        assert recsys.layout_replications(CASES[arch]["cfg"], {"model": 4}) == {}


@pytest.mark.parametrize("arch", ["bert4rec", "bst"])
def test_padded_heads_stay_zero_through_a_step(ranks, arch):
    """At ``model=4`` BERT4Rec's and BST's 2 heads are padded to 4, one a
    rank: ranks 2 and 3 hold a zero head in each attention matrix, and
    after the step (held to one process above) its weights and both AdamW
    moments are exactly 0 (a zero head's ``q``, ``k`` and ``v`` are zero,
    and ``wo``'s zero rows pass it no gradient)."""
    cfg = CASES[arch]["cfg"]
    padded = [r["model4"]["recsys"][arch]["padded"] for r in ranks]
    assert [bool(p) for p in padded] == [False, False, True, True]
    for p in padded[2:]:
        for name, (entries, *largest) in p.items():
            assert entries == cfg.embed_dim * cfg.embed_dim // cfg.n_heads, name
            assert largest == [0.0, 0.0, 0.0], name
        assert sorted(n.rsplit(".", 1)[-1] for n in p) == \
            sorted(["wq", "wk", "wv", "wo"] * cfg.n_blocks)
