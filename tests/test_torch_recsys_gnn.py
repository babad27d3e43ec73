"""The port's recsys and GNN families (``models/recsys.py``,
``models/gnn.py``, their configs) against the reference's on the CPU.

One parameter tree of the reference's structure (``eval_shape`` of its
init, filled from numpy) runs in both packages, carried across by
``interop``, on batches from the pipelines. For each smoke config: the
forward scores, the loss within relative 1e-5, every gradient leaf within
1e-5 × its largest |g|, and one ``make_*_train_step`` (metrics, and the
parameters after the step within 1e-5); GAT on a full graph and on a
sampled minibatch. ``retrieval_scores`` and bert4rec's ``_retrieve`` under
the parity rule (``tests/_torch_parity.py``: counts exact, sets equal,
values to f32 rounding, order by value then lower id), DIN's and BST's
``_retrieve`` top 256, and the EmbeddingBag and segment-softmax layers.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_clear_of_threshold, assert_same_matches  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data import sampler as jsampler  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import GraphPipeline, RecsysPipeline, neighbor_sample  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.models.layers import segment_sum  # noqa: E402

REL = 1e-5
HP = train.TrainHyperparams(warmup_steps=2, total_steps=10)

# arch -> (reference init, reference loss, port loss, reference score, port score, pipeline)
FAMILY = {
    "two-tower-retrieval": (jrec.init_two_tower, jrec.two_tower_loss, recsys.two_tower_loss,
                            jrec.two_tower_score, recsys.two_tower_score, "two-tower"),
    "bert4rec": (jrec.init_bert4rec, jrec.bert4rec_loss, recsys.bert4rec_loss,
                 jrec.bert4rec_score, recsys.bert4rec_score, "seq"),
    "din": (jrec.init_din, jrec.din_loss, recsys.din_loss, jrec.din_logits,
            recsys.din_logits, "ctr"),
    "bst": (jrec.init_bst, jrec.bst_loss, recsys.bst_loss, jrec.bst_logits,
            recsys.bst_logits, "ctr"),
}


def _fill(init, jcfg, seed=0):
    """A reference parameter tree filled from numpy: every leaf 0.1 ×
    normal, the norm scales 1 + 0.1 × normal. (Biases near 1 would make
    every tower output alike and the two-tower's bias gradients a
    difference of large terms: there the reference's own f32 gradients sit
    1.8e-4 × max|g| from float64, past any f32 tolerance.)"""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.key(0))

    def fill(path, s):
        a = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return a + 1 if "norm" in jax.tree_util.keystr(path) else a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pipe(cfg, kind, batch_size=8, seed=0):
    if kind == "two-tower":
        return RecsysPipeline(n_items=cfg.n_items, batch_size=batch_size,
                              history_len=cfg.history_len, n_user_fields=cfg.n_user_fields,
                              user_vocab=cfg.user_vocab, kind=kind, seed=seed)
    hist = cfg.seq_len - 1 if isinstance(cfg, recsys.BSTConfig) else cfg.seq_len
    return RecsysPipeline(n_items=cfg.n_items, batch_size=batch_size, history_len=hist,
                          kind=kind, seed=seed)


def _reference_step(loss_fn):
    def step(p, o, b):
        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        lr = jopt.cosine_schedule(o.step, HP.lr, HP.warmup_steps, HP.total_steps)
        new_p, _, om = jopt.adamw_update(g, o, p, lr=lr, b1=HP.b1, b2=HP.b2,
                                         weight_decay=HP.weight_decay, clip_norm=HP.clip_norm)
        return g, new_p, {"loss": loss, **aux, **om}
    return jax.jit(step)


def _check_step(loss_fn, jtree, model, batch, port_loss, port_step):
    """Reference gradients, metrics and updated params against the port's."""
    params = jax.tree.map(jnp.asarray, jtree)
    wg, wp, wm = _reference_step(loss_fn)(params, jopt.adamw_init(params),
                                           jax.tree.map(jnp.asarray, batch))
    _, _, grads = train.grads_of(port_loss, model, batch)
    got = interop.named_to_numpy(model, grads, interop.recsys_params_to_numpy)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(wg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * max(float(np.abs(b).max()), 1e-30))
    opt = optim.adamw_init(train.params_of(model))
    _, new_opt, metrics = port_step(model, opt, batch)
    assert int(new_opt.step) == 1 and set(metrics) == set(wm)
    for key in wm:
        np.testing.assert_allclose(float(metrics[key]), float(wm[key]), rtol=REL, atol=1e-7,
                                   err_msg=key)
    for a, b in zip(jax.tree.leaves(interop.recsys_params_to_numpy(model)),
                    jax.tree.leaves(wp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", list(FAMILY))
def test_recsys_scores_loss_grads_and_step_match_the_reference(arch):
    jinit, jloss, tloss, jscore, tscore, kind = FAMILY[arch]
    jcfg, cfg = jget_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()
    jtree = _fill(jinit, jcfg)
    model = interop.recsys_params_from_numpy(jtree, cfg, "cpu")
    batch = _pipe(cfg, kind).get_batch(3)
    if "history" in batch:
        batch["history"][::2, -3:] = -1  # padded history slots
    params, jb = jax.tree.map(jnp.asarray, jtree), jax.tree.map(jnp.asarray, batch)
    with torch.no_grad():
        got = tscore(model, cfg, batch).numpy()
    np.testing.assert_allclose(got, np.asarray(jscore(params, jcfg, jb)), rtol=REL, atol=1e-6)
    _check_step(lambda p, b: jloss(p, jcfg, b), jtree, model, batch,
                lambda m, b: tloss(m, cfg, b), train.make_recsys_train_step(cfg, HP))


def test_two_tower_logq_correction_matches_the_reference():
    jcfg, cfg = jget_arch("two-tower-retrieval").make_smoke_config(), \
        get_arch("two-tower-retrieval").make_smoke_config()
    jtree = _fill(jrec.init_two_tower, jcfg, seed=1)
    model = interop.recsys_params_from_numpy(jtree, cfg, "cpu")
    batch = _pipe(cfg, "two-tower").get_batch(0)
    batch["sampling_logq"] = np.log(np.random.default_rng(0).uniform(0.01, 1, 8)).astype(
        np.float32)
    want, waux = jrec.two_tower_loss(jax.tree.map(jnp.asarray, jtree), jcfg,
                                     jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, aux = recsys.two_tower_loss(model, cfg, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=REL)
    assert float(aux["in_batch_acc"]) == float(waux["in_batch_acc"])


# -- GAT ------------------------------------------------------------------------------


def _gat(seed=0):
    jcfg, cfg = jget_arch("gat-cora").make_smoke_config(), get_arch("gat-cora").make_smoke_config()
    jtree = _fill(jgnn.init_gat, jcfg, seed)
    return jcfg, cfg, jtree, interop.gat_params_from_numpy(jtree, cfg, "cpu")


def _gat_check(jcfg, cfg, jtree, model, batch):
    params, jb = jax.tree.map(jnp.asarray, jtree), jax.tree.map(jnp.asarray, batch)
    with torch.no_grad():
        got = gnn.gat_forward(model, cfg, batch).numpy()
    np.testing.assert_allclose(got, np.asarray(jgnn.gat_forward(params, jcfg, jb)), rtol=REL,
                               atol=1e-5)
    _check_step(lambda p, b: jgnn.gat_loss(p, jcfg, b), jtree, model, batch,
                lambda m, b: gnn.gat_loss(m, cfg, b), train.make_gat_train_step(cfg, HP))


def test_gat_full_graph_matches_the_reference():
    jcfg, cfg, jtree, model = _gat()
    batch = GraphPipeline(256, 2048, cfg.d_feat, n_classes=cfg.n_classes).full_graph()
    batch["edge_mask"][::7] = 0  # masked edges, and nodes with no live in-edge
    _gat_check(jcfg, cfg, jtree, model, batch)


def test_gat_sampled_minibatch_matches_the_reference():
    jcfg, cfg, jtree, model = _gat(1)
    pipe = GraphPipeline(500, 5000, cfg.d_feat, n_classes=cfg.n_classes)
    indptr, idx = pipe.csr()
    g = pipe.full_graph()
    batch = neighbor_sample(indptr, idx, np.arange(16), (5, 3), g["features"], g["labels"])
    batch.pop("node_ids")
    assert (batch["edge_mask"] == 0).any()  # zero-degree seeds: masked self-fallbacks
    _gat_check(jcfg, cfg, jtree, model, batch)
    n, e = jsampler.sampled_shape(16, (5, 3))
    assert batch["features"].shape[0] == n and batch["edge_src"].shape[0] == e


def test_segment_softmax_matches_the_reference():
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((300, 4)).astype(np.float32)
    seg = rng.integers(0, 50, 300).astype(np.int32)
    seg[seg == 3] = 4  # an empty segment
    mask = (rng.random(300) > 0.2).astype(np.float32)
    want = jgnn.segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 50, jnp.asarray(mask))
    got = gnn.segment_softmax(torch.from_numpy(scores), torch.from_numpy(seg), 50,
                              torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# -- EmbeddingBag ----------------------------------------------------------------------


def test_embedding_bags_match_the_reference():
    rng = np.random.default_rng(6)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    ids = rng.integers(-1, 40, (5, 9)).astype(np.int32)
    w = rng.random((5, 9)).astype(np.float32)
    for mode in ("sum", "mean"):
        for weights in (None, w):
            want = jrec.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                      None if weights is None else jnp.asarray(weights),
                                      mode=mode)
            got = recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                                       None if weights is None else torch.from_numpy(weights),
                                       mode=mode)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    flat = rng.integers(0, 40, 30).astype(np.int32)
    seg = np.sort(rng.integers(0, 8, 30)).astype(np.int32)
    fw = rng.random(30).astype(np.float32)
    want = jrec.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg),
                                     10, jnp.asarray(fw))
    got = recsys.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat),
                                      torch.from_numpy(seg), 10, torch.from_numpy(fw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the fixed order is the reference's: unsorted segments sum in row order
    data = rng.standard_normal((30, 3)).astype(np.float32)
    useg = rng.integers(0, 8, 30).astype(np.int32)
    np.testing.assert_array_equal(
        segment_sum(torch.from_numpy(data), torch.from_numpy(useg), 8).numpy(),
        np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(useg), 8)))


# -- retrieval ------------------------------------------------------------------------


def test_retrieval_scores_match_the_reference():
    jcfg, cfg = jget_arch("two-tower-retrieval").make_smoke_config(), \
        get_arch("two-tower-retrieval").make_smoke_config()
    jtree = _fill(jrec.init_two_tower, jcfg, seed=2)
    model = interop.recsys_params_from_numpy(jtree, cfg, "cpu")
    batch = _pipe(cfg, "two-tower", batch_size=2).get_batch(5)
    params, jb = jax.tree.map(jnp.asarray, jtree), jax.tree.map(jnp.asarray, batch)
    cand = np.arange(cfg.n_items, dtype=np.int32)
    u = np.asarray(jrec.user_embedding(params, jcfg, jb))
    c = np.asarray(jrec.item_embedding(params, jcfg, jnp.asarray(cand)))
    assert_clear_of_threshold(u, c, 0.0)
    want = jrec.retrieval_scores(params, jcfg, jb, jnp.asarray(cand), k=16)
    got = recsys.retrieval_scores(model, cfg, batch, cand, k=16)
    assert_same_matches(got, want)


def test_config_retrieve_functions_match_the_reference():
    for arch in ("bert4rec", "din", "bst"):
        jinit, *_, kind = FAMILY[arch]
        jcfg, cfg = jget_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()
        jtree = _fill(jinit, jcfg, seed=3)
        model = interop.recsys_params_from_numpy(jtree, cfg, "cpu")
        batch = {k: v[:1] for k, v in _pipe(cfg, kind).get_batch(1).items()}
        params, jb = jax.tree.map(jnp.asarray, jtree), jax.tree.map(jnp.asarray, batch)
        cand = np.arange(cfg.n_items, dtype=np.int32)
        jmod = importlib.import_module(f"repro.configs.{arch}")
        tmod = importlib.import_module(f"repro_torch.configs.{arch}")
        want = jmod._retrieve(jcfg, params, jb, jnp.asarray(cand))
        got = tmod._retrieve(cfg, model, batch, cand)
        if arch == "bert4rec":
            with torch.no_grad():
                h = recsys.bert4rec_encode(model, cfg, batch["item_ids"])[:, -1].numpy()
            assert_clear_of_threshold(h, np.asarray(jtree["item_table"])[:cfg.n_items], 0.0)
            assert_same_matches(got, want)
        else:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=REL,
                                       atol=1e-6)
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
