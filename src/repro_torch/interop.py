"""Moving state between numpy (and so the JAX package) and the port.

The APSS self-join has no weights; the corpus (dense, or a padded-CSR
``SparseCorpus``), the block statistics of an index and the ``Matches`` a
join returns are its state. These functions carry each across in either
direction with the port's dtypes: float32 scores, int32 ids and counts.
The LM's parameters cross as the reference's nested dict of numpy arrays
(:func:`transformer_params_from_numpy`, :func:`transformer_params_to_numpy`),
as do the recsys and GNN models' (:func:`recsys_params_from_numpy`,
:func:`gat_params_from_numpy` and their inverses) and the AdamW state
(:func:`adamw_state_from_numpy`, :func:`adamw_state_to_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.matches import Matches
from repro_torch.core.pruning import BlockStats


def device_of(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def as_corpus(D, device: str | torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on ``device``.

    A bf16 corpus stays bf16 (the kernels read it and sum in f32); every
    other dtype becomes float32.
    """
    dev = device_of(device)
    t = torch.as_tensor(D)
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t.to(dev).contiguous()


def corpus_from_numpy(D: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """An ``(n, m)`` numpy corpus as a float32 tensor on ``device``."""
    return as_corpus(np.array(D, np.float32), device)


def sparse_corpus_from_numpy(
    indices: np.ndarray, values: np.ndarray, nnz: np.ndarray, m: int,
    device: str | torch.device,
):
    """A padded-CSR ``SparseCorpus`` (int32 ids, f32 values, int32 nnz) from
    the numpy arrays of one, e.g. ``np.asarray`` of a JAX corpus's fields."""
    from repro_torch.core.sparse import SparseCorpus  # core.sparse imports this module

    dev = device_of(device)
    return SparseCorpus(
        indices=torch.tensor(np.asarray(indices, np.int32), device=dev),
        values=torch.tensor(np.asarray(values, np.float32), device=dev),
        nnz=torch.tensor(np.asarray(nnz, np.int32), device=dev),
        m=int(m),
    )


def sparse_corpus_to_numpy(sp) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """``(indices, values, nnz, m)`` of a ``SparseCorpus`` from either package."""
    return (
        _host(sp.indices).astype(np.int32),
        _host(sp.values).astype(np.float32),
        _host(sp.nnz).astype(np.int32),
        int(sp.m),
    )


def block_stats_from_numpy(
    maxw: np.ndarray, mw: np.ndarray, max_nnz: np.ndarray,
    device: str | torch.device,
) -> BlockStats:
    """Index block statistics (``BlockStats`` fields) from numpy arrays."""
    dev = device_of(device)
    return BlockStats(
        maxw=torch.tensor(np.asarray(maxw), device=dev),
        mw=torch.tensor(np.asarray(mw), device=dev),
        max_nnz=torch.tensor(np.asarray(max_nnz, np.int32), device=dev),
    )


def matches_from_numpy(
    values: np.ndarray, indices: np.ndarray, counts: np.ndarray,
    device: str | torch.device,
) -> Matches:
    """``Matches`` from numpy arrays (f32 values, i32 ids and counts)."""
    dev = device_of(device)
    return Matches(
        values=torch.tensor(np.asarray(values, np.float32), device=dev),
        indices=torch.tensor(np.asarray(indices, np.int32), device=dev),
        counts=torch.tensor(np.asarray(counts, np.int32), device=dev),
    )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def matches_to_numpy(m) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(values, indices, counts)`` as numpy arrays, from either package."""
    return (
        _host(m.values).astype(np.float32),
        _host(m.indices).astype(np.int32),
        _host(m.counts).astype(np.int32),
    )


def index_from_numpy(
    corpus,
    maxw: np.ndarray,
    mw: np.ndarray,
    max_nnz: np.ndarray,
    *,
    bdims: np.ndarray | None = None,
    bx: np.ndarray | None = None,
    n: int,
    m: int,
    block_rows: int,
    kind: str,
    normalized: bool,
    device: str | torch.device,
):
    """A serving ``APSSIndex`` from the numpy arrays of one, e.g. the leaves of
    a JAX index (``np.asarray`` of each): ``corpus`` is the padded dense
    array or the ``(indices, values, nnz)`` CSR triple, ``maxw``/``mw``/
    ``max_nnz`` its block stats and ``bdims``/``bx`` its sparse support
    compaction."""
    from repro_torch.serving.index import APSSIndex  # serving imports this module

    dev = device_of(device)
    if kind == "sparse":
        sp = sparse_corpus_from_numpy(*corpus, m, dev)
        corpus = (sp.indices, sp.values, sp.nnz)
        bdims = torch.tensor(np.asarray(bdims, np.int32), device=dev)
        bx = torch.tensor(np.asarray(bx, np.float32), device=dev)
    else:
        corpus = as_corpus(np.asarray(corpus), dev)
    return APSSIndex(
        corpus, block_stats_from_numpy(maxw, mw, max_nnz, dev), bdims, bx,
        n=n, m=m, block_rows=block_rows, kind=kind, normalized=normalized,
    )


# -- LM parameters ---------------------------------------------------------------

_NORMS = {"gqa": ("q_scale", "k_scale"), "mla": ("q_norm", "kv_norm")}
_MATS = {"gqa": ("wq", "wk", "wv", "wo"),
         "mla": ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")}
_FFN = ("w_gate", "w_up", "w_down")
_EXPERTS = ("router", "w_gate", "w_up", "w_down")


def _field(tree, name: str):
    """``tree[name]`` of a dict, or the attribute of the reference's
    ``MoEParams`` named tuple."""
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _block_leaves(blk, cfg):
    """``(path, tensor, transposed)`` for every parameter of one block, in
    the reference tree's names: ``nn.Linear`` weights are transposed, norm
    scales and expert stacks are not."""
    attn = blk.attn
    out = [(("attn_norm",), blk.attn_norm, False), (("ffn_norm",), blk.ffn_norm, False)]
    out += [(("attn", n), getattr(attn, n).weight, True) for n in _MATS[cfg.attention]]
    out += [(("attn", n), getattr(attn, n), False) for n in _NORMS[cfg.attention]
            if hasattr(attn, n)]
    ffn = blk.ffn
    if hasattr(ffn, "moe"):
        out += [(("ffn", "moe", n), getattr(ffn.moe, n), False) for n in _EXPERTS]
        for part in ("shared", "dense"):
            sub = getattr(ffn, part)
            if sub is not None:
                out += [(("ffn", part, n), getattr(sub, n).weight, True) for n in _FFN]
    else:
        out += [(("ffn", n), getattr(ffn, n).weight, True) for n in _FFN]
    return out


def transformer_params_from_numpy(tree: dict, cfg, device: str | torch.device, mesh=None):
    """The port's ``Transformer`` holding the parameters of a reference
    parameter tree (``jax.tree.map(np.asarray, params)``): ``embed (V, d)``,
    ``layers`` stacked over the layer axis with ``(d_in, d_out)`` matrices
    (MLA's ``wq_a`` … ``wkv_b``, the MoE ``moe``/``shared``/``dense``
    subtrees), ``dense_layers`` (a list of unstacked blocks), ``final_norm``,
    ``lm_head (d, V)``. Matrices are transposed into ``nn.Linear`` weights
    ``(d_out, d_in)``; the expert stacks keep their orientation; values are
    cast to ``cfg.dtype`` (the router stays f32; a bf16 tree widens to f32
    on the way, exactly). With a ``mesh`` (every rank calls this) it is the
    rank's ``Transformer(cfg, device, mesh)``: the whole model is built on
    the host and cut to the rank's blocks (``transformer.shard_transformer``,
    ``distributed.sharding.cut_tree``)."""
    from repro_torch.models.transformer import (  # models import this module
        Transformer,
        shard_transformer,
    )

    if mesh is not None:
        whole = transformer_params_from_numpy(tree, cfg, "cpu")
        return shard_transformer(whole, mesh, device=device)
    dev = device_of(device)
    model = Transformer(cfg, dev)

    def load(blk, sub, i):
        for path, param, transposed in _block_leaves(blk, cfg):
            a = sub
            for name in path:
                a = _field(a, name)
            a = torch.from_numpy(np.array(a if i is None else a[i], np.float32)).to(dev)
            param.copy_((a.T if transposed else a).to(param.dtype))

    with torch.no_grad():
        model.embed.copy_(torch.from_numpy(np.array(tree["embed"], np.float32)).to(dev))
        model.final_norm.copy_(torch.from_numpy(np.array(tree["final_norm"], np.float32)))
        model.lm_head.weight.copy_(torch.from_numpy(np.array(tree["lm_head"], np.float32)).T)
        for i, blk in enumerate(model.layers):
            load(blk, tree["layers"], i)
        for blk, sub in zip(model.dense_layers, tree.get("dense_layers", [])):
            load(blk, sub, None)
    return model


def transformer_params_to_numpy(model) -> dict:
    """The reference's parameter tree (float32 numpy) of a port ``Transformer``:
    the inverse of :func:`transformer_params_from_numpy`. An MoE layer's
    ``moe`` entry is a named tuple with the reference's ``MoEParams`` fields,
    so the tree runs in the reference's functions as it is. A rank's
    ``Transformer(mesh=)`` is gathered whole first (every rank calls this)."""
    from collections import namedtuple

    from repro_torch.models.transformer import unshard_transformer

    model = unshard_transformer(model)
    cfg = model.cfg
    moe_params = namedtuple("MoEParams", _EXPERTS)

    def h(a: torch.Tensor) -> np.ndarray:
        return a.detach().float().cpu().numpy()

    def tree_of(leaves: list) -> dict:
        out: dict = {}
        for path, value in leaves:
            node = out
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = value
        if "moe" in out.get("ffn", {}):
            out["ffn"]["moe"] = moe_params(**out["ffn"]["moe"])
        return out

    def leaves(blk):
        return [(path, h(p.T if transposed else p))
                for path, p, transposed in _block_leaves(blk, cfg)]

    per_block = [leaves(blk) for blk in model.layers]
    stacked = [(path, np.stack([blk[j][1] for blk in per_block]))
               for j, (path, _) in enumerate(per_block[0])]
    out = {
        "embed": h(model.embed),
        "layers": tree_of(stacked),
        "final_norm": h(model.final_norm),
        "lm_head": h(model.lm_head.weight.T),
    }
    if len(model.dense_layers):
        out["dense_layers"] = [tree_of(leaves(blk)) for blk in model.dense_layers]
    return out


# -- recsys and GNN parameters, optimizer state --------------------------------------


def _param_tree_from_numpy(tree: dict, dtype, device):
    from repro_torch.models.layers import ParamTree  # models import this module

    dev = device_of(device)

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(v) for key, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, np.float32)).to(device=dev, dtype=dtype)

    return ParamTree(conv(tree))


def _param_tree_cut(tree: dict, cfg, device, mesh, layout_specs, init):
    """A ``ParamTree`` of ``tree``'s leaves (numpy) on ``device``, its
    family's ``init`` attached (``ParamTree.rebuild``): with a ``mesh``,
    this rank's blocks of ``layout_specs(cfg, mesh)``
    (``layers.cut_param_tree``)."""
    import functools

    from repro_torch.models.layers import cut_param_tree

    model = _param_tree_from_numpy(tree, cfg.dtype, device)
    model.cfg, model.build = cfg, functools.partial(init, cfg)
    return model if mesh is None else cut_param_tree(model, layout_specs(cfg, mesh), mesh)


def _param_tree_to_numpy(model) -> dict:
    from repro_torch.models.layers import gather_param_tree

    model = gather_param_tree(model)

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(v) for key, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return node.detach().float().cpu().numpy()

    return conv(model.tree())


def recsys_params_from_numpy(tree: dict, cfg, device: str | torch.device, mesh=None):
    """A recsys model's ``ParamTree`` (two-tower, BERT4Rec, DIN or BST) from
    the reference's parameter tree of numpy arrays (``jax.tree.map(np.asarray,
    params)``), leaf for leaf in the reference's orientation, cast to
    ``cfg.dtype``. With a ``mesh`` (every rank calls this) it is the rank's
    blocks of ``recsys.layout_specs``."""
    from repro_torch.models import recsys

    init = recsys._FAMILY[type(cfg)][0]
    return _param_tree_cut(tree, cfg, device, mesh, recsys.layout_specs, init)


def recsys_params_to_numpy(model) -> dict:
    """The reference's parameter tree (float32 numpy) of a recsys model; a
    rank's blocks are gathered first (every rank of the mesh calls this)."""
    return _param_tree_to_numpy(model)


def gat_params_from_numpy(tree: dict, cfg, device: str | torch.device, mesh=None):
    """A GAT's ``ParamTree`` from the reference's ``{"layers": [{"w", "a_src",
    "a_dst"}, ...]}`` of numpy arrays, cast to ``cfg.dtype``. The weights
    replicate on a ``mesh`` (``gat_param_specs``): every rank holds them
    whole."""
    from repro_torch.models import gnn
    from repro_torch.models.layers import layout_of

    def layout(c, m):
        return layout_of(gnn.gat_param_specs(c), gnn.init_gat(c, device="meta"), m)

    return _param_tree_cut(tree, cfg, device, mesh, layout, gnn.init_gat)


def gat_params_to_numpy(model) -> dict:
    """The reference's parameter tree (float32 numpy) of a GAT."""
    return _param_tree_to_numpy(model)


def adamw_state_from_numpy(state, from_numpy):
    """The port's ``AdamWState`` from the reference's (``step``, ``m``, ``v``
    as numpy arrays): ``from_numpy(tree)`` builds a model of the family from
    a parameter tree at f32 (for an LM, :func:`transformer_params_from_numpy`
    with a float32 config; with its ``mesh=``, a rank's blocks of the
    moments), and the moments become ``{name: tensor}`` trees keyed as the
    trainer keys the parameters (``named_parameters``)."""
    from repro_torch.optim import AdamWState

    def moments(tree):
        model = from_numpy(tree)
        return {name: p.detach().clone() for name, p in model.named_parameters()}

    m = moments(state.m)
    dev = next(iter(m.values())).device
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=dev)
    return AdamWState(step=step, m=m, v=moments(state.v))


def named_to_numpy(model, named: dict, to_numpy) -> dict:
    """The reference's tree of a ``{name: tensor}`` tree keyed as ``model``'s
    parameters (gradients, moments): the tensors are put in place of the
    parameters of an f32 copy of ``model``, which ``to_numpy`` (e.g.
    :func:`gat_params_to_numpy`, :func:`transformer_params_to_numpy`) reads
    back as the reference's tree."""
    import copy

    from repro_torch.models.layers import ParamTree, _map_named

    if isinstance(model, ParamTree):  # a rank's blocks keep their tags
        params = dict(model.named_parameters())
        skeleton = ParamTree(_map_named(lambda name, p: named[name].detach().float(),
                                        model.tree()), requires_grad=False)
        for name, p in skeleton.named_parameters():
            if hasattr(params[name], "spec"):
                p.spec, p.mesh = params[name].spec, params[name].mesh
        skeleton.mesh = model.mesh
        return to_numpy(skeleton)
    skeleton = copy.deepcopy(model).float()
    for name, p in skeleton.named_parameters():
        p.data = named[name].detach().float()
    return to_numpy(skeleton)


def adamw_state_to_numpy(state, model, to_numpy):
    """The reference's ``AdamWState`` (numpy leaves) of the port's, each
    moment tree by :func:`named_to_numpy`."""
    from repro_torch.optim import AdamWState

    return AdamWState(step=np.asarray(int(state.step), np.int32),
                      m=named_to_numpy(model, state.m, to_numpy),
                      v=named_to_numpy(model, state.v, to_numpy))
