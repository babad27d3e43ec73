"""Moving state between numpy (and so the JAX package) and the port.

The APSS self-join has no weights; the corpus (dense, or a padded-CSR
``SparseCorpus``), the block statistics of an index and the ``Matches`` a
join returns are its state. These functions carry each across in either
direction with the port's dtypes: float32 scores, int32 ids and counts.
The LM's parameters cross as the reference's nested dict of numpy arrays
(:func:`transformer_params_from_numpy`, :func:`transformer_params_to_numpy`).
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

_ATTN = ("wq", "wk", "wv", "wo")
_FFN = ("w_gate", "w_up", "w_down")


def transformer_params_from_numpy(tree: dict, cfg, device: str | torch.device):
    """The port's ``Transformer`` holding the parameters of a reference
    parameter tree (``jax.tree.map(np.asarray, params)``): ``embed (V, d)``,
    ``layers`` stacked over the layer axis with ``(d_in, d_out)`` matrices,
    ``final_norm``, ``lm_head (d, V)``. Matrices are transposed into
    ``nn.Linear`` weights ``(d_out, d_in)``; values are cast to ``cfg.dtype``
    (a bf16 tree widens to f32 on the way, exactly)."""
    from repro_torch.models.transformer import Transformer  # models import this module

    dev = device_of(device)
    model = Transformer(cfg, dev)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dev, cfg.dtype)

    layers = tree["layers"]
    with torch.no_grad():
        model.embed.copy_(t(tree["embed"]))
        model.final_norm.copy_(t(tree["final_norm"]))
        model.lm_head.weight.copy_(t(tree["lm_head"]).T)
        for i, blk in enumerate(model.layers):
            blk.attn_norm.copy_(t(layers["attn_norm"][i]))
            blk.ffn_norm.copy_(t(layers["ffn_norm"][i]))
            for name in _ATTN:
                getattr(blk.attn, name).weight.copy_(t(layers["attn"][name][i]).T)
            for name in _FFN:
                getattr(blk.ffn, name).weight.copy_(t(layers["ffn"][name][i]).T)
            if cfg.qk_norm:
                blk.attn.q_scale.copy_(t(layers["attn"]["q_scale"][i]))
                blk.attn.k_scale.copy_(t(layers["attn"]["k_scale"][i]))
    return model


def transformer_params_to_numpy(model) -> dict:
    """The reference's parameter tree (float32 numpy) of a port ``Transformer``:
    the inverse of :func:`transformer_params_from_numpy`."""
    def h(a: torch.Tensor) -> np.ndarray:
        return a.detach().float().cpu().numpy()

    def stack(get) -> np.ndarray:
        return np.stack([h(get(blk)) for blk in model.layers])

    attn = {n: stack(lambda b, n=n: getattr(b.attn, n).weight.T) for n in _ATTN}
    if model.cfg.qk_norm:
        attn["q_scale"] = stack(lambda b: b.attn.q_scale)
        attn["k_scale"] = stack(lambda b: b.attn.k_scale)
    return {
        "embed": h(model.embed),
        "layers": {
            "attn_norm": stack(lambda b: b.attn_norm),
            "attn": attn,
            "ffn_norm": stack(lambda b: b.ffn_norm),
            "ffn": {n: stack(lambda b, n=n: getattr(b.ffn, n).weight.T) for n in _FFN},
        },
        "final_norm": h(model.final_norm),
        "lm_head": h(model.lm_head.weight.T),
    }
