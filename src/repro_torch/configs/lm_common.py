"""Shared cell builders for the LM-family architectures (the reference's
``configs/lm_common.py``).

Shapes: ``train_4k`` (train), ``prefill_32k`` (inference-prefill),
``decode_32k`` (inference-decode: 1 new token, 32k KV cache, batch 128),
``long_500k`` (long-context decode: 1 new token, 524,288-position cache,
batch 1).

``long_500k``: decode cost is linear in the cache length, so full attention
is exact and affordable. The cache's sequence dim is split over ``("data",
"model")``: each rank runs K9's partials over its 2,048 positions (at 16 ×
16) and the ranks merge them (``models.transformer.decode_step``), the
reference's flash-decoding over GSPMD's all-reduces. Nothing is
approximated and nothing is skipped.

A cell's ``args`` are meta tensors at the global shapes and
``in_shardings`` the reference's specs (``param_specs`` with FSDP for
training); ``layout`` is the port's own placement: the batch over the data
axes, the cache as the reference's, and the weights (and in ``train_4k``
the AdamW moments) by ``layout_specs``: the reference's ``param_specs``
with whole heads only, zero-padded to a split where ``model`` does not
divide them (``transformer.layout_replications``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import (
    ArchDef,
    CellBuild,
    ShapeCell,
    data_axes_of,
    meta,
    shardings_for,
)
from repro_torch.distributed.sharding import active_mesh
from repro_torch.launch.train import make_lm_train_step, params_of
from repro_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    cache_layout,
    cache_specs,
    count_active_params,
    count_params,
    decode_step,
    layout_specs,
    make_cache,
    param_specs,
    prefill,
)
from repro_torch.optim import adamw_init
from repro_torch.optim.optimizer import AdamWState


def _params(cfg) -> Transformer:
    return Transformer(cfg, "meta")


def _opt_specs(specs) -> AdamWState:
    return AdamWState(step=(), m=specs, v=specs)


def _lm_static_info(cfg, *, tokens: int, kind: str, cache_len: int = 0) -> dict:
    n_active = count_active_params(cfg)
    fwd = 2 * n_active * tokens
    return {
        "params_total": count_params(cfg),
        "params_active": n_active,
        "tokens": tokens,
        "model_flops": 3 * fwd if kind == "train" else fwd,
        "kind": kind,
    }


def build_train_cell(cfg: TransformerConfig, mesh, *, global_batch: int,
                     seq_len: int) -> CellBuild:
    cfg = dataclasses.replace(cfg, fsdp=True)
    model = _params(cfg)
    opt = adamw_init(params_of(model))
    batch = {"tokens": meta((global_batch, seq_len), torch.int32)}
    daxes = data_axes_of(mesh)
    p_sh = shardings_for(mesh, param_specs(cfg))
    o_sh = shardings_for(mesh, _opt_specs(param_specs(cfg)))
    batch_spec = {"tokens": (daxes, None)}
    return CellBuild(
        fn=make_lm_train_step(cfg),
        args=(model, opt, batch),
        in_shardings=(p_sh, o_sh, shardings_for(mesh, batch_spec)),
        out_shardings=(p_sh, o_sh, None),
        static_info=_lm_static_info(cfg, tokens=global_batch * seq_len, kind="train"),
        layout=(layout_specs(cfg, mesh), _opt_specs(layout_specs(cfg, mesh)), batch_spec),
    )


def _prefill_fn(cfg, params, tokens):
    return prefill(params, cfg, tokens)


def build_prefill_cell(cfg: TransformerConfig, mesh, *, global_batch: int,
                       seq_len: int) -> CellBuild:
    cfg = dataclasses.replace(cfg, fsdp=False, remat=False)
    spec = (data_axes_of(mesh), None)
    return CellBuild(
        fn=functools.partial(_prefill_fn, cfg),
        args=(_params(cfg), meta((global_batch, seq_len), torch.int32)),
        in_shardings=(shardings_for(mesh, param_specs(cfg)), shardings_for(mesh, spec)),
        out_shardings=None,
        static_info=_lm_static_info(cfg, tokens=global_batch * seq_len, kind="prefill"),
        layout=(layout_specs(cfg, mesh), spec),
    )


def _decode_fn(cfg, seq_axes, batch_axes, max_len, params, cache, tokens):
    """``decode_step`` on the rank's block of the cache: the block gets the
    layout of the active mesh's ``seq_axes``/``batch_axes`` split."""
    cache = dict(cache)
    cache["layout"] = cache_layout(active_mesh(), max_len, seq_axes=seq_axes,
                                   batch_axes=batch_axes)
    return decode_step(params, cfg, cache, tokens)


def build_decode_cell(cfg: TransformerConfig, mesh, *, global_batch: int, cache_len: int,
                      seq_axes=("model",), batch_axes=("pod", "data")) -> CellBuild:
    cfg = dataclasses.replace(cfg, fsdp=False, remat=False)
    cache = make_cache(cfg, global_batch, cache_len, device="meta")
    c_specs = cache_specs(cfg, seq_axes=seq_axes, batch_axes=batch_axes)
    c_sh = shardings_for(mesh, c_specs)
    tok_spec = (tuple(batch_axes) or None,)
    return CellBuild(
        fn=functools.partial(_decode_fn, cfg, tuple(seq_axes), tuple(batch_axes), cache_len),
        args=(_params(cfg), cache, meta((global_batch,), torch.int32)),
        in_shardings=(shardings_for(mesh, param_specs(cfg)), c_sh,
                      shardings_for(mesh, tok_spec)),
        out_shardings=(None, c_sh),
        static_info=_lm_static_info(cfg, tokens=global_batch, kind="decode",
                                    cache_len=cache_len),
        layout=(layout_specs(cfg, mesh), c_specs, tok_spec),
    )


def lm_shapes(train_batch=256, train_seq=4096) -> dict:
    return {
        "train_4k": ShapeCell(
            kind="train",
            desc=f"seq_len=4096 global_batch={train_batch} (training)",
            build=lambda cfg, mesh: build_train_cell(
                cfg, mesh, global_batch=train_batch, seq_len=train_seq),
        ),
        "prefill_32k": ShapeCell(
            kind="prefill",
            desc="seq_len=32768 global_batch=32 (inference-prefill)",
            build=lambda cfg, mesh: build_prefill_cell(
                cfg, mesh, global_batch=32, seq_len=32768),
        ),
        "decode_32k": ShapeCell(
            kind="decode",
            desc="KV cache 32768, global_batch=128 (inference-decode)",
            build=lambda cfg, mesh: build_decode_cell(
                cfg, mesh, global_batch=128, cache_len=32768,
                seq_axes=("model",), batch_axes=("pod", "data")),
        ),
        "long_500k": ShapeCell(
            kind="decode",
            desc="KV cache 524288, global_batch=1 (long-context decode, "
                 "sequence-parallel full attention)",
            build=lambda cfg, mesh: build_decode_cell(
                cfg, mesh, global_batch=1, cache_len=524288,
                seq_axes=("data", "model"), batch_axes=()),
        ),
    }


def lm_arch(name: str, source: str, make_config, make_smoke_config) -> ArchDef:
    return ArchDef(name=name, family="lm", source=source, make_config=make_config,
                   make_smoke_config=make_smoke_config, shapes=lm_shapes())
