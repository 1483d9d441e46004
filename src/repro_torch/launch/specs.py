"""Dry-run cells (the counterpart of ``repro.launch.specs``): (arch x
shape x mesh) -> a step, its abstract inputs and their shardings.

The inputs are ``meta`` DTensors placed by ``dist.abstract_put``: each
rank's block of every parameter, optimizer moment, batch leaf and cache has
its shape and dtype and no storage, so nothing is allocated.

Conventions:
  train   -> the full train step (params fp32, opt_state, batch) incl. AdamW,
             written into its buffers (the JAX cell donates them)
  prefill -> prefill(params, tokens) returning (logits, caches)
  decode  -> decode_step(params, token, caches, t) with a max_len=seq KV
             cache; batch=1 cells shard the KV sequence dim (SP).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from ..configs import SHAPES, ArchSpec, build_model
from ..dist.sharding import (
    NamedSharding,
    P,
    abstract_put,
    batch_sharding,
    cache_shardings,
    default_rules,
    mesh_ops,
    on_mesh,
    tree_shardings_shaped,
)
from ..train.optimizer import AdamW, warmup_cosine
from ..train.steps import make_lm_train_step

N_IMG_PATCHES = 1024  # VLM stub: patches per sequence


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    donate_argnums: tuple
    model_flops: float
    n_chips: int
    flops_scale: float = 1.0  # the JAX cell's: cost_analysis counts scan bodies once


def model_flops_estimate(spec: ArchSpec, shape_name: str, shapes: dict | None = None) -> float:
    cfg = spec.config
    sh = (SHAPES if shapes is None else shapes)[shape_name]
    n_active = cfg.n_active_params()
    if sh["kind"] == "train":
        tokens = sh["seq_len"] * sh["global_batch"]
        return 6.0 * n_active * tokens
    if sh["kind"] == "prefill":
        tokens = sh["seq_len"] * sh["global_batch"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * sh["global_batch"]


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _serving(fn):
    """A prefill or decode step over DTensors: no autograd, the models' ops
    under ``dist.mesh_ops``."""

    @functools.wraps(fn)
    def run(*args):
        with torch.no_grad(), mesh_ops():
            return fn(*args)

    return run


def build_cell(
    spec: ArchSpec,
    shape_name: str,
    mesh,
    fsdp: bool | None = None,  # None -> the arch's TRAIN_FSDP default
    n_micro: int | None = None,
    bf16_params: bool = False,  # bf16 params + fp32 master in opt state
    shapes: dict | None = None,  # shape_name's table; configs.SHAPES by default
) -> Cell:
    cfg = spec.config
    sh = (SHAPES if shapes is None else shapes)[shape_name]
    kind = sh["kind"]
    B, S = sh["global_batch"], sh["seq_len"]
    # FSDP weight sharding only where optimizer state exists: serve cells
    # place their weights by the rules without model sharding
    if fsdp is None:
        fsdp = spec.train_fsdp
    rules = default_rules(fsdp and kind == "train", mesh.mesh_dim_names)
    if n_micro is None:
        n_micro = spec.train_micro
    if kind == "train" and hasattr(cfg, "act_spec"):
        cfg = dataclasses.replace(cfg, act_spec=tuple(rules["batch"]))
    # per-microbatch size must stay divisible by the DP extent
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp = 1
    for ax in rules["batch"] or ():
        dp *= sizes[ax]
    while n_micro > 1 and (B // n_micro) % dp:
        n_micro //= 2
    model = build_model(cfg)
    n_chips = mesh.size()

    train_dtype = torch.bfloat16 if bf16_params else torch.float32
    abstract_params = model.abstract(train_dtype if kind == "train" else torch.bfloat16)
    param_sh = tree_shardings_shaped(mesh, model.axes(), abstract_params, rules)
    params = abstract_put(abstract_params, param_sh)
    rep = NamedSharding(mesh, P())
    bsh = batch_sharding(mesh, B, rules)
    seq_sharded = B == 1

    mf = model_flops_estimate(spec, shape_name, shapes)

    if kind == "train":
        opt = AdamW(lr=warmup_cosine(3e-4, 100, 10000), weight_decay=0.01, master_weights=bf16_params)
        step = make_lm_train_step(model, opt, n_micro=n_micro, donate=True)
        opt_state = opt.abstract_state(abstract_params)
        opt_sh = {"m": param_sh, "v": param_sh, "step": rep}
        if bf16_params:
            opt_sh["master"] = param_sh
        batch, batch_sh = _train_batch(spec, B, S, bsh, rep)
        return Cell(
            arch=spec.name,
            shape=shape_name,
            kind=kind,
            fn=on_mesh(step),
            args=(params, abstract_put(opt_state, opt_sh), abstract_put(batch, batch_sh)),
            in_shardings=(param_sh, opt_sh, batch_sh),
            donate_argnums=(0, 1),
            model_flops=mf,
            n_chips=n_chips,
            flops_scale=float(n_micro),
        )

    if kind == "prefill":
        if spec.family == "whisper":
            fn = lambda p, frames, tokens: model.prefill(p, frames, tokens)  # noqa: E731
            args = (
                params,
                abstract_put(_sds((B, cfg.n_frames, cfg.d_model), torch.bfloat16), bsh),
                abstract_put(_sds((B, S), torch.int32), bsh),
            )
            in_sh = (param_sh, bsh, bsh)
        else:
            fn = lambda p, tokens: model.prefill(p, tokens)  # noqa: E731
            args = (params, abstract_put(_sds((B, S), torch.int32), bsh))
            in_sh = (param_sh, bsh)
        return Cell(
            arch=spec.name,
            shape=shape_name,
            kind=kind,
            fn=_serving(fn),
            args=args,
            in_shardings=in_sh,
            donate_argnums=(),
            model_flops=mf,
            n_chips=n_chips,
        )

    # decode: the position a replicated int32 scalar, as the JAX cell's
    # _sds((), jnp.int32); the step writes into the caches it is given
    # (donate_argnums=(2,))
    caches = model.init_caches(B, S, dtype=torch.bfloat16, abstract=True)
    cache_sh = cache_shardings(mesh, caches, rules, seq_sharded=seq_sharded)
    fn = lambda p, token, caches, t: model.decode_step(p, token, caches, t)  # noqa: E731
    args = (params, abstract_put(_sds((B, 1), torch.int32), bsh), abstract_put(caches, cache_sh),
            abstract_put(_sds((), torch.int32), rep))
    in_sh = (param_sh, bsh, cache_sh, rep)
    return Cell(
        arch=spec.name,
        shape=shape_name,
        kind=kind,
        fn=_serving(fn),
        args=args,
        in_shardings=in_sh,
        donate_argnums=(2,),
        model_flops=mf,
        n_chips=n_chips,
    )


def _train_batch(spec: ArchSpec, B, S, bsh, rep):
    """The train batch as ``meta`` tensors (global shapes) and its shardings."""
    cfg = spec.config
    if spec.family == "whisper":
        batch = {
            "frames": _sds((B, cfg.n_frames, cfg.d_model), torch.bfloat16),
            "tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32),
        }
        sh = {"frames": bsh, "tokens": bsh, "labels": bsh}
        return batch, sh
    batch = {"tokens": _sds((B, S), torch.int32), "labels": _sds((B, S), torch.int32)}
    sh = {"tokens": bsh, "labels": bsh}
    if getattr(cfg, "mrope_sections", None):
        batch["positions"] = _sds((B, S, 3), torch.int32)
        batch["extra_embeds"] = _sds((B, N_IMG_PATCHES, cfg.d_model), torch.bfloat16)
        batch["embed_positions"] = _sds((B, N_IMG_PATCHES), torch.int32)
        sh["positions"] = bsh
        sh["extra_embeds"] = bsh
        sh["embed_positions"] = bsh
    return batch, sh
