"""Meta-device stand-ins for every (arch × shape) combination; port of
``repro/launch/specs.py`` on one card.

Where the reference builds ``jax.ShapeDtypeStruct`` trees through
``jax.eval_shape``, the port builds its own parameters, optimizer
moments, token batches and decode states as tensors on the ``meta``
device: the port's shapes and dtypes, no storage, nothing drawn
(``init_model(device="meta")`` allocates every leaf and draws none).
``build_dryrun`` assembles the step function of the shape's kind and its
meta arguments; ``launch/dryrun.py`` runs it under a FLOP and byte
counter.

The step takes the plain attention and SSD paths by explicit arguments
(``use_flash=False``, ``use_kernel_ssd=False``): the kernels' wrappers
run only on CPU or CUDA tensors. ``batch_shardings`` and
``decode_state_shardings`` give the reference's layouts over the port's
``Mesh`` (the serving path under a mesh reads them); the train
layouts (``fsdp``, ``zero1``) and a dry run under a mesh wait for ROADMAP
A11 (i) and (iii).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import InputShape, apply_shape_policy
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import init_decode_state, init_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW
from repro_torch.parallel.sharding import MODEL_AXIS, batch_sharding, data_axes, kv_cache_spec

META = torch.device("meta")


def abstract_params(cfg: ModelConfig):
    """The parameter tree of ``init_model(cfg)`` as meta tensors."""
    return init_model(cfg, device=META)


def abstract_opt_state(optimizer: AdamW, params_abs):
    """The optimizer's moments for meta parameters (meta, fp32)."""
    return optimizer.init(params_abs)


def token_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """The batch of a step: int32 tokens (B, S) or (B, S, K), and the
    image embeddings (B, num_patches, vision_dim) in the model's dtype
    where the model has cross-attention."""
    shape = (batch, seq, cfg.num_codebooks) if cfg.num_codebooks > 1 else (batch, seq)
    specs = {"tokens": torch.empty(shape, dtype=torch.int32, device=META)}
    if cfg.vision_dim:
        specs["cross_embeds"] = torch.empty((batch, cfg.num_patches, cfg.vision_dim),
                                            dtype=getattr(torch, cfg.dtype), device=META)
    return specs


def decode_state_specs(cfg: ModelConfig, batch: int, cache_len: int):
    """``init_decode_state(cfg, batch, cache_len)`` on the meta device."""
    return init_decode_state(cfg, batch, cache_len, device=META)


def batch_shardings(cfg: ModelConfig, mesh, batch_specs) -> Dict[str, Any]:
    """The ``RowSharding`` of each leaf of a step's batch (reference :60):
    rows over the data axes when they divide the batch."""
    return {k: batch_sharding(mesh, v.shape[0], v.ndim) for k, v in batch_specs.items()}


def decode_state_shardings(cfg: ModelConfig, mesh, state_abs) -> Dict[str, Any]:
    """The spec of every leaf of a stacked decode state (reference :70;
    ``state_abs`` as ``decode_state_specs`` gives it): a KV cache's k/v
    (R, B, S_cache, Kv, Dh) by ``kv_cache_spec``; a Mamba2 state's ssm
    (R, B, H, N, P) rows over the data axes and heads over "model" when
    they divide, its conv (R, B, W−1, C) rows only; everything else
    replicated. As dicts ``{"p{i}": {leaf name: spec}}``. The port's
    caches under ``decode_flash_shard`` lie over the lever's axes instead
    (``parallel.sharding.decode_cache_sharding``, what the reference's
    ``flash_decode`` reshards to), and its conv state holds a rank's x
    channels (its heads' inputs) where the reference replicates them."""
    out: Dict[str, Any] = {}
    msize = mesh.shape.get(MODEL_AXIS, 1)
    for key, st in state_abs.items():
        leaves = {}
        for f in (dataclasses.fields(st) if dataclasses.is_dataclass(st) else ()):
            leaf = getattr(st, f.name)
            if not isinstance(leaf, torch.Tensor):
                continue
            shape = leaf.shape
            bax = batch_sharding(mesh, shape[1], 1).spec[0] if leaf.ndim >= 2 else None
            if f.name in ("k", "v") and leaf.ndim == 5:
                spec = (None, *kv_cache_spec(mesh.shape, data_axes(mesh), shape[1], shape[2],
                                             shape[3]))
            elif f.name == "ssm" and leaf.ndim == 5:
                spec = (None, bax, MODEL_AXIS if shape[2] % msize == 0 else None, None, None)
            elif f.name == "conv" and leaf.ndim == 4:
                spec = (None, bax, None, None)
            else:
                spec = ()
            leaves[f.name] = spec
        out[key] = leaves
    return out


@dataclasses.dataclass
class DryRunSpec:
    name: str
    kind: str
    cfg: ModelConfig
    fn: Callable
    args: Tuple[Any, ...]


def build_dryrun(cfg: ModelConfig, shape: InputShape, *, remat: str = "none",
                 dtype: str = "bfloat16", cfg_overrides: Optional[dict] = None,
                 last_logits_only: bool = True) -> DryRunSpec:
    """The step of ``shape.kind`` and its meta arguments for one (arch ×
    shape): the config after the shape policy, in ``dtype``, with
    ``cfg_overrides``. Train: (params, AdamW moments, batch) of
    global_batch × seq_len; prefill: (params, batch); decode: one token a
    sequence against a cache of seq_len, (params, batch, state)."""
    cfg = apply_shape_policy(cfg, shape).replace(dtype=dtype)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    params = abstract_params(cfg)
    name = f"{cfg.name}:{shape.name}"
    if shape.kind == "train":
        optimizer = AdamW(lr=1e-4)
        fn = make_train_step(cfg, optimizer, remat=remat, device=META)
        args = (params, abstract_opt_state(optimizer, params),
                token_specs(cfg, shape.global_batch, shape.seq_len))
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg, use_flash=False, use_kernel_ssd=False,
                               last_logits_only=last_logits_only, device=META)
        args = (params, token_specs(cfg, shape.global_batch, shape.seq_len))
    elif shape.kind == "decode":
        fn = make_serve_step(cfg, device=META)
        args = (params, token_specs(cfg, shape.global_batch, 1),
                decode_state_specs(cfg, shape.global_batch, shape.seq_len))
    else:
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    return DryRunSpec(name=name, kind=shape.kind, cfg=cfg, fn=fn, args=args)
