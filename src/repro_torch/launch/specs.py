"""Meta-device stand-ins for every (arch × shape) combination, on one
card or as one rank of a mesh; port of ``repro/launch/specs.py``.

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
run only on CPU or CUDA tensors. ``batch_shardings``,
``decode_state_shardings`` and ``train_layout`` give the reference's
layouts over the port's ``Mesh`` (the serving and training paths under a
mesh read them): ``train_layout`` is the parameter and moment shardings
of ``build_dryrun``'s train branch (reference :125-138, ``fsdp=`` and
``zero1=``), the counterpart of its ``in_shardings``/``out_shardings``.

``build_dryrun(mesh=)`` builds one rank of a mesh without process groups
(``launch/mesh.py::make_production_mesh``): every leaf a meta tensor of
the rank's block (``ParamSharding.local_shape`` of ``param_shardings``
with ``physical_experts``, as the reference lays out every kind), the
moments by ``fsdp or zero1``, the decode state of
``init_decode_state(mesh=)``, and the step under ``mesh=``, which the dry
run counts inside ``parallel.collectives.counting()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import InputShape, apply_shape_policy
from repro_torch.launch.steps import (
    init_opt_state, make_prefill_step, make_serve_step, make_train_step)
from repro_torch.models import init_decode_state, init_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW
from repro_torch.parallel.sharding import (
    MODEL_AXIS, batch_sharding, data_axes, kv_cache_spec, param_shardings, tree_map_with_path)

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


#: the train layouts: "tp" (the parameters by the tensor-parallel rules,
#: replicated over the data axes: data parallelism where "model" is 1),
#: "fsdp" (ZeRO-3: parameters, gradients and moments cut over the data
#: axes too) and "zero1" (the moments alone cut over the data axes)
LAYOUTS = ("tp", "fsdp", "zero1")


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """A train step's layout on a mesh: ``params``, the ``ParamSharding``
    tree of the parameters (and of their gradients), and ``moments``, that
    of the AdamW moments (reference ``specs.py:128-138``; ``step`` is
    replicated)."""

    name: str
    params: Any
    moments: Any

    def blocks(self):
        """ZeRO-1's tree for ``AdamW.init``/``update``: where a moment is cut
        over data axes that its parameter is not, the data part of the
        moment's sharding (the block of the rank's parameter it holds),
        else None."""
        def one(path, m):
            p = _at(self.params, path)
            return m.data_part() if m.data_dim() is not None and p.data_dim() is None else None
        return tree_map_with_path(one, self.moments)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _blocks_of(tree) -> list:
    """Each leaf's cut dimensions and their axes, axes of one rank dropped
    (a spec naming a one-rank axis cuts nothing)."""
    out = []

    def one(path, s):
        sizes = s.mesh.shape
        cut = tuple((d, tuple(a for a in ((e,) if isinstance(e, str) else e) if sizes[a] > 1))
                    for d, e in enumerate(s.spec) if e)
        out.append((path, tuple(c for c in cut if c[1])))

    tree_map_with_path(one, tree)
    return out


def train_layout(cfg: ModelConfig, mesh, layout: str = "tp") -> TrainLayout:
    """The reference's train shardings on the port's ``mesh``: parameters
    by ``param_shardings(fsdp=layout == "fsdp")``, moments by
    ``param_shardings(fsdp=layout in ("fsdp", "zero1"))``, with
    ``physical_experts`` as ``specs.py`` passes it. The reference's
    ``train.py`` places its parameters with ``num_experts``
    (``models.transformer.model_shardings``, which ``train_loop`` and
    ``init_model(mesh=)`` follow): a padded-expert config on which the two
    counts give different layouts raises ``ValueError``."""
    out = _layout(cfg, mesh, layout)
    nexp = cfg.moe.physical_experts if cfg.moe else None
    if cfg.moe and nexp != cfg.moe.num_experts:
        shapes = abstract_params(cfg)
        other = param_shardings(shapes, mesh, cfg.moe.num_experts, fsdp=layout == "fsdp")
        if _blocks_of(other) != _blocks_of(out.params):
            raise ValueError(
                f"{cfg.name}: padded experts ({nexp} physical for {cfg.moe.num_experts}): "
                f"launch/specs.py lays the train step out by physical_experts and "
                f"launch/train.py by num_experts, and on this mesh the two layouts differ")
    return out


def _layout(cfg: ModelConfig, mesh, layout: str) -> TrainLayout:
    """``train_layout`` without its refusal: the dry run's layout of every
    kind (reference ``specs.py:128-138``), which trains nothing."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    shapes = abstract_params(cfg)
    nexp = cfg.moe.physical_experts if cfg.moe else None
    params = param_shardings(shapes, mesh, nexp, fsdp=layout == "fsdp")
    moments = param_shardings(shapes, mesh, nexp, fsdp=layout in ("fsdp", "zero1"))
    return TrainLayout(layout, params, moments)


def local_params(cfg: ModelConfig, shardings):
    """The rank's parameter blocks as meta tensors: each leaf of
    ``abstract_params(cfg)`` at its ``ParamSharding.local_shape``."""
    shapes = abstract_params(cfg)
    return tree_map_with_path(
        lambda path, sh: torch.empty(sh.local_shape(_at(shapes, path).shape),
                                     dtype=_at(shapes, path).dtype, device=META), shardings)


@dataclasses.dataclass
class DryRunSpec:
    name: str
    kind: str
    cfg: ModelConfig
    fn: Callable
    args: Tuple[Any, ...]
    #: under a mesh: the mesh, the layout (parameters and moments) and the
    #: ``RowSharding`` of the batch's rows
    mesh: Any = None
    layout: Optional[TrainLayout] = None
    rows: Any = None


def build_dryrun(cfg: ModelConfig, shape: InputShape, mesh=None, *, remat: str = "none",
                 dtype: str = "bfloat16", fsdp: bool = False, zero1: bool = False,
                 cfg_overrides: Optional[dict] = None,
                 last_logits_only: bool = True) -> DryRunSpec:
    """The step of ``shape.kind`` and its meta arguments for one (arch ×
    shape): the config after the shape policy, in ``dtype``, with
    ``cfg_overrides``. Train: (params, AdamW moments, batch) of
    global_batch × seq_len; prefill: (params, batch); decode: one token a
    sequence against a cache of seq_len, (params, batch, state).

    ``mesh`` (one rank's place, on the meta device): the rank's blocks
    laid out by ``param_shardings(physical_experts, fsdp=fsdp)``, the
    moments by ``fsdp or zero1`` (the train layouts "fsdp", "zero1" or
    "tp"), the decode state by ``init_decode_state(mesh=)``; the batch is
    global (every rank is called with it and keeps its rows). ``fsdp``
    and ``zero1`` need a mesh."""
    cfg = apply_shape_policy(cfg, shape).replace(dtype=dtype)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    name = f"{cfg.name}:{shape.name}"
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    if mesh is None:
        if fsdp or zero1:
            raise ValueError("fsdp and zero1 lay a step out over a mesh: pass mesh=")
        return _one_card(cfg, shape, name, remat, last_logits_only)
    layout = _layout(cfg, mesh, "fsdp" if fsdp else "zero1" if zero1 else "tp")
    params = local_params(cfg, layout.params)
    seq = 1 if shape.kind == "decode" else shape.seq_len
    batch = token_specs(cfg, shape.global_batch, seq)
    rows = batch_sharding(mesh, shape.global_batch, 1)
    if shape.kind == "train":
        optimizer = AdamW(lr=1e-4)
        fn = make_train_step(cfg, optimizer, remat=remat, mesh=mesh, shardings=layout)
        args = (params, init_opt_state(optimizer, params, layout), batch)
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg, use_flash=False, use_kernel_ssd=False,
                               last_logits_only=last_logits_only, mesh=mesh,
                               shardings=layout.params)
        args = (params, batch)
    else:
        fn = make_serve_step(cfg, mesh=mesh, shardings=layout.params)
        args = (params, batch, init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                                 device=META, mesh=mesh))
    return DryRunSpec(name=name, kind=shape.kind, cfg=cfg, fn=fn, args=args, mesh=mesh,
                      layout=layout, rows=rows)


def _one_card(cfg: ModelConfig, shape: InputShape, name: str, remat: str,
              last_logits_only: bool) -> DryRunSpec:
    params = abstract_params(cfg)
    if shape.kind == "train":
        optimizer = AdamW(lr=1e-4)
        fn = make_train_step(cfg, optimizer, remat=remat, device=META)
        args = (params, abstract_opt_state(optimizer, params),
                token_specs(cfg, shape.global_batch, shape.seq_len))
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg, use_flash=False, use_kernel_ssd=False,
                               last_logits_only=last_logits_only, device=META)
        args = (params, token_specs(cfg, shape.global_batch, shape.seq_len))
    else:
        fn = make_serve_step(cfg, device=META)
        args = (params, token_specs(cfg, shape.global_batch, 1),
                decode_state_specs(cfg, shape.global_batch, shape.seq_len))
    return DryRunSpec(name=name, kind=shape.kind, cfg=cfg, fn=fn, args=args)
