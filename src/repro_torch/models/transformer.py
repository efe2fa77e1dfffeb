"""Decoder assembly: embeds → blocks → norm → LM head; port of
``repro/models/transformer.py`` for the layer kinds the port runs.

The layer stack is ``num_repeats`` repeats of the config's (mixer, mlp)
pattern. As in the reference, each pattern position's weights are
stacked on a leading repeat axis (``params["blocks"]["p{i}"]``); where
the reference ``lax.scan``s over that axis, the port loops over it and
takes each layer's weights as views. Decode threads per-layer recurrent
state, stacked the same way.

Runs the "M" (Mamba2 SSD) mixer and the "N" (none) and "D" (dense) MLPs
with an untied head. Attention ("A", "L", "X") and mixture-of-experts
("E") layers, codebook heads and tied embeddings raise
``NotImplementedError``: they come with ROADMAP A12. Parameters are a
nested dict of tensors with the reference's keys and layouts;
``params_from_jax`` copies a reference tree into one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import MambaState
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, init_mlp, init_norm, to_tensor)
from repro_torch.models.mamba2 import (
    init_mamba,
    init_mamba_decode_state,
    mamba_decode,
    mamba_forward,
)

Tensor = torch.Tensor
Params = Dict[str, Any]

_NOT_PORTED = ("layer kind {!r} is not ported yet (attention and mixture-of-experts "
               "layers come with ROADMAP A12)")


def _check_ported(cfg: ModelConfig) -> None:
    for mix in cfg.mixer_pattern:
        if mix != "M":
            raise NotImplementedError(_NOT_PORTED.format(mix))
    for mlp in cfg.mlp_pattern:
        if mlp not in ("N", "D"):
            raise NotImplementedError(_NOT_PORTED.format(mlp))
    if cfg.num_codebooks > 1 or cfg.tie_embeddings:
        raise NotImplementedError("codebook heads and tied embeddings come with ROADMAP A12")


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, MambaState):
        return MambaState(conv=fn(tree.conv), ssm=fn(tree.ssm))
    return fn(tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, MambaState):
        return MambaState(conv=torch.stack([t.conv for t in trees]),
                          ssm=torch.stack([t.ssm for t in trees]))
    return torch.stack(trees)


def param_count(params: Params) -> int:
    sizes = []
    _map(lambda a: sizes.append(a.numel()), params)
    return sum(sizes)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_block_position(cfg: ModelConfig, pos: int, generator: torch.Generator) -> Params:
    dtype = getattr(torch, cfg.dtype)
    dev = generator.device
    p: Params = {"norm1": init_norm(cfg.d_model, cfg.norm_type, dtype, dev),
                 "mixer": init_mamba(cfg, generator)}
    if cfg.mlp_pattern[pos] == "D":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm_type, dtype, dev)
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.glu, generator=generator, dtype=dtype)
    return p


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Fresh parameters, drawn from a ``torch.Generator`` seeded ``seed``
    on ``device`` (the card unless the caller asks for the CPU)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    params: Params = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), generator=g, dtype=dtype,
                            fan_in=cfg.d_model),
        "blocks": {f"p{i}": _stack([_init_block_position(cfg, i, g)
                                    for _ in range(cfg.num_repeats)])
                   for i in range(len(cfg.mixer_pattern))},
        "final_norm": init_norm(cfg.d_model, cfg.norm_type, dtype, dev),
        "lm_head": dense_init((cfg.d_model, cfg.vocab_size), generator=g, dtype=dtype),
    }
    return params


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device="cpu") -> Params:
    """The reference's ``init_model`` tree (nested dicts of numpy arrays
    or tensors, the blocks stacked on their repeat axis) → the port's
    parameters on ``device`` holding the same values. Keys and shapes
    must be those of the port's ``init_model(cfg)``; each leaf keeps the
    config's dtype."""
    params = init_model(cfg, device=device)
    with torch.no_grad():
        _copy_tree(params, tree, "")
    return params


def _copy_tree(dst, src, path: str) -> None:
    if isinstance(dst, Mapping):
        if not isinstance(src, Mapping) or set(src) != set(dst):
            got = sorted(src) if isinstance(src, Mapping) else type(src).__name__
            raise ValueError(f"{path or '/'}: keys {got} != {sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{path}/{k}")
        return
    value = to_tensor(src)
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(value.shape)} != {tuple(dst.shape)}")
    dst.copy_(value.to(dst.dtype))


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------

def embed_tokens(params: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return params["embed"][tokens.long()]


def lm_logits(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    return x @ params["lm_head"]


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def _layer(tree, r: int):
    """Layer r's weights: views into the stacked tensors."""
    return _map(lambda a: a[r], tree)


def _mlp_residual(bp: Params, x: Tensor, cfg: ModelConfig, pos: int) -> Tensor:
    if cfg.mlp_pattern[pos] == "N":
        return x
    h = apply_norm(x, cfg.norm_type, bp["norm2"])
    mlp = bp["mlp"]
    return x + apply_mlp(h, mlp["w_in"], mlp["w_out"], mlp.get("w_gate"), act=cfg.act)


def _block_forward(bp: Params, x: Tensor, cfg: ModelConfig, pos: int,
                   use_kernel_ssd: bool) -> Tensor:
    h = apply_norm(x, cfg.norm_type, bp["norm1"])
    x = x + mamba_forward(bp["mixer"], h, cfg, use_kernel=use_kernel_ssd)
    return _mlp_residual(bp, x, cfg, pos)


def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            use_kernel_ssd: bool = True,
            last_logits_only: bool = False) -> Tuple[Tensor, Tensor]:
    """tokens (B, S) → (logits (B, S or 1, V), aux loss 0).

    ``use_kernel_ssd`` (the default) routes every Mamba2 layer's scan
    through ``kernels.ssd.ops`` (K7 on the card); ``False`` is the plain
    ``ssd_chunked`` path; ``last_logits_only`` applies
    the head to the last position only, as a serving prefill needs."""
    _check_ported(cfg)
    x = embed_tokens(params, tokens, cfg)
    for r in range(cfg.num_repeats):
        for i in range(len(cfg.mixer_pattern)):
            x = _block_forward(_layer(params["blocks"][f"p{i}"], r), x, cfg, i,
                               use_kernel_ssd)
    if last_logits_only:
        x = x[:, -1:]
    x = apply_norm(x, cfg.norm_type, params["final_norm"])
    return lm_logits(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device="cpu") -> Dict[str, Any]:
    """Per-pattern-position recurrent state, stacked over repeats. A
    Mamba2 state does not grow with the sequence, so ``cache_len`` (the
    attention layers' cache length) sizes nothing here."""
    _check_ported(cfg)
    one = init_mamba_decode_state(cfg, batch, device)
    return {f"p{i}": _map(lambda a: a.expand((cfg.num_repeats,) + a.shape).clone(), one)
            for i in range(len(cfg.mixer_pattern))}


def decode_step(params: Params, tokens: Tensor, state: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Any]]:
    """One decode step. tokens (B, 1) → (logits (B, 1, V), state')."""
    _check_ported(cfg)
    x = embed_tokens(params, tokens, cfg)
    new = {f"p{i}": [] for i in range(len(cfg.mixer_pattern))}
    for r in range(cfg.num_repeats):
        for i in range(len(cfg.mixer_pattern)):
            bp = _layer(params["blocks"][f"p{i}"], r)
            h = apply_norm(x, cfg.norm_type, bp["norm1"])
            y, s_new = mamba_decode(bp["mixer"], h, cfg, _layer(state[f"p{i}"], r))
            new[f"p{i}"].append(s_new)
            x = _mlp_residual(bp, x + y, cfg, i)
    x = apply_norm(x, cfg.norm_type, params["final_norm"])
    return lm_logits(params, x, cfg), {k: _stack(v) for k, v in new.items()}
