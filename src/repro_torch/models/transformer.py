"""Decoder assembly: embeds → blocks → norm → LM head; port of
``repro/models/transformer.py`` for the layer kinds the port runs.

The layer stack is ``num_repeats`` repeats of the config's (mixer, mlp)
pattern. As in the reference, each pattern position's weights are
stacked on a leading repeat axis (``params["blocks"]["p{i}"]``); where
the reference ``lax.scan``s over that axis, the port loops over it and
takes each layer's weights as views. Decode threads per-layer state,
stacked the same way: a ring-buffer KV cache for attention layers
(written in place), a recurrent state for Mamba2 layers.

Runs the global ("A") and sliding-window ("L") attention mixers and the
"M" (Mamba2 SSD) mixer, the "N" (none), "D" (dense) and "E"
(mixture-of-experts, ``models/moe.py``) MLPs, with an untied head.
Cross-attention ("X") layers, codebook heads and tied embeddings raise
``NotImplementedError``: they come with ROADMAP A12; the mesh levers
(``attn_q_seq_shard``, ``residual_seq_shard``, ``decode_flash_shard``)
with A11. Parameters are a nested dict of tensors with the reference's
keys and layouts; ``params_from_jax`` copies a reference tree into one.
``init_model`` allocates each stacked leaf once and draws every layer
into its view, so building a model takes its weights' memory and no
more (deepseek-moe-16b's 62.9 GiB on an 80 GB card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import attention_decode, attention_forward, init_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import init_kv_cache
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, init_mlp, init_norm, to_tensor)
from repro_torch.models.mamba2 import (
    init_mamba,
    init_mamba_decode_state,
    mamba_decode,
    mamba_forward,
)
from repro_torch.models.moe import apply_moe, init_moe

Tensor = torch.Tensor
Params = Dict[str, Any]

_NOT_PORTED = "layer kind {!r} is not ported yet (cross-attention layers come with ROADMAP A12)"


def _check_ported(cfg: ModelConfig) -> None:
    for mix in cfg.mixer_pattern:
        if mix not in ("A", "L", "M"):
            raise NotImplementedError(_NOT_PORTED.format(mix))
    for mlp in cfg.mlp_pattern:
        if mlp not in ("N", "D", "E"):
            raise NotImplementedError(_NOT_PORTED.format(mlp))
    if cfg.num_codebooks > 1 or cfg.tie_embeddings:
        raise NotImplementedError("codebook heads and tied embeddings come with ROADMAP A12")
    if cfg.residual_seq_shard:  # the attention levers: models.attention._refuse
        raise NotImplementedError("residual_seq_shard is a mesh lever; the LM under a mesh "
                                  "comes with ROADMAP A11")


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):  # MambaState, LayerKVCache
        return type(tree)(**{f.name: fn(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return fn(tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: torch.stack([getattr(t, f.name) for t in trees])
                              for f in dataclasses.fields(first)})
    return torch.stack(trees)


def param_count(params: Params) -> int:
    sizes = []
    _map(lambda a: sizes.append(a.numel()), params)
    return sum(sizes)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_block_position(cfg: ModelConfig, pos: int, generator: torch.Generator,
                         alloc=None) -> Params:
    """One layer of pattern position ``pos``: the mixer, then the MLP,
    drawn from ``generator`` into leaves from ``alloc`` (``new_leaf``)."""
    dtype = getattr(torch, cfg.dtype)
    dev = generator.device
    mix, mlp = cfg.mixer_pattern[pos], cfg.mlp_pattern[pos]
    norm = lambda: init_norm(cfg.d_model, cfg.norm_type, dtype, dev, alloc)
    p: Params = {"norm1": norm()}
    if mix == "M":
        p["mixer"] = init_mamba(cfg, generator, alloc)
    else:
        p["mixer"] = init_attention(cfg, mix, generator, alloc)
    if mlp != "N":
        p["norm2"] = norm()
        if mlp == "D":
            p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.glu, generator=generator,
                                dtype=dtype, alloc=alloc)
        else:
            p["mlp"] = init_moe(cfg, generator, alloc)
    return p


class _StackedLeaves:
    """The ``alloc`` of one pattern position's layers: layer 0's k-th
    call allocates the k-th leaf stacked over the repeats, (R, *shape),
    and returns its view 0; layer r's k-th call returns view r of it.
    ``stacked_of`` maps layer 0's views (by ``id``) to their leaves."""

    def __init__(self, repeats: int, device):
        self.repeats, self.device = repeats, device
        self.stacked: list = []
        self.stacked_of: dict = {}
        self.layer = self.k = 0

    def start(self, layer: int) -> None:
        self.layer, self.k = layer, 0

    def __call__(self, shape, dtype) -> Tensor:
        if self.layer == 0:
            self.stacked.append(torch.empty((self.repeats, *shape), dtype=dtype,
                                            device=self.device))
        leaf = self.stacked[self.k]
        self.k += 1
        view = leaf[self.layer]
        if self.layer == 0:
            self.stacked_of[id(view)] = leaf
        return view


def _init_stacked(cfg: ModelConfig, pos: int, generator: torch.Generator) -> Params:
    """Pattern position ``pos`` over its ``num_repeats`` layers, each leaf
    allocated once on the generator's device and each layer drawn into
    its view in turn: the generator is consumed layer by layer in the
    order of one ``_init_block_position`` call a layer, so the values
    are those of stacking separately drawn layers, and the peak is the
    weights (plus one fp32 leaf where the dtype is not fp32)."""
    leaves = _StackedLeaves(cfg.num_repeats, generator.device)
    first = _init_block_position(cfg, pos, generator, leaves)
    for r in range(1, cfg.num_repeats):
        leaves.start(r)
        _init_block_position(cfg, pos, generator, leaves)
    return _map(lambda view: leaves.stacked_of[id(view)], first)


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Fresh parameters, drawn from a ``torch.Generator`` seeded ``seed``
    on ``device`` (the card unless the caller asks for the CPU): the
    embedding, each pattern position's layers in turn (``_init_stacked``),
    the head."""
    _check_ported(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    params: Params = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), generator=g, dtype=dtype,
                            fan_in=cfg.d_model),
        "blocks": {f"p{i}": _init_stacked(cfg, i, g) for i in range(len(cfg.mixer_pattern))},
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


def _mlp_residual(bp: Params, x: Tensor, cfg: ModelConfig, pos: int,
                  moe_routing: Optional[list]) -> Tuple[Tensor, Optional[Tensor]]:
    """x plus the layer's MLP of its normed x, and an "E" layer's aux
    loss (None for the others)."""
    kind = cfg.mlp_pattern[pos]
    if kind == "N":
        return x, None
    h = apply_norm(x, cfg.norm_type, bp["norm2"])
    mlp = bp["mlp"]
    if kind == "E":
        y, aux = apply_moe(mlp, h, cfg, dispatch=cfg.moe_dispatch, routing=moe_routing)
        return x + y, aux
    return x + apply_mlp(h, mlp["w_in"], mlp["w_out"], mlp.get("w_gate"), act=cfg.act), None


def _block_forward(bp: Params, x: Tensor, cfg: ModelConfig, pos: int, positions: Tensor,
                   use_kernel_ssd: bool, use_flash: bool, moe_routing: Optional[list]):
    mix = cfg.mixer_pattern[pos]
    h = apply_norm(x, cfg.norm_type, bp["norm1"])
    if mix == "M":
        x = x + mamba_forward(bp["mixer"], h, cfg, use_kernel=use_kernel_ssd)
    else:
        x = x + attention_forward(bp["mixer"], h, cfg, mix, positions, use_flash=use_flash)
    return _mlp_residual(bp, x, cfg, pos, moe_routing)


def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            use_kernel_ssd: bool = True, use_flash: bool = True,
            last_logits_only: bool = False,
            moe_routing: Optional[list] = None) -> Tuple[Tensor, Tensor]:
    """tokens (B, S) → (logits (B, S or 1, V), the "E" layers' aux loss
    summed over the layers in order, fp32; 0 without "E" layers).

    ``use_kernel_ssd`` (the default) routes every Mamba2 layer's scan
    through ``kernels.ssd.ops`` (K7 on the card), ``False`` through the
    plain ``ssd_chunked``; ``use_flash`` (the default) every attention
    layer's causal attention through ``kernels.flash_attention.ops`` (K3
    on the card; windowed on "L" layers), ``False`` through the plain
    ``_ref_attention``. Positions are ``arange(S)``. ``last_logits_only``
    applies the head to the last position only, as a serving prefill
    needs. ``moe_routing`` (tests and the smoke only) collects every "E"
    layer's routing decisions in layer order (``moe.apply_moe``)."""
    _check_ported(cfg)
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.num_repeats):
        for i in range(len(cfg.mixer_pattern)):
            x, a = _block_forward(_layer(params["blocks"][f"p{i}"], r), x, cfg, i, positions,
                                  use_kernel_ssd, use_flash, moe_routing)
            if a is not None:
                aux = aux + a
    if last_logits_only:
        x = x[:, -1:]
    x = apply_norm(x, cfg.norm_type, params["final_norm"])
    return lm_logits(params, x, cfg), aux


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device="cpu") -> Dict[str, Any]:
    """Per-pattern-position decode state, stacked over repeats: an "A"
    layer's KV cache holds ``cache_len`` tokens, an "L" layer's
    ``min(cache_len, sliding_window)`` (a ring buffer of its window); a
    Mamba2 state does not grow with the sequence."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    state = {}
    for i, mix in enumerate(cfg.mixer_pattern):
        if mix == "M":
            one = init_mamba_decode_state(cfg, batch, device)
        else:
            eff = cache_len if mix == "A" else min(cache_len, cfg.sliding_window)
            one = init_kv_cache(batch, eff, cfg.num_kv_heads, cfg.head_dim, dtype, device)
        state[f"p{i}"] = _map(lambda a: a.expand((cfg.num_repeats,) + a.shape).clone(), one)
    return state


def decode_step(params: Params, tokens: Tensor, state: Dict[str, Any], cfg: ModelConfig, *,
                start_pos: Optional[Tensor] = None,
                moe_routing: Optional[list] = None) -> Tuple[Tensor, Dict[str, Any]]:
    """One decode step. tokens (B, 1) → (logits (B, 1, V), state').

    The attention layers' caches are written in place (state' holds the
    same cache tensors), the Mamba2 states are new tensors: pass each
    state to one step. ``start_pos`` (B,), on the state's device, hides
    from each batch lane the cache positions before its own request
    (continuous batching). An "E" layer routes the step's B tokens as one
    group, so every lane (a free batcher slot too) takes capacity, and
    its aux loss is discarded, as in the reference; ``moe_routing`` as in
    ``forward``."""
    _check_ported(cfg)
    x = embed_tokens(params, tokens, cfg)
    new = {f"p{i}": [] for i in range(len(cfg.mixer_pattern))}
    for r in range(cfg.num_repeats):
        for i, mix in enumerate(cfg.mixer_pattern):
            bp = _layer(params["blocks"][f"p{i}"], r)
            h = apply_norm(x, cfg.norm_type, bp["norm1"])
            st = _layer(state[f"p{i}"], r)
            if mix == "M":
                y, s_new = mamba_decode(bp["mixer"], h, cfg, st)
                new[f"p{i}"].append(s_new)
            else:  # the views write into the stacked cache
                y, _ = attention_decode(bp["mixer"], h, cfg, mix, st, start_pos=start_pos)
            x, _ = _mlp_residual(bp, x + y, cfg, i, moe_routing)  # aux discarded
    x = apply_norm(x, cfg.norm_type, params["final_norm"])
    out = {k: _stack(v) if v else state[k] for k, v in new.items()}
    return lm_logits(params, x, cfg), out
