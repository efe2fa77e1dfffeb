"""The attention owner and the language models' attention mixers; port
of ``repro/models/attention.py``.

``attention`` is the single place that decides between the plain path
and the flash kernel (DESIGN.md §13), with the reference's fallback
rules: ``softcap > 0`` and cross-length q/k always take the plain path.
Its public face is the model layout (B, S, H, D).

The mixers: global causal ("A") and sliding-window causal ("L")
self-attention with GQA, QKV biases (``qkv_bias``), per-head RMS q/k
norms (``qk_norm``), rotary positions and optional logit soft-capping,
and cross-attention ("X": queries from the text, keys and values
projected from the image embeddings ``cross_kv`` of width
``vision_dim``; no rotary positions, no mask). ``attention_forward`` is
the training / prefill form (with ``use_flash`` an "A"/"L" layer's
attention runs K3, causal, windowed on "L"; an "X" layer always takes the
plain path, as in the reference); ``attention_decode`` the single-token
form over the ring-buffer ``LayerKVCache`` ("X" is stateless: it
recomputes the image K/V each step). The sequence-sharding levers
(``attn_q_seq_shard``, ``decode_flash_shard``) come with ROADMAP A11.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import LayerKVCache, cache_write, valid_mask
from repro_torch.models.layers import apply_norm, dense_init, init_norm, new_leaf, rope

Tensor = torch.Tensor


def _refuse(cfg: ModelConfig, kind: str) -> None:
    """Raise for what the mixers do not run: the attention layers' mesh
    levers."""
    if kind not in ("A", "L", "X"):
        raise ValueError(f"not an attention mixer: {kind!r}")
    for lever in ("attn_q_seq_shard", "decode_flash_shard"):
        if getattr(cfg, lever):
            raise NotImplementedError(f"{lever} is a mesh lever; serving and "
                                      f"attention under a mesh come with ROADMAP A11")


def init_attention(cfg: ModelConfig, kind: str, generator: torch.Generator,
                   alloc=None) -> dict:
    """An "A", "L" or "X" mixer's parameters (reference ``attention.py:28``):
    ``wq`` (E, H, Dh), ``wk``/``wv`` (E, Kv, Dh) (an "X" layer's from the
    image embeddings: (vision_dim, Kv, Dh), fan-in vision_dim), ``wo``
    (H, Dh, E), zero ``bq``/``bk``/``bv`` with ``qkv_bias``, unit ``q_norm``/``k_norm``
    scales with ``qk_norm``; drawn from ``generator`` on its device, into
    leaves from ``alloc`` where given (``layers.new_leaf``)."""
    _refuse(cfg, kind)
    E, H, Kv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dtype, dev = getattr(torch, cfg.dtype), generator.device
    draw = lambda shape, fan: dense_init(shape, generator=generator, dtype=dtype, fan_in=fan,
                                         alloc=alloc)
    kv_in = cfg.vision_dim if kind == "X" else E
    p = {"wq": draw((E, H, Dh), E), "wk": draw((kv_in, Kv, Dh), kv_in),
         "wv": draw((kv_in, Kv, Dh), kv_in), "wo": draw((H, Dh, E), H * Dh)}
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", Kv), ("bv", Kv)):
            p[name] = new_leaf(alloc, (heads, Dh), dtype, dev).zero_()
    if cfg.qk_norm:
        p["q_norm"] = init_norm(Dh, "rmsnorm", dtype, dev, alloc)
        p["k_norm"] = init_norm(Dh, "rmsnorm", dtype, dev, alloc)
    return p


def _project_qkv(params: dict, x: Tensor, kv_src: Tensor, cfg: ModelConfig):
    """q from x (B, S, E), k and v from ``kv_src`` (B, Sk, E or
    vision_dim) → q (B, S, H, Dh), k, v (B, Sk, Kv, Dh), with the biases
    and the q/k norms the config asks for (reference :49)."""
    q = torch.einsum("bse,ehd->bshd", x, params["wq"])
    k = torch.einsum("bse,ehd->bshd", kv_src, params["wk"])
    v = torch.einsum("bse,ehd->bshd", kv_src, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = apply_norm(q, "rmsnorm", params["q_norm"])
        k = apply_norm(k, "rmsnorm", params["k_norm"])
    return q, k, v


def _softcap(logits: Tensor, cap: float) -> Tensor:
    """Gemma-style logit soft-capping, cap·tanh(logits / cap) (reference :63)."""
    if cap and cap > 0.0:
        return cap * torch.tanh(logits / cap)
    return logits


def _ref_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                   window: Optional[int], softcap: float) -> Tensor:
    """(B, S, H, D) × (B, Sk, Kv, D) GQA attention with an fp32 softmax."""
    B, S, H, D = q.shape
    Kv, Sk = k.shape[2], k.shape[1]
    group = H // Kv
    kk = torch.repeat_interleave(k, group, dim=2).to(torch.float32)
    vv = torch.repeat_interleave(v, group, dim=2).to(torch.float32)
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kk) * (D ** -0.5)
    logits = _softcap(logits, softcap)
    qpos = torch.arange(S, device=q.device)[:, None] + (Sk - S)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    # a fill, not a host-made constant, so a CUDA graph can capture it
    logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vv)
    return out.to(q.dtype)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
              window: Optional[int] = None, softcap: float = 0.0,
              use_flash: bool = False) -> Tensor:
    """(B, S, H, D) × (B, Sk, Kv, D) → (B, S, H, D).

    With ``use_flash`` (and no softcap, and Sq == Sk) the flash wrapper
    runs on transposed views of q/k/v, so no copy is made; its result is
    transposed back. Otherwise the plain path.
    """
    if use_flash and not softcap and q.shape[1] == k.shape[1]:
        out = flash.attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window)
        return out.transpose(1, 2)
    return _ref_attention(q, k, v, causal=causal, window=window, softcap=softcap)


def attention_forward(params: dict, x: Tensor, cfg: ModelConfig, kind: str,
                      positions: Optional[Tensor], *, cross_kv: Optional[Tensor] = None,
                      use_flash: bool = False) -> Tensor:
    """Training / prefill attention (reference :153). x (B, S, E),
    positions (B or 1, S) → (B, S, E). "A"/"L": causal self-attention; an
    "L" layer sees its last ``cfg.sliding_window`` positions; with
    ``use_flash`` the attention goes through the flash wrapper (K3 on the
    card) unless the config soft-caps its logits. "X": attention over the
    image embeddings ``cross_kv`` (B, num_patches, vision_dim), no rotary
    positions, no mask, always the plain path (the reference passes no
    ``use_flash`` there, so even S == num_patches stays off K3)."""
    _refuse(cfg, kind)
    if kind == "X":
        if cross_kv is None:
            raise ValueError("a cross-attention ('X') layer needs cross_kv, the image "
                             "embeddings (B, num_patches, vision_dim)")
        q, k, v = _project_qkv(params, x, cross_kv, cfg)
        out = attention(q, k, v, causal=False, window=None, softcap=cfg.attn_logit_softcap)
        return torch.einsum("bshd,hde->bse", out, params["wo"])
    q, k, v = _project_qkv(params, x, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if kind == "L" else None
    out = attention(q, k, v, causal=True, window=window,
                    softcap=cfg.attn_logit_softcap, use_flash=use_flash)
    return torch.einsum("bshd,hde->bse", out, params["wo"])


def attention_decode(params: dict, x: Tensor, cfg: ModelConfig, kind: str,
                     cache: Optional[LayerKVCache], *, cross_kv: Optional[Tensor] = None,
                     start_pos: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Optional[LayerKVCache]]:
    """Single-token decode over the ring-buffer cache (reference :192, its
    unsharded branch). x (B, 1, E) → ((B, 1, E), the cache, written in
    place). The token sits at position ``cache.length``; ``start_pos``
    (B,) hides each lane's slots from before its own request. An "X"
    layer is stateless: it recomputes the image K/V from ``cross_kv`` and
    returns ``cache`` untouched."""
    _refuse(cfg, kind)
    if kind == "X":
        return attention_forward(params, x, cfg, kind, None, cross_kv=cross_kv), cache
    q, k_new, v_new = _project_qkv(params, x, x, cfg)
    pos = cache.length.to(torch.int32).expand(x.shape[0], 1)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    window = cfg.sliding_window if kind == "L" else None
    cache = cache_write(cache, k_new, v_new)
    mask = valid_mask(cache, window, start_pos)  # (Sc,) or (B, Sc)

    D = q.shape[-1]
    group = q.shape[2] // cache.k.shape[2]
    kk = torch.repeat_interleave(cache.k, group, dim=2).to(torch.float32)  # (B, Sc, H, D)
    vv = torch.repeat_interleave(cache.v, group, dim=2).to(torch.float32)
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kk) * (D ** -0.5)
    logits = _softcap(logits, cfg.attn_logit_softcap)
    mask = mask[:, None, None, :] if mask.ndim == 2 else mask[None, None, None, :]
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vv).to(x.dtype)
    return torch.einsum("bshd,hde->bse", out, params["wo"]), cache
