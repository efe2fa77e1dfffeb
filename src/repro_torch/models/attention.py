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
recomputes the image K/V each step).

Under a mesh (``shard``: the layer's tree of
``parallel.sharding.ParamSharding``; ``mesh``) each rank holds its
slices and computes on them. ``wq``/``bq``/``wo`` follow their spec: of
the n ranks of "model", rank r holds query heads [r·H/n, (r+1)·H/n) when
n divides H, else every head (``wq`` replicated). Its KV heads are its
own slice when ``wk``/``wv`` shard; when they are replicated it projects
the KV heads its query heads read (a contiguous range, one head when its
query heads share one; one KV head a query head where the range would
not split into whole groups). K3 runs on those local heads, and ``wo``'s
partial sum is finished by one all-reduce over "model" (none when ``wo``
is replicated). ``attn_q_seq_shard`` splits the query rows over "model"
(every head gathered first): each rank runs K3 on its rows against the
keys they see, and the rows are gathered. A decode cache that holds a
sequence slice (``LayerKVCache.sharding``: ``kv_cache_spec`` shards the
sequence, or ``decode_flash_shard`` names axes) goes through
``parallel.collectives.flash_decode``, as in the reference (:217).
Under autograd ``_project`` marks where the replicated input and the
replicated leaves enter the rank's heads (``enter_model_region``), and
every gather names its backward.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import LayerKVCache, cache_write, valid_mask
from repro_torch.models.layers import apply_norm, dense_init, init_norm, new_leaf, rope
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    batch_sharding, check_levers, lever_axes, model_rank, split_rows)

Tensor = torch.Tensor


def _check_kind(kind: str) -> None:
    if kind not in ("A", "L", "X"):
        raise ValueError(f"not an attention mixer: {kind!r}")


def init_attention(cfg: ModelConfig, kind: str, generator: torch.Generator,
                   alloc=None) -> dict:
    """An "A", "L" or "X" mixer's parameters (reference ``attention.py:28``):
    ``wq`` (E, H, Dh), ``wk``/``wv`` (E, Kv, Dh) (an "X" layer's from the
    image embeddings: (vision_dim, Kv, Dh), fan-in vision_dim), ``wo``
    (H, Dh, E), zero ``bq``/``bk``/``bv`` with ``qkv_bias``, unit ``q_norm``/``k_norm``
    scales with ``qk_norm``; drawn from ``generator`` on its device, into
    leaves from ``alloc`` where given (``layers.new_leaf``)."""
    _check_kind(kind)
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
                      use_flash: bool = False, shard: Optional[dict] = None,
                      mesh=None, finish: Optional[Callable] = None) -> Tensor:
    """Training / prefill attention (reference :153). x (B, S, E),
    positions (B or 1, S) → (B, S, E). "A"/"L": causal self-attention; an
    "L" layer sees its last ``cfg.sliding_window`` positions; with
    ``use_flash`` the attention goes through the flash wrapper (K3 on the
    card) unless the config soft-caps its logits. "X": attention over the
    image embeddings ``cross_kv`` (B, num_patches, vision_dim), no rotary
    positions, no mask, always the plain path (the reference passes no
    ``use_flash`` there, so even S == num_patches stays off K3).

    ``shard`` and ``mesh`` run the rank's slices (module docstring);
    ``finish(y, partial)`` finishes ``wo``'s output (default: a partial
    sum all-reduced over "model"). A config lever that names a mesh axis
    raises ``ValueError`` without a mesh that has it."""
    _check_kind(kind)
    check_levers(cfg, mesh)
    if kind == "X" and cross_kv is None:
        raise ValueError("a cross-attention ('X') layer needs cross_kv, the image "
                         "embeddings (B, num_patches, vision_dim)")
    if shard is not None and model_rank(mesh)[0] > 1:
        return _forward_local(params, x, cfg, kind, positions, shard, mesh,
                              cross_kv=cross_kv, use_flash=use_flash, finish=finish)
    if kind == "X":
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
                     start_pos: Optional[Tensor] = None, shard: Optional[dict] = None,
                     mesh=None) -> Tuple[Tensor, Optional[LayerKVCache]]:
    """Single-token decode over the ring-buffer cache (reference :192).
    x (B, 1, E) → ((B, 1, E), the cache, written in place). The token
    sits at position ``cache.length``; ``start_pos`` (B,) hides each
    lane's slots from before its own request. An "X" layer is stateless:
    it recomputes the image K/V from ``cross_kv`` and returns ``cache``
    untouched.

    Under a mesh (``shard``, ``mesh``) the rank decodes its rows and
    heads against what its cache holds (``cache.sharding``); a cache of a
    sequence slice goes through ``flash_decode``, which with
    ``start_pos`` raises ``ValueError`` (the reference's flash path drops
    the isolation)."""
    _check_kind(kind)
    check_levers(cfg, mesh)
    if kind == "X":
        return attention_forward(params, x, cfg, kind, None, cross_kv=cross_kv,
                                 shard=shard, mesh=mesh), cache
    if shard is not None and (model_rank(mesh)[0] > 1 or _cache_split(cache, mesh)):
        return _decode_local(params, x, cfg, kind, cache, shard, mesh, start_pos), cache
    q, k_new, v_new = _project_qkv(params, x, x, cfg)
    pos = cache.length.to(torch.int32).expand(x.shape[0], 1)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    window = cfg.sliding_window if kind == "L" else None
    cache = cache_write(cache, k_new, v_new)
    mask = valid_mask(cache, window, start_pos)  # (Sc,) or (B, Sc)
    out = _plain_decode(q, cache.k, cache.v, mask, cfg.attn_logit_softcap, x.dtype)
    return torch.einsum("bshd,hde->bse", out, params["wo"]), cache


def _plain_decode(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, softcap: float,
                  dtype) -> Tensor:
    """One token's attention over a whole cache k/v (B, Sc, Kv, D) with the
    visibility ``mask`` (Sc,) or (B, Sc): fp32 logits and softmax."""
    D = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    kk = torch.repeat_interleave(k, group, dim=2).to(torch.float32)  # (B, Sc, H, D)
    vv = torch.repeat_interleave(v, group, dim=2).to(torch.float32)
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kk) * (D ** -0.5)
    logits = _softcap(logits, softcap)
    mask = mask[:, None, None, :] if mask.ndim == 2 else mask[None, None, None, :]
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vv).to(dtype)


# --------------------------------------------------------------------------
# under a mesh: the rank's heads
# --------------------------------------------------------------------------

class _Heads:
    """The heads a rank computes with. ``q``: its query heads (every head
    with ``all_q``, or when ``wq`` is replicated). ``need``: the KV heads
    those read, (first, count). ``kv``: the KV heads it projects, (first,
    count): ``need``, or every head with ``all_kv``. ``expand``: None
    where ``q`` reads ``need`` in whole groups, else the KV head (from
    ``need``'s first) of each query head."""

    def __init__(self, cfg: ModelConfig, shard: dict, mesh, *, all_q: bool = False,
                 all_kv: bool = False):
        H, Kv = cfg.num_heads, cfg.num_kv_heads
        n, r = model_rank(mesh)
        self.q_sharded = shard["wq"].sharded_dim() is not None
        self.kv_sharded = shard["wk"].sharded_dim() is not None
        self.all_q, self.all_kv = all_q, all_kv or all_q
        self.q = range(r * H // n, (r + 1) * H // n) if self.q_sharded and not all_q \
            else range(H)
        group = H // Kv
        need = [h // group for h in self.q]
        self.need = (need[0], need[-1] - need[0] + 1)
        self.kv = (0, Kv) if self.all_kv else self.need
        per = len(self.q) // self.need[1] if len(self.q) % self.need[1] == 0 else 0
        whole = per and all(k - need[0] == i // per for i, k in enumerate(need))
        self.expand = None if whole else [k - need[0] for k in need]


def _project(params: dict, x: Tensor, kv_src: Tensor, cfg: ModelConfig, heads: _Heads,
             mesh) -> Tuple[Tensor, Tensor, Tensor]:
    """q of ``heads.q`` and k, v of ``heads.kv`` from the rank's leaves:
    its slices, or the columns it needs of a replicated ``wk``/``wv``;
    heads another rank holds are gathered over "model" (every rank then
    holds the same heads: "own" backward).

    The entries into the rank's region (``enter_model_region``, the sum of
    the ranks' partial gradients in the backward pass): x where q is the
    rank's heads; x (or the image embeddings) where k/v are, and then a
    replicated ``wk``/``wv``/``bk``/``bv`` of which the rank uses its query
    heads' part (Kv % n ≠ 0); the replicated q/k norm scales where they
    scale the rank's heads. Every rank's whole k/v (``all_kv`` with
    replicated leaves) is replicated work and enters nothing."""
    q_in = coll.enter_model_region(x, mesh) if heads.q_sharded else x
    kv_rank = heads.kv_sharded or (heads.q_sharded and not heads.all_kv)
    kv_in, w = kv_src, dict(params)
    if kv_rank:
        kv_in = q_in if kv_src is x else coll.enter_model_region(kv_src, mesh)
        if not heads.kv_sharded:  # replicated leaves, the rank's heads' part
            for name in ("wk", "wv", "bk", "bv", "k_norm"):
                if name in w:
                    w[name] = _enter_tree(w[name], mesh)
    if heads.q_sharded and "q_norm" in w:
        w["q_norm"] = _enter_tree(w["q_norm"], mesh)
    if heads.kv_sharded and "k_norm" in w:
        w["k_norm"] = _enter_tree(w["k_norm"], mesh)
    q = torch.einsum("bse,ehd->bshd", q_in, w["wq"])
    kv = slice(None) if heads.kv_sharded else slice(heads.kv[0], sum(heads.kv))
    k = torch.einsum("bse,ehd->bshd", kv_in, w["wk"][:, kv])
    v = torch.einsum("bse,ehd->bshd", kv_in, w["wv"][:, kv])
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"][kv], v + w["bv"][kv]
    if cfg.qk_norm:
        q = apply_norm(q, "rmsnorm", w["q_norm"])
        k = apply_norm(k, "rmsnorm", w["k_norm"])
    if heads.all_q and heads.q_sharded:
        q = coll.all_gather_dim(q, 2, mesh, backward="own")
    if heads.all_kv and heads.kv_sharded:
        k = coll.all_gather_dim(k, 2, mesh, backward="own")
        v = coll.all_gather_dim(v, 2, mesh, backward="own")
    return q, k, v


def _enter_tree(t, mesh):
    """``enter_model_region`` on a leaf or on each leaf of a norm's dict."""
    if isinstance(t, dict):
        return {k: coll.enter_model_region(v, mesh) for k, v in t.items()}
    return coll.enter_model_region(t, mesh)


def _needed(t: Tensor, heads: _Heads) -> Tensor:
    """The KV heads of ``t`` (holding ``heads.kv``) that ``heads.q`` read,
    one a query head where they are not whole groups."""
    lo = heads.need[0] - heads.kv[0]
    if lo or heads.need[1] != t.shape[2]:
        t = t[:, :, lo:lo + heads.need[1]]
    return t if heads.expand is None else t[:, :, heads.expand]


def _local_q_heads(out: Tensor, heads: _Heads, cfg: ModelConfig, mesh) -> Tensor:
    """The rank's query heads of an output over every head (the same on
    every rank: all-gather backward)."""
    if not (heads.all_q and heads.q_sharded):
        return out
    return coll.split_dim(out, 2, mesh)


def _out_proj(params: dict, out: Tensor, heads: _Heads, mesh,
              finish: Optional[Callable] = None) -> Tensor:
    """``wo`` on the rank's heads: a sharded ``wo`` gives a partial sum that
    one all-reduce over "model" finishes (or ``finish``)."""
    y = torch.einsum("bshd,hde->bse", out, params["wo"])
    if finish is not None:
        return finish(y, heads.q_sharded)
    return coll.all_reduce_sum(y, mesh) if heads.q_sharded else y


def _cache_split(cache: LayerKVCache, mesh) -> bool:
    """Whether a cache under a mesh needs the local decode at one rank of
    "model": it holds a sequence slice, or every row beside row-sharded
    tokens."""
    if cache.sharding is None:
        return False
    b_ax, s_ax = cache.sharding.entry(0), cache.sharding.entry(1)
    if s_ax:
        return True
    rows = batch_sharding(mesh, cache.k.shape[0], 1)
    return not b_ax and rows.n_shards > 1


def _forward_local(params: dict, x: Tensor, cfg: ModelConfig, kind: str,
                   positions: Optional[Tensor], shard: dict, mesh, *,
                   cross_kv: Optional[Tensor], use_flash: bool,
                   finish: Optional[Callable]) -> Tensor:
    """``attention_forward`` on the rank's heads (module docstring)."""
    n, r = model_rank(mesh)
    if kind == "X":
        heads = _Heads(cfg, shard, mesh)
        q, k, v = _project(params, x, cross_kv, cfg, heads, mesh)
        out = attention(q, _needed(k, heads), _needed(v, heads), causal=False, window=None,
                        softcap=cfg.attn_logit_softcap)
        return _out_proj(params, out, heads, mesh, finish)
    split = lever_axes(cfg.attn_q_seq_shard) and n > 1
    heads = _Heads(cfg, shard, mesh, all_q=bool(split))
    q, k, v = _project(params, x, x, cfg, heads, mesh)
    q = rope(q, positions, cfg.rope_theta).contiguous()  # K3 reads 16 bytes at a time
    k = _needed(rope(k, positions, cfg.rope_theta), heads).contiguous()
    v = _needed(v, heads).contiguous()
    window = cfg.sliding_window if kind == "L" else None
    kw = dict(causal=True, window=window, softcap=cfg.attn_logit_softcap, use_flash=use_flash)
    if not split:
        return _out_proj(params, attention(q, k, v, **kw), heads, mesh, finish)
    # the rank's query rows [a, b) against the keys they see, [a0, b): one
    # self-attention call over [a0, b) whose first a − a0 rows are dropped
    S = q.shape[1]
    a, b = split_rows(S, n, r)
    a0 = 0 if window is None else max(0, a - window + 1)
    # enter: every head's q, k, v (the same on every rank) meet the rank's rows
    q, k, v = (coll.enter_model_region(t, mesh) for t in (q, k, v))
    rows = attention(q[:, a0:b], k[:, a0:b], v[:, a0:b], **kw)[:, a - a0:]
    block = -(-S // n)
    if rows.shape[1] < block:  # an uneven split's short last blocks
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], block - rows.shape[1],
                                                *rows.shape[2:]))], dim=1)
    out = coll.all_gather_dim(rows, 1, mesh, backward="own")[:, :S]
    return _out_proj(params, _local_q_heads(out, heads, cfg, mesh), heads, mesh, finish)


def _decode_local(params: dict, x: Tensor, cfg: ModelConfig, kind: str,
                  cache: LayerKVCache, shard: dict, mesh, start_pos: Optional[Tensor]) -> Tensor:
    """One token on the rank's rows and heads against what its cache holds
    (``cache.sharding``, a spec (batch, sequence, heads, None)): its rows
    or every row, the whole sequence or a slice of it, the KV heads of
    its query heads (heads over "model") or every KV head. A sequence
    slice goes through ``flash_decode``; every query head then attends
    where the cache holds every KV head."""
    b_ax, s_ax, h_ax = (cache.sharding.entry(d) for d in range(3))
    seq_axes = lever_axes(s_ax)
    if seq_axes and start_pos is not None:
        raise ValueError("start_pos (continuous-batching isolation) with a sequence-sharded "
                         "cache: the reference's flash-decode path drops it; the port "
                         "refuses rather than drop it")
    full_kv = h_ax is None  # the cache holds every KV head
    heads = _Heads(cfg, shard, mesh, all_q=bool(seq_axes) and full_kv, all_kv=full_kv)
    q, k_new, v_new = _project(params, x, x, cfg, heads, mesh)
    # a cache of every row beside row-sharded tokens: attend every row
    rows_of = batch_sharding(mesh, cache.k.shape[0] * coll.axes_size(mesh, lever_axes(b_ax)), 1)
    gather_rows = not b_ax and rows_of.n_shards > 1
    if gather_rows:
        q, k_new, v_new = (coll.all_gather_dim(t, 0, mesh, rows_of.axes,
                                               backward="reduce_scatter")
                           for t in (q, k_new, v_new))
    pos = cache.length.to(torch.int32).expand(q.shape[0], 1)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    window = cfg.sliding_window if kind == "L" else None
    if seq_axes:
        out = coll.flash_decode(q, k_new, v_new, cache.k, cache.v, cache.pos, cache.length,
                                mesh=mesh, axis=seq_axes, window=window,
                                softcap=cfg.attn_logit_softcap)
        cache.length.add_(1)
    else:
        cache_write(cache, k_new, v_new)
        mask = valid_mask(cache, window, start_pos)
        out = _plain_decode(q, _needed(cache.k, heads), _needed(cache.v, heads), mask,
                            cfg.attn_logit_softcap, x.dtype)
    if gather_rows:
        out = out[rows_of.rows]
    return _out_proj(params, _local_q_heads(out, heads, cfg, mesh), heads, mesh)
