"""Decode state of the language models; port of
``repro/models/kvcache.py``: the attention layers' ring-buffer KV cache
(``LayerKVCache``, ``init_kv_cache``, ``cache_write``, ``valid_mask``;
reference :25, :32, :41, :51) and the Mamba2 layers' recurrent state
(``MambaState``, ``init_mamba_state``).

The KV cache is a ring buffer: a token goes to slot = position mod
S_cache, and ``pos`` records the absolute position each slot holds (−1
empty), so the mask stays exact after wrap-around. A cache at least as
long as the sequence never wraps. The batch decodes in lockstep, so
``pos`` and ``length`` are shared by the batch; ``length`` is a device
scalar, and the slot is computed on the device, so a step reads nothing
back to the host.

Unlike the reference's functional update, ``cache_write`` writes the
slot in place (``index_copy_`` at a tensor index) and returns the same
cache: a decode step then copies one token's k/v a layer, not the
cache. A caller passes each decode state to one step only. Under a mesh
a cache holds a rank's block and says which (``sharding``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class LayerKVCache:
    k: Tensor       # (B, S_cache, Kv, Dh)
    v: Tensor       # (B, S_cache, Kv, Dh)
    pos: Tensor     # (S_cache,) int32: absolute position held by each slot, -1 empty
    length: Tensor  # () int32: tokens seen so far
    #: under a mesh, how the global (B, S_cache, Kv, Dh) cache lies over the
    #: ranks (a ``parallel.sharding.ParamSharding``): k/v/pos then hold this
    #: rank's block; None for a whole cache
    sharding: Optional[object] = None


def init_kv_cache(batch: int, cache_len: int, kv_heads: int, head_dim: int,
                  dtype=torch.float32, device="cpu") -> LayerKVCache:
    return LayerKVCache(
        k=torch.zeros(batch, cache_len, kv_heads, head_dim, dtype=dtype, device=device),
        v=torch.zeros(batch, cache_len, kv_heads, head_dim, dtype=dtype, device=device),
        pos=torch.full((cache_len,), -1, dtype=torch.int32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def cache_write(cache: LayerKVCache, k_new: Tensor, v_new: Tensor) -> LayerKVCache:
    """Write one token's k/v (B, 1, Kv, Dh) at slot = length mod S_cache,
    record its position and advance ``length``, all in place."""
    slot = torch.remainder(cache.length, cache.k.shape[1]).view(1).long()
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    cache.pos.index_copy_(0, slot, cache.length.view(1))
    cache.length.add_(1)
    return cache


def valid_mask(cache: LayerKVCache, window: Optional[int],
               start_pos: Optional[Tensor] = None) -> Tensor:
    """Which slots the newest (just written) token sees: (S_cache,) bool,
    or (B, S_cache) when ``start_pos`` (B,) is given, each lane seeing
    only positions at or after its own request's start (continuous
    batching, ``serving.scheduler.ContinuousBatcher``)."""
    cur = cache.length - 1  # position of the newest token
    m = (cache.pos >= 0) & (cache.pos <= cur)
    if window is not None:
        m = m & (cache.pos > cur - window)
    if start_pos is not None:
        m = m[None, :] & (cache.pos[None, :] >= start_pos[:, None])
    return m


@dataclasses.dataclass
class MambaState:
    conv: Tensor  # (B, conv_width-1, channels) rolling conv inputs, model dtype
    ssm: Tensor   # (B, H, N, P) fp32 recurrent state


def init_mamba_state(batch: int, conv_width: int, channels: int, heads: int,
                     d_state: int, head_dim: int, dtype=torch.float32,
                     device="cpu") -> MambaState:
    return MambaState(
        conv=torch.zeros(batch, conv_width - 1, channels, dtype=dtype, device=device),
        ssm=torch.zeros(batch, heads, d_state, head_dim, dtype=torch.float32,
                        device=device),
    )
