"""Plain PyTorch version of flash attention; port of
``repro/kernels/flash_attention/ref.py``.

q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0 (GQA: head h
reads kv head h // (Hq/Hkv)). ``window`` W lets position i see
[i − W + 1, i] (with ``causal``; without it, keys after i stay visible).
Keys at or past ``true_len`` are masked. Softmax in fp32, output in q's
dtype. A row with no visible key is NaN here; the kernel returns 0 for
it (the reference kernel's l == 0 guard).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: int | None = None, scale: float | None = None,
              true_len: int | None = None) -> Tensor:
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {Hkv}")
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kk = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if true_len is not None:
        mask &= kpos < true_len
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv)
    return out.to(q.dtype)
