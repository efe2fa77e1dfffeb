"""The attention owner; port of ``repro/models/attention.py`` (``attention``
and ``_ref_attention``; the LM-stack mixers are not ported yet).

``attention`` is the single place that decides between the plain path
and the flash kernel (DESIGN.md §13), with the reference's fallback
rules: ``softcap > 0`` and cross-length q/k always take the plain path.
Its public face is the model layout (B, S, H, D).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash

Tensor = torch.Tensor


def _ref_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                   window: Optional[int], softcap: float) -> Tensor:
    """(B, S, H, D) × (B, Sk, Kv, D) GQA attention with an fp32 softmax."""
    B, S, H, D = q.shape
    Kv, Sk = k.shape[2], k.shape[1]
    group = H // Kv
    kk = torch.repeat_interleave(k, group, dim=2).to(torch.float32)
    vv = torch.repeat_interleave(v, group, dim=2).to(torch.float32)
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kk) * (D ** -0.5)
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
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
