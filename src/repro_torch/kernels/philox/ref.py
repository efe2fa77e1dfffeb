"""Plain PyTorch version of P1, the per-row Philox normals (no reference
counterpart: the reference draws a slot's noise with XLA's threefry,
``_draw_noise`` in ``repro/core/solvers/adaptive.py``).

``philox_words(seed, counter, D)`` is Philox4x32-10 (Salmon et al., SC'11)
in int64 torch ops on (B,) int64 ``seed`` and ``counter``: row i, words
4·j4 .. 4·j4 + 3, is the block cipher of counter (j4, 0, counter_i low,
counter_i high) under key (seed_i low, seed_i high), as uint32 values in
int64. The 32×32-bit products are taken in 16-bit halves, so no
intermediate leaves int64. ``philox_normal`` turns each pair of words into
two normals by Box–Muller in fp32, in the kernel's order of rounding:
u = ((w >> 8) + 0.5)·2⁻²⁴, r = sqrt(−2 log u0), θ = 2π·u1, (r cos θ,
r sin θ). Rows with seed < 0 (idle slots) are 0. What
``csrc/philox_normal.cu`` computes, and what the wrapper runs for CPU
tensors.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: Tensor):
    """(low, high) 32 bits of the 64-bit product of the constant ``a`` and
    the uint32 values ``b`` (int64 tensor)."""
    pl = a * (b & 0xFFFF)           # < 2^48
    ph = a * (b >> 16)              # < 2^48
    mid = pl + ((ph & 0xFFFF) << 16)
    return mid & _MASK, (ph >> 16) + (mid >> 32)


def philox4x32_10(c0: Tensor, c1: Tensor, c2: Tensor, c3: Tensor, k0: Tensor,
                  k1: Tensor):
    """The four output words of Philox4x32-10 for counters (c0..c3) and
    keys (k0, k1): uint32 values in broadcastable int64 tensors."""
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & _MASK, (k1 + W1) & _MASK
        lo0, hi0 = _mulhilo(M0, c0)
        lo1, hi1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(seed: Tensor, counter: Tensor, D: int) -> Tensor:
    """(B, D) int64: the first D uint32 words of each row's stream; rows of
    a negative seed are 0."""
    seed, counter = seed.to(torch.int64), counter.to(torch.int64)
    groups = -(-int(D) // 4)
    j = torch.arange(groups, dtype=torch.int64, device=seed.device)[None, :]
    col = lambda v: v[:, None].expand(-1, groups)
    c2, c3 = col(counter & _MASK), col((counter >> 32) & _MASK)
    k0, k1 = col(seed & _MASK), col((seed >> 32) & _MASK)
    words = philox4x32_10(j.expand(seed.shape[0], -1), torch.zeros_like(c2), c2, c3, k0, k1)
    w = torch.stack(words, dim=-1).reshape(seed.shape[0], 4 * groups)[:, :D]
    return torch.where((seed >= 0)[:, None], w, 0)


def _uniform(w: Tensor) -> Tensor:
    return ((w >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def philox_normal(seed: Tensor, counter: Tensor, D: int) -> Tensor:
    """(B, D) fp32 standard normals of each row's stream; rows of a
    negative seed are 0."""
    B = seed.shape[0]
    groups = -(-int(D) // 4)
    w = philox_words(seed, counter, 4 * groups).reshape(B, groups, 2, 2)
    two_pi = torch.full((), 6.2831853071795864769, dtype=torch.float32, device=w.device)
    r = torch.sqrt(-2.0 * torch.log(_uniform(w[..., 0])))
    theta = two_pi * _uniform(w[..., 1])
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    z = z.reshape(B, 4 * groups)[:, :D]
    return torch.where((seed >= 0)[:, None].to(z.device), z, 0.0)
