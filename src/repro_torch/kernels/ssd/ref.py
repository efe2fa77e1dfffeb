"""Plain PyTorch versions of the Mamba2 SSD scan; port of
``repro/kernels/ssd/ref.py``.

``ssd_scan`` is the exact sequential recurrence, the oracle, in the
reference kernel's layout: x (B,H,S,P), dt (B,H,S), A (H,),
Bm (B,G,S,N), C (B,G,S,N), H % G == 0. Per head h with group
g = h // (H//G):

  a_t     = exp(dt_t · A_h)
  state_t = a_t · state_{t-1} + dt_t · B_t ⊗ x_t        (N, P)
  y_t     = C_tᵀ state_t                                 (P,)

It returns (y (B,H,S,P), final_state (B,H,N,P) fp32).

``ssd_chunked`` is the same function in chunks of Q, in the model's
layout x (B,S,H,P), dt (B,S,H), Bm/C (B,S,G,N). With L the
within-chunk cumulative sum of dt·A (every entry ≤ 0):

  Y_intra[t] = Σ_{s≤t} e^{L_t−L_s} (C_t·B_s) dt_s x_s
  Y_inter[t] = e^{L_t} C_t · state
  state'     = e^{L_Q} state + Σ_s e^{L_Q−L_s} dt_s B_s ⊗ x_s

S is padded to the chunk with dt = 0 (decay 1, no injection). The
cross-chunk recurrence is a loop over the chunks where the reference
uses ``associative_scan``: the same function, rounded in another order.
The D skip and the gating are the model layer's, not the scan's. All
math is fp32; y is returned in x's dtype.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, C: Tensor):
    B, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    group = H // G
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = torch.repeat_interleave(Bm.float(), group, dim=1)  # (B,H,S,N)
    Ch = torch.repeat_interleave(C.float(), group, dim=1)
    state = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, :, t] * Af)  # (B,H)
        state = (a[..., None, None] * state
                 + dtf[:, :, t, None, None] * Bh[:, :, t, :, None] * xf[:, :, t, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, :, t], state))
    return torch.stack(ys, dim=2).to(x.dtype), state


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, C: Tensor,
                chunk: int = 128, return_state: bool = False):
    """y (B,S,H,P) in x's dtype, and with ``return_state`` also the state
    after the last position, (B,H,N,P) fp32."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    group = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    Sp = x.shape[1]
    nc = Sp // Q

    xf = x.float().reshape(B, nc, Q, H, P)
    dtf = dt.float().reshape(B, nc, Q, H)
    Bf = torch.repeat_interleave(Bm.float(), group, dim=2).reshape(B, nc, Q, H, N)
    Cf = torch.repeat_interleave(C.float(), group, dim=2).reshape(B, nc, Q, H, N)

    l = dtf * A.float()  # (B,nc,Q,H) ≤ 0
    Lc = torch.cumsum(l, dim=2)
    Ltot = Lc[:, :, -1, :]  # (B,nc,H)

    # intra-chunk: (M ⊙ C Bᵀ)(dt·x), exponentiating only s ≤ t
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cf, Bf)  # (B,nc,H,Q,Q)
    Lh = Lc.permute(0, 1, 3, 2)  # (B,nc,H,Q)
    seg = Lh[..., :, None] - Lh[..., None, :]  # L_t − L_s
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    M = torch.where(tri, torch.exp(seg.masked_fill(~tri, 0.0)), 0.0)
    dx = dtf[..., None] * xf  # (B,nc,Q,H,P)
    y = torch.einsum("bchqk,bckhp->bcqhp", scores * M, dx)

    # per-chunk state injection and decay
    w = torch.exp(Ltot[:, :, None, :] - Lc) * dtf  # (B,nc,Q,H)
    inj = torch.einsum("bcqhn,bcqh,bcqhp->bchnp", Bf, w, xf)  # (B,nc,H,N,P)
    decay = torch.exp(Ltot)  # (B,nc,H)

    # cross-chunk recurrence s_c = decay_c · s_{c-1} + inj_c; chunk c
    # reads the state entering it
    state = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = decay[:, c, :, None, None] * state + inj[:, c]
    state_in = torch.stack(state_in, dim=1)  # (B,nc,H,N,P)
    y = y + torch.exp(Lc)[..., None] * torch.einsum("bcqhn,bchnp->bcqhp", Cf, state_in)

    y = y.reshape(B, Sp, H, P)[:, :S].to(x.dtype)
    return (y, state) if return_state else y


def _sums_after(l: Tensor) -> Tensor:
    """Σ_{q>s} l_q along dim 2, each a sum of the terms it covers."""
    incl = torch.flip(torch.cumsum(torch.flip(l, [2]), dim=2), [2])
    return torch.cat([incl[:, :, 1:], torch.zeros_like(incl[:, :, :1])], dim=2)


def ssd_ranges(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, C: Tensor, *,
               chunk: int = 64, ranges: int = 1, return_state: bool = False):
    """``ssd_chunked`` in the CUDA kernel's decomposition (tests only; the
    main path runs ``ssd_chunked`` or the kernel).

    C·Bᵀ once a (sample, chunk, group) on its causal half; each (b, h)
    sequence split into ``ranges`` ranges of whole chunks, range r holding
    chunks [r·nc/R, (r+1)·nc/R) with R = min(ranges, nc); pass 1, each
    range but the last from a zero state (the update product only), its
    local state and its decay Π e^{L_Q}; pass 2, the state entering each
    range, in range order, state_in_r = decay_{r−1}·state_in_{r−1} +
    local_{r−1}; pass 3, every range's chunks from the state entering it.
    The exponents are formed as the kernel forms them (sums of the rows
    they cover, never the difference of two sums over many rows). Same
    layouts and results as ``ssd_chunked``."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    group = H // G
    Q = chunk
    if Q % 16:
        raise ValueError(f"chunk must be a multiple of 16 (the kernel's row tile), got {Q}")
    nc = -(-S // Q)
    R = min(ranges, nc)
    pad = nc * Q - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    xf = x.float().reshape(B, nc, Q, H, P)
    dtf = dt.float().reshape(B, nc, Q, H)
    Bf = Bm.float().reshape(B, nc, Q, G, N)
    Cf = C.float().reshape(B, nc, Q, G, N)

    l = dtf * A.float()  # (B,nc,Q,H) ≤ 0
    Lc = torch.cumsum(l, dim=2)  # L_t, for e^{L_t}
    after = _sums_after(l)  # Σ_{q>s} l_q
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    # C·Bᵀ once a group, causal half; then per head the decay and dt_s
    cb = torch.einsum("bcqgn,bckgn->bcgqk", Cf, Bf).masked_fill(~tri, 0.0)
    cb = torch.repeat_interleave(cb, group, dim=2)  # (B,nc,H,Q,Q)
    # L_t − L_s = S_s − S_t with S_r the sum over the rows after r up to
    # the end of t's 16-row tile, as the kernel forms it: never a
    # difference of two sums over many rows
    seg = torch.empty(B, nc, H, Q, Q, dtype=torch.float32, device=x.device)
    for e in range(16, Q + 16, 16):
        to_end = _sums_after(l[:, :, :e]).permute(0, 1, 3, 2)  # (B,nc,H,e)
        seg[..., e - 16:e, :e] = to_end[..., None, :] - to_end[..., e - 16:e, None]
        seg[..., e - 16:e, e:] = 0.0
    seg = seg.masked_fill(~tri, 0.0)
    m = torch.where(tri, cb * torch.exp(seg), 0.0) * dtf.permute(0, 1, 3, 2)[..., None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", m, xf)
    # the update of each chunk, and its decay
    Bh = torch.repeat_interleave(Bf, group, dim=3)  # (B,nc,Q,H,N)
    Ch = torch.repeat_interleave(Cf, group, dim=3)
    w = torch.exp(after) * dtf  # (B,nc,Q,H)
    inj = torch.einsum("bcqhn,bcqhp->bchnp", Bh * w[..., None], xf)  # (B,nc,H,N,P)
    decay = torch.exp(Lc[:, :, -1, :])  # (B,nc,H)

    bounds = [r * nc // R for r in range(R + 1)]
    zero = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)

    def run(state, r):
        """The chunks of range r from ``state``: the states entering them
        and the state after the last."""
        entering = []
        for c in range(bounds[r], bounds[r + 1]):
            entering.append(state)
            state = decay[:, c, :, None, None] * state + inj[:, c]
        return entering, state

    # pass 1: each range but the last from zero, and its decay
    local, range_decay = [], []
    for r in range(R - 1):
        local.append(run(zero, r)[1])
        d = torch.ones(B, H, dtype=torch.float32, device=x.device)
        for c in range(bounds[r], bounds[r + 1]):
            d = d * decay[:, c]
        range_decay.append(d)
    # pass 2: the state entering each range, in range order
    state_in = [zero]
    for r in range(1, R):
        state_in.append(range_decay[r - 1][..., None, None] * state_in[r - 1] + local[r - 1])
    # pass 3: every range from the state entering it
    entering = []
    for r in range(R):
        e, state = run(state_in[r], r)
        entering += e
    entering = torch.stack(entering, dim=1)  # (B,nc,H,N,P)
    y = y_intra + torch.exp(Lc)[..., None] * torch.einsum("bcqhn,bchnp->bcqhp", Ch, entering)
    y = y.reshape(B, nc * Q, H, P)[:, :S].to(x.dtype)
    return (y, state) if return_state else y
