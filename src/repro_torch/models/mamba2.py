"""Mamba2 (SSD) mixer layer; port of ``repro/models/mamba2.py``.

Follows arXiv:2405.21060 with the reference's split projections: the
fused ``in_proj`` is separate z/x/B/C/dt products (the reference splits
it so a tensor-parallel axis can shard z and x on head boundaries; the
math is the fused projection's).

Sequence mixing runs through the chunked SSD scan: by default
(``use_kernel=True``) through ``kernels.ssd.ops.ssd_scan`` (K7 on CUDA
tensors, its plain version on CPU tensors, the same bits as
``use_kernel=False`` there), with ``use_kernel=False`` through the plain
``kernels.ssd.ref.ssd_chunked``, after short causal depthwise
convolutions on x, B and C. Decode keeps a (conv, ssm) recurrent state:
O(1) per token.

Parameters are a dict of tensors with the reference's keys and layouts,
so ``transformer.params_from_jax`` copies a reference tree leaf by leaf.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import MambaState, init_mamba_state
from repro_torch.models.layers import apply_norm, dense_init, draws_from, init_norm, new_leaf

Tensor = torch.Tensor


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_mamba(cfg: ModelConfig, generator: torch.Generator, alloc=None) -> dict:
    """Fresh parameters on the generator's device, drawn from it, into
    leaves from ``alloc`` where given (``layers.new_leaf``)."""
    mc = cfg.mamba
    E = cfg.d_model
    di = mc.d_inner(E)
    H = mc.num_heads(E)
    G, N, W = mc.n_groups, mc.d_state, mc.conv_width
    dtype = _dtype(cfg)
    dev = generator.device
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba default)
    u = torch.rand(H, generator=draws_from(generator), device=dev)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    d = lambda shape, fan_in=None: dense_init(shape, generator=generator, dtype=dtype,
                                              fan_in=fan_in, alloc=alloc)
    f32 = lambda: new_leaf(alloc, (H,), torch.float32, dev)
    return {
        "in_z": d((E, di)),
        "in_x": d((E, di)),
        "in_B": d((E, G * N)),
        "in_C": d((E, G * N)),
        "in_dt": d((E, H)),
        "conv_x": d((W, di), W),
        "conv_B": d((W, G * N), W),
        "conv_C": d((W, G * N), W),
        "A_log": f32().copy_(torch.log(torch.linspace(1.0, 16.0, H, device=dev))),
        "D": f32().fill_(1),
        "dt_bias": f32().copy_(dt_bias),
        "norm": init_norm(di, "rmsnorm", dtype, dev, alloc),
        "out": d((di, E)),
    }


def _causal_conv(x: Tensor, w: Tensor) -> Tensor:
    """Depthwise causal conv along the sequence, x (B, S, C), w (W, C);
    the taps are summed in the reference's order, i = 0 … W−1."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def _conv_step(state: Tensor, x_new: Tensor, w: Tensor) -> Tuple[Tensor, Tensor]:
    """One token of the conv: state (B, W−1, C), x_new (B, C) →
    (state', y (B, C)), taps summed in order."""
    full = torch.cat([state, x_new[:, None, :]], dim=1)  # (B, W, C)
    y = full[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        y = y + full[:, i] * w[i]
    return full[:, 1:], y


def _softplus(v: Tensor) -> Tensor:
    """jax.nn.softplus, log(1 + e^v) = logaddexp(v, 0), with no threshold."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))


def _project(params: dict, x: Tensor):
    z = x @ params["in_z"]
    xs = x @ params["in_x"]
    Bm = x @ params["in_B"]
    C = x @ params["in_C"]
    dt = _softplus((x @ params["in_dt"]).float() + params["dt_bias"])  # fp32
    return z, xs, Bm, C, dt


def mamba_forward(params: dict, x: Tensor, cfg: ModelConfig, *,
                  use_kernel: bool = True) -> Tensor:
    """Prefill: x (B, S, E) → (B, S, E)."""
    mc = cfg.mamba
    B, S, E = x.shape
    di = mc.d_inner(E)
    H, P, G, N = mc.num_heads(E), mc.head_dim, mc.n_groups, mc.d_state

    z, xs, Bm, C, dt = _project(params, x)
    xs = F.silu(_causal_conv(xs, params["conv_x"]))
    Bm = F.silu(_causal_conv(Bm, params["conv_B"]))
    C = F.silu(_causal_conv(C, params["conv_C"]))

    xh = xs.reshape(B, S, H, P)
    Bh = Bm.reshape(B, S, G, N)
    Ch = C.reshape(B, S, G, N)
    A = -torch.exp(params["A_log"])  # (H,) < 0

    if use_kernel:
        y = ssd_ops.ssd_scan(xh, dt, A, Bh, Ch)
    else:
        y = ssd_ref.ssd_chunked(xh, dt, A, Bh, Ch)

    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(B, S, di).to(x.dtype)  # D is fp32; back to the compute dtype
    y = apply_norm(y * F.silu(z), "rmsnorm", params["norm"])
    return y @ params["out"]


def mamba_decode(params: dict, x: Tensor, cfg: ModelConfig,
                 state: MambaState) -> Tuple[Tensor, MambaState]:
    """One token: x (B, 1, E) → ((B, 1, E), state')."""
    mc = cfg.mamba
    B, _, E = x.shape
    di = mc.d_inner(E)
    H, P, G, N = mc.num_heads(E), mc.head_dim, mc.n_groups, mc.d_state

    z, xs, Bm, C, dt = _project(params, x[:, 0, :])
    ch = torch.cat([xs, Bm, C], dim=-1)  # (B, di + 2GN)
    conv_w = torch.cat([params["conv_x"], params["conv_B"], params["conv_C"]], dim=1)
    conv_state, conv_out = _conv_step(state.conv, ch, conv_w)
    conv_out = F.silu(conv_out)
    xs, Bm, C = torch.split(conv_out, [di, G * N, G * N], dim=-1)

    xh = xs.reshape(B, H, P)
    Bh = torch.repeat_interleave(Bm.reshape(B, G, N), H // G, dim=1)  # (B, H, N)
    Ch = torch.repeat_interleave(C.reshape(B, G, N), H // G, dim=1)
    A = -torch.exp(params["A_log"])

    a = torch.exp(dt * A)  # (B, H)
    ssm = state.ssm * a[..., None, None] + (
        dt[..., None, None] * Bh[..., :, None].float() * xh[..., None, :].float())
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), ssm)
    y = y + params["D"][None, :, None] * xh.float()
    y = y.reshape(B, di).to(x.dtype)
    y = apply_norm(y * F.silu(z), "rmsnorm", params["norm"])
    out = (y @ params["out"])[:, None, :]
    return out, MambaState(conv=conv_state, ssm=ssm)


def init_mamba_decode_state(cfg: ModelConfig, batch: int, device="cuda") -> MambaState:
    """A zero decode state on ``device`` (the card unless the caller asks
    for the CPU; raises without a card, as ``resolve_device`` does)."""
    mc = cfg.mamba
    E = cfg.d_model
    di = mc.d_inner(E)
    H, N, P = mc.num_heads(E), mc.d_state, mc.head_dim
    channels = di + 2 * mc.n_groups * N
    return init_mamba_state(batch, mc.conv_width, channels, H, N, P, _dtype(cfg),
                            resolve_device(device))
