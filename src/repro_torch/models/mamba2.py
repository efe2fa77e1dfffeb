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

Under a mesh (``shard``, the layer's ``ParamSharding`` tree, and
``mesh``) a rank of the n ranks of "model" runs heads [r·H/n,
(r+1)·H/n): ``in_z``, ``in_x``, ``conv_x``, ``A_log``, ``D``,
``dt_bias`` and ``out`` are its slices; ``in_B``, ``in_C``, ``in_dt``,
``conv_B`` and ``conv_C`` are whole, and it takes the ``dt`` columns of
its heads and the B/C groups they read (every registered config has one
group), so K7 runs on the rank's heads unchanged. The gated RMSNorm
normalises over the whole d_inner: the rank's sum of squares is
all-reduced before the rsqrt, and it scales by its slice of the
replicated scale. ``out`` gives a partial sum (finished by
``finish``, an all-reduce over "model" by default). A split that cuts a
head, or heads that fall neither on whole groups nor inside one group,
raises ``ValueError``. The decode state holds the rank's rows, its x
channels (then every B/C channel) of ``conv`` and its heads of ``ssm``.
Under autograd the normed input, the replicated ``in_B``/``in_C``/
``in_dt``/``conv_B``/``conv_C``, the norm's summed squares and its scale
enter the rank's region (``enter_model_region``): their gradients are
the sums of the ranks' parts.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import MambaState, init_mamba_state
from repro_torch.models.layers import apply_norm, dense_init, draws_from, init_norm, new_leaf
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import model_rank

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


def _project(params: dict, x: Tensor, heads: slice = slice(None)):
    """z, x, B, C and dt (fp32) of x; ``heads``: the dt columns of a rank's
    heads (``in_dt`` is whole under a mesh, ``dt_bias`` the rank's)."""
    z = x @ params["in_z"]
    xs = x @ params["in_x"]
    Bm = x @ params["in_B"]
    C = x @ params["in_C"]
    dt = _softplus((x @ params["in_dt"][:, heads]).float() + params["dt_bias"])  # fp32
    return z, xs, Bm, C, dt


def mamba_forward(params: dict, x: Tensor, cfg: ModelConfig, *,
                  use_kernel: bool = True, shard: Optional[dict] = None, mesh=None,
                  finish: Optional[Callable] = None) -> Tensor:
    """Prefill: x (B, S, E) → (B, S, E); under a mesh on the rank's heads
    (module docstring)."""
    local = _local_heads(cfg, shard, mesh)
    if local is not None:
        return _forward_local(params, x, cfg, local, use_kernel, mesh, finish)
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


def mamba_decode(params: dict, x: Tensor, cfg: ModelConfig, state: MambaState, *,
                 shard: Optional[dict] = None, mesh=None) -> Tuple[Tensor, MambaState]:
    """One token: x (B, 1, E) → ((B, 1, E), state'); under a mesh on the
    rank's heads, with its local state (module docstring)."""
    local = _local_heads(cfg, shard, mesh)
    if local is not None:
        return _decode_local(params, x, cfg, state, local, mesh)
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


def init_mamba_decode_state(cfg: ModelConfig, batch: int, device="cuda", *,
                            heads: Optional[int] = None) -> MambaState:
    """A zero decode state on ``device`` (the card unless the caller asks
    for the CPU; raises without a card, as ``resolve_device`` does) of
    ``batch`` rows; ``heads`` of the H heads (a rank's, under a mesh: the
    conv state then holds their x channels and every B/C channel)."""
    mc = cfg.mamba
    E = cfg.d_model
    H, N, P = mc.num_heads(E), mc.d_state, mc.head_dim
    h = H if heads is None else heads
    channels = h * P + 2 * mc.n_groups * N
    return init_mamba_state(batch, mc.conv_width, channels, h, N, P, _dtype(cfg),
                            resolve_device(device))


# --------------------------------------------------------------------------
# under a mesh: the rank's heads
# --------------------------------------------------------------------------

class _Local:
    """A rank's heads [h0, h0 + h) of H and the B/C groups [g0, g0 + g)
    they read; ``n`` ranks of "model"."""

    def __init__(self, h0, h, g0, g, n):
        self.h0, self.h, self.g0, self.g, self.n = h0, h, g0, g, n


def _local_heads(cfg: ModelConfig, shard: Optional[dict], mesh) -> Optional[_Local]:
    """The rank's heads under a mesh whose "model" axis splits them; None
    where the layer runs whole (no mesh, one rank of "model", or every
    leaf replicated because the ranks do not divide d_inner)."""
    if shard is None:
        return None
    n, r = model_rank(mesh)
    if n == 1:
        return None
    mc = cfg.mamba
    H, G = mc.num_heads(cfg.d_model), mc.n_groups
    x_split = shard["in_x"].sharded_dim() is not None
    h_split = shard["A_log"].sharded_dim() is not None
    if not x_split and not h_split:
        return None
    if not (x_split and h_split):
        raise ValueError(f"{n} ranks of 'model' split d_inner {mc.d_inner(cfg.d_model)} "
                         f"but not its {H} heads: the split would cut a head")
    h = H // n
    per = H // G  # heads a group
    if h % per == 0:
        g0, g = r * h // per, h // per
    elif per % h == 0:
        g0, g = r * h // per, 1
    else:
        raise ValueError(f"{h} heads a rank fall neither on whole SSD groups of {per} heads "
                         f"nor inside one group")
    return _Local(r * h, h, g0, g, n)


def _groups(t: Tensor, loc: _Local, N: int) -> Tensor:
    """The channels of the rank's groups of a (..., G·N) B or C."""
    if loc.g * N == t.shape[-1]:
        return t
    return t[..., loc.g0 * N:(loc.g0 + loc.g) * N].contiguous()


def _gated_norm(y: Tensor, z: Tensor, params: dict, di: int, loc: _Local, mesh,
                eps: float = 1e-6) -> Tensor:
    """RMSNorm of y·silu(z) over the whole d_inner from the rank's channels:
    the sum of squares all-reduced over "model", the rank's slice of the
    scale."""
    g = y * F.silu(z)
    gf = g.to(torch.float32)
    # the summed squares (replicated) scale the rank's channels: enter
    ss = coll.enter_model_region(
        coll.all_reduce_sum((gf * gf).sum(dim=-1, keepdim=True), mesh), mesh)
    lo = loc.h0 * (g.shape[-1] // loc.h)
    # enter: the rank's slice of the replicated scale
    scale = coll.enter_model_region(params["norm"]["scale"], mesh)[lo:lo + g.shape[-1]]
    return (gf * torch.rsqrt(ss / di + eps) * scale.to(torch.float32)).to(g.dtype)


def _finish(y: Tensor, mesh, finish: Optional[Callable]) -> Tensor:
    return finish(y, True) if finish is not None else coll.all_reduce_sum(y, mesh)


def _regional(params: dict, mesh) -> dict:
    """The layer's leaves with the replicated ones the rank uses only for
    its heads (``in_B``, ``in_C``, ``in_dt``: its heads' columns,
    ``conv_B``, ``conv_C``) entering the rank's region: their gradients
    are the sums of the ranks' parts."""
    out = dict(params)
    for name in ("in_B", "in_C", "in_dt", "conv_B", "conv_C"):
        out[name] = coll.enter_model_region(params[name], mesh)
    return out


def _forward_local(params: dict, x: Tensor, cfg: ModelConfig, loc: _Local, use_kernel: bool,
                   mesh, finish: Optional[Callable]) -> Tensor:
    mc = cfg.mamba
    B, S, E = x.shape
    P, N = mc.head_dim, mc.d_state
    # enter: the normed x meets the rank's heads (all five projections)
    x = coll.enter_model_region(x, mesh)
    params = _regional(params, mesh)
    z, xs, Bm, C, dt = _project(params, x, slice(loc.h0, loc.h0 + loc.h))
    xs = F.silu(_causal_conv(xs, params["conv_x"]))
    Bm = _groups(F.silu(_causal_conv(Bm, params["conv_B"])), loc, N)
    C = _groups(F.silu(_causal_conv(C, params["conv_C"])), loc, N)
    xh = xs.reshape(B, S, loc.h, P)
    Bh, Ch = Bm.reshape(B, S, loc.g, N), C.reshape(B, S, loc.g, N)
    A = -torch.exp(params["A_log"])
    if use_kernel:
        y = ssd_ops.ssd_scan(xh, dt, A, Bh, Ch)
    else:
        y = ssd_ref.ssd_chunked(xh, dt, A, Bh, Ch)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(B, S, loc.h * P).to(x.dtype)
    y = _gated_norm(y, z, params, mc.d_inner(E), loc, mesh)
    return _finish(y @ params["out"], mesh, finish)


def _decode_local(params: dict, x: Tensor, cfg: ModelConfig, state: MambaState, loc: _Local,
                  mesh) -> Tuple[Tensor, MambaState]:
    mc = cfg.mamba
    B, _, E = x.shape
    P, G, N = mc.head_dim, mc.n_groups, mc.d_state
    dl = loc.h * P
    z, xs, Bm, C, dt = _project(params, x[:, 0, :], slice(loc.h0, loc.h0 + loc.h))
    ch = torch.cat([xs, Bm, C], dim=-1)  # (B, di_local + 2GN)
    conv_w = torch.cat([params["conv_x"], params["conv_B"], params["conv_C"]], dim=1)
    conv_state, conv_out = _conv_step(state.conv, ch, conv_w)
    conv_out = F.silu(conv_out)
    xs, Bm, C = torch.split(conv_out, [dl, G * N, G * N], dim=-1)
    xh = xs.reshape(B, loc.h, P)
    rep = loc.h // loc.g
    Bh = torch.repeat_interleave(_groups(Bm, loc, N).reshape(B, loc.g, N), rep, dim=1)
    Ch = torch.repeat_interleave(_groups(C, loc, N).reshape(B, loc.g, N), rep, dim=1)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)
    ssm = state.ssm * a[..., None, None] + (
        dt[..., None, None] * Bh[..., :, None].float() * xh[..., None, :].float())
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), ssm)
    y = y + params["D"][None, :, None] * xh.float()
    y = y.reshape(B, dl).to(x.dtype)
    y = _gated_norm(y, z, params, mc.d_inner(E), loc, mesh)
    out = coll.all_reduce_sum(y @ params["out"], mesh)[:, None, :]
    return out, MambaState(conv=conv_state, ssm=ssm)
