"""Score networks of the paper's own family; port of
``repro/models/score_unet.py``: an MLP score net for low-dimensional
problems and a compact NCSN++-style image UNet (time conditioning in
every residual block, a down/up path with skips, GroupNorm + SiLU).

Both are ``nn.Module``s whose parameters keep the reference's layouts:
the MLP's dense weights are (in, out) and used as ``x @ w``; the UNet
takes NHWC images and stores HWIO convolution kernels, which the forward
hands to ``F.conv2d`` as OIHW views on NCHW activations.
``params_from_jax`` copies a reference parameter tree in as it is.

Two details of the reference that a direct translation gets wrong:

* XLA's "SAME" padding is asymmetric where the stride does not divide
  the kernel's overhang: a 3×3 stride-2 convolution at H = 32 pads
  (0, 1), not (1, 1). ``same_pad`` computes XLA's rule per axis, and
  ``conv`` pads with it explicitly.
* ``_groupnorm`` is plain arithmetic in fp32 with the biased variance and
  eps = 1e-6 (not ``F.group_norm``'s 1e-5), and the up path's resize is
  nearest-neighbour at 2×, a repeat of every pixel.

The MLP's last layer and the UNet's ``conv2`` and ``conv_out`` start at
zero, as in the reference, so a fresh net's score is exactly 0.

Precision: both forwards take ``policy=`` to run activations and the
weight copies they consume in ``policy.compute``; the timestep MLP runs
in fp32 from the stored weights and GroupNorm takes fp32 statistics.
``make_score_fn`` divides by std(t) in fp32 (noise prediction → score).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sde import bcast
from repro_torch.models.layers import dense_init, graph_state, timestep_embedding, to_tensor

Tensor = torch.Tensor


def _cast(policy):
    if policy is None:
        return lambda w: w
    return lambda w: w.to(policy.compute)


# --------------------------------------------------------------------------
# MLP score net
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPScoreConfig:
    dim: int = 2
    hidden: int = 128
    depth: int = 3
    t_dim: int = 64

    @property
    def sizes(self) -> list:
        return [self.dim + self.t_dim] + [self.hidden] * self.depth + [self.dim]


class MLPScore(nn.Module):
    """x (B, dim), t (B,) → raw output (B, dim): [x, temb(t)] through
    ``depth`` SiLU layers and a linear last layer."""

    def __init__(self, cfg: MLPScoreConfig, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        sizes = cfg.sizes
        self.w = nn.ParameterList(
            nn.Parameter(torch.zeros(sizes[i], sizes[i + 1], dtype=dtype, device=device))
            for i in range(len(sizes) - 1))
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(sizes[i + 1], dtype=dtype, device=device))
            for i in range(len(sizes) - 1))

    def graph_state(self) -> tuple:
        """``layers.graph_state`` of this net."""
        return graph_state(self)

    def forward(self, x: Tensor, t: Tensor, policy=None) -> Tensor:
        temb = timestep_embedding(t, self.cfg.t_dim)
        cw = _cast(policy)
        if policy is not None:
            x = x.to(policy.compute)
        h = torch.cat([x, temb.to(x.dtype)], dim=-1)
        n = len(self.w)
        for i in range(n):
            h = h @ cw(self.w[i]) + cw(self.b[i])
            if i < n - 1:
                h = F.silu(h)
        return h


def init_mlp_score(cfg: MLPScoreConfig, generator: torch.Generator,
                   dtype=torch.float32) -> MLPScore:
    """The reference's initial distributions, drawn layer by layer from
    ``generator`` on its device; the biases and the last weight are 0."""
    model = MLPScore(cfg, dtype=dtype, device=generator.device)
    with torch.no_grad():
        for w in list(model.w)[:-1]:
            w.copy_(dense_init(tuple(w.shape), generator=generator, dtype=dtype))
    return model


def mlp_score_forward(model: MLPScore, x: Tensor, t: Tensor, policy=None) -> Tensor:
    """Function form of ``model(x, t, policy)``."""
    return model(x, t, policy=policy)


def mlp_params_from_jax(tree: Mapping[str, Any], cfg: MLPScoreConfig,
                        device="cpu") -> MLPScore:
    """The reference's ``{"layers": [{"w", "b"}, ...]}`` → an ``MLPScore``."""
    layers = tree["layers"]
    if len(layers) != cfg.depth + 1:
        raise ValueError(f"{len(layers)} layers, config has {cfg.depth + 1}")
    dtype = to_tensor(layers[0]["w"]).dtype
    model = MLPScore(cfg, dtype=dtype, device=device)
    with torch.no_grad():
        for i, lp in enumerate(layers):
            _assign(model.w[i], lp["w"], f"layers[{i}]/w")
            _assign(model.b[i], lp["b"], f"layers[{i}]/b")
    return model


# --------------------------------------------------------------------------
# UNet score net (images)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 32
    channels: int = 3
    base: int = 32           # base feature width
    mults: tuple = (1, 2, 2)  # per-resolution channel multipliers
    t_dim: int = 128
    groups: int = 8


def same_pad(size: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding (lo, hi) of one axis: ceil(size/stride)
    outputs, the overhang split with the odd element at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    """SAME convolution of NCHW ``x`` with an HWIO kernel, as the
    reference's ``conv_general_dilated(..., "SAME", ("NHWC", "HWIO",
    "NHWC"))`` on the same values in NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    (t, b), (l, r) = (same_pad(x.shape[2], kh, stride), same_pad(x.shape[3], kw, stride))
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _groupnorm(x: Tensor, scale: Tensor, bias: Tensor, groups: int) -> Tensor:
    """GroupNorm of NCHW ``x`` over (C/g, H, W) per group: fp32 mean and
    biased variance, eps 1e-6, then the per-channel affine; x's dtype out."""
    B, C, H, W = x.shape
    g = min(groups, C)
    xg = x.reshape(B, g, C // g, H, W).to(torch.float32)
    mu = torch.mean(xg, dim=(2, 3, 4), keepdim=True)
    dev = xg - mu
    var = torch.mean(dev * dev, dim=(2, 3, 4), keepdim=True)
    y = (dev * torch.rsqrt(var + 1e-6)).reshape(B, C, H, W)
    return (y * scale.to(torch.float32)[:, None, None]
            + bias.to(torch.float32)[:, None, None]).to(x.dtype)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, t_dim: int, dtype, device):
        super().__init__()
        z = lambda *s: nn.Parameter(torch.zeros(*s, dtype=dtype, device=device))
        o = lambda *s: nn.Parameter(torch.ones(*s, dtype=dtype, device=device))
        self.gn1_s, self.gn1_b = o(cin), z(cin)
        self.conv1 = z(3, 3, cin, cout)
        self.temb_w, self.temb_b = z(t_dim, cout), z(cout)
        self.gn2_s, self.gn2_b = o(cout), z(cout)
        self.conv2 = z(3, 3, cout, cout)
        if cin != cout:
            self.skip = z(1, 1, cin, cout)
        else:
            self.skip = None

    def forward(self, x: Tensor, silu_temb: Tensor, groups: int, cw) -> Tensor:
        h = F.silu(_groupnorm(x, cw(self.gn1_s), cw(self.gn1_b), groups))
        h = conv(h, cw(self.conv1))
        h = h + (silu_temb @ cw(self.temb_w) + cw(self.temb_b))[:, :, None, None]
        h = F.silu(_groupnorm(h, cw(self.gn2_s), cw(self.gn2_b), groups))
        h = conv(h, cw(self.conv2))
        skip = conv(x, cw(self.skip)) if self.skip is not None else x
        return skip + h


class UNet(nn.Module):
    """x (B, H, W, C), t (B,) → raw output of x's shape (the noise
    prediction)."""

    def __init__(self, cfg: UNetConfig, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        z = lambda *s: nn.Parameter(torch.zeros(*s, dtype=dtype, device=device))
        widths = [cfg.base * m for m in cfg.mults]
        self.t_w1, self.t_w2 = z(cfg.t_dim, cfg.t_dim), z(cfg.t_dim, cfg.t_dim)
        self.conv_in = z(3, 3, cfg.channels, widths[0])
        cin = widths[0]
        self.down_res, self.down = nn.ModuleList(), nn.ParameterList()
        for w in widths:
            self.down_res.append(ResBlock(cin, w, cfg.t_dim, dtype, device))
            self.down.append(z(3, 3, w, w))
            cin = w
        self.mid1 = ResBlock(cin, cin, cfg.t_dim, dtype, device)
        self.mid2 = ResBlock(cin, cin, cfg.t_dim, dtype, device)
        self.up, self.up_res = nn.ParameterList(), nn.ModuleList()
        for w in reversed(widths):
            self.up.append(z(3, 3, cin, w))
            self.up_res.append(ResBlock(2 * w, w, cfg.t_dim, dtype, device))
            cin = w
        self.gn_out_s = nn.Parameter(torch.ones(cin, dtype=dtype, device=device))
        self.gn_out_b = z(cin)
        self.conv_out = z(3, 3, cin, cfg.channels)

    def graph_state(self) -> tuple:
        """``layers.graph_state`` of this net."""
        return graph_state(self)

    def forward(self, x: Tensor, t: Tensor, policy=None) -> Tensor:
        cfg = self.cfg
        f32 = lambda w: w.to(torch.float32)
        temb = timestep_embedding(t, cfg.t_dim)
        temb = F.silu(temb @ f32(self.t_w1)) @ f32(self.t_w2)
        cw = _cast(policy)
        if policy is not None:
            x = x.to(policy.compute)
            temb = temb.to(policy.compute)
        silu_temb = F.silu(temb)
        h = conv(x.permute(0, 3, 1, 2), cw(self.conv_in))
        skips = []
        for res, down in zip(self.down_res, self.down):
            h = res(h, silu_temb, cfg.groups, cw)
            skips.append(h)
            h = conv(h, cw(down), stride=2)
        h = self.mid1(h, silu_temb, cfg.groups, cw)
        h = self.mid2(h, silu_temb, cfg.groups, cw)
        for up, res in zip(self.up, self.up_res):
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = conv(h, cw(up))
            h = torch.cat([h, skips.pop()], dim=1)
            h = res(h, silu_temb, cfg.groups, cw)
        h = F.silu(_groupnorm(h, cw(self.gn_out_s), cw(self.gn_out_b), cfg.groups))
        return conv(h, cw(self.conv_out)).permute(0, 2, 3, 1)


def _blocks(model: UNet):
    """(tree path, ResBlock) of every residual block, in the reference's
    tree order."""
    yield from ((f"downs[{i}]/res", b) for i, b in enumerate(model.down_res))
    yield "mid1", model.mid1
    yield "mid2", model.mid2
    yield from ((f"ups[{i}]/res", b) for i, b in enumerate(model.up_res))


def init_unet(cfg: UNetConfig, generator: torch.Generator,
              dtype=torch.float32) -> UNet:
    """The reference's initial distributions, drawn from ``generator`` on
    its device in the reference's order of leaves; the norms' scales are
    1, the biases, ``conv2`` and ``conv_out`` 0."""
    model = UNet(cfg, dtype=dtype, device=generator.device)
    init = lambda shape, fan=None: dense_init(shape, generator=generator, dtype=dtype,
                                              fan_in=fan)
    conv_init = lambda p: p.copy_(init(tuple(p.shape), p.shape[0] * p.shape[1] * p.shape[2]))

    def res_init(b: ResBlock):
        conv_init(b.conv1)
        b.temb_w.copy_(init(tuple(b.temb_w.shape)))
        if b.skip is not None:
            conv_init(b.skip)

    with torch.no_grad():
        model.t_w1.copy_(init((cfg.t_dim, cfg.t_dim)))
        model.t_w2.copy_(init((cfg.t_dim, cfg.t_dim)))
        conv_init(model.conv_in)
        for res, down in zip(model.down_res, model.down):
            res_init(res)
            conv_init(down)
        res_init(model.mid1)
        res_init(model.mid2)
        for up, res in zip(model.up, model.up_res):
            conv_init(up)
            res_init(res)
    return model


def unet_forward(model: UNet, x: Tensor, t: Tensor, policy=None) -> Tensor:
    """Function form of ``model(x, t, policy)``."""
    return model(x, t, policy=policy)


_RES_LEAVES = ("gn1_s", "gn1_b", "conv1", "temb_w", "temb_b", "gn2_s", "gn2_b", "conv2")


def unet_params_from_jax(tree: Mapping[str, Any], cfg: UNetConfig, device="cpu") -> UNet:
    """The reference's ``init_unet`` tree (nested dict and lists of numpy
    arrays or tensors) → a ``UNet`` holding the same values."""
    dtype = to_tensor(tree["conv_in"]).dtype
    model = UNet(cfg, dtype=dtype, device=device)
    nodes = {"mid1": tree["mid1"], "mid2": tree["mid2"]}
    nodes.update({f"downs[{i}]/res": d["res"] for i, d in enumerate(tree["downs"])})
    nodes.update({f"ups[{i}]/res": u["res"] for i, u in enumerate(tree["ups"])})
    with torch.no_grad():
        for name in ("t_w1", "t_w2", "conv_in", "gn_out_s", "gn_out_b", "conv_out"):
            _assign(getattr(model, name), tree[name], name)
        for i, d in enumerate(tree["downs"]):
            _assign(model.down[i], d["down"], f"downs[{i}]/down")
        for i, u in enumerate(tree["ups"]):
            _assign(model.up[i], u["up"], f"ups[{i}]/up")
        for path, block in _blocks(model):
            node = nodes[path]
            for leaf in _RES_LEAVES:
                _assign(getattr(block, leaf), node[leaf], f"{path}/{leaf}")
            if (block.skip is None) != ("skip" not in node):
                raise ValueError(f"{path}: skip projection does not match the config")
            if block.skip is not None:
                _assign(block.skip, node["skip"], f"{path}/skip")
    return model


def _assign(param: Tensor, value, name: str) -> None:
    value = to_tensor(value)
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(param.shape)}")
    param.copy_(value.to(param.dtype))


def make_score_fn(model: nn.Module, sde, policy=None):
    """Noise-prediction net → score: s(x, t) = −net(x, t)/std(t).

    With ``policy`` the module's parameters are cast in place to
    ``policy.param`` by ``policy.cast_params``, x to ``policy.compute`` on entry; the division by
    std runs in fp32 and the score is returned in ``policy.state``. The
    score carries the net's ``graph_state`` (``layers.graph_state``),
    which keys the solvers' graph cache on it.
    """
    if policy is not None:
        policy.cast_params(model)

    def score(x: Tensor, t: Tensor) -> Tensor:
        _, std = sde.marginal(t)
        if policy is None:
            out = model(x, t)
        else:
            out = model(policy.to_compute(x), t, policy=policy)
        s = -out.to(torch.float32) / bcast(std, x)
        return s if policy is None else policy.to_state(s)

    score.graph_state = lambda: graph_state(model)
    return score


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
