"""Temporal score network for trajectory diffusion; port of
``repro/models/temporal_unet.py`` (DESIGN.md §10).

A 1-D residual conv UNet over (B, H, D) trajectories: horizon H of
transitions, each an ``[observation, action]`` vector of width D. Time
conditioning enters every residual block, the down/up path runs over
the horizon axis with skip connections, and the output is a noise
prediction. ``returns_bins > 0`` adds a returns-to-go embedding table
with a trailing null row that stays zero, so a null-labelled forward is
bitwise the unconditional one.

The network keeps the reference's layout at its public face: x is
(B, H, C) ("NHC"), conv weights are (k, cin, cout) ("HIO"), and
``TemporalUNet`` holds its parameters in the reference's tree (nested
modules named as the reference's dict keys), so ``params_from_jax``
copies a reference tree in leaf by leaf. A conv runs as
``torch.nn.functional.conv1d`` on the transposed activations with the
padding XLA's "SAME" picks: at stride 2 with an even H and kernel 5
that is 1 on the left and 2 on the right, which no symmetric padding
reproduces.

Hot path (DESIGN.md §13): ``attention=True`` adds a bottleneck
self-attention block (zero-init output projection) through the
``models/attention.py`` owner, flash kernel with ``use_flash``;
``use_fused_norm`` runs each residual block's and the output's
GroupNorm → SiLU through ``kernels/groupnorm_silu``. The attention
block's own pre-norm stays the unfused ``_groupnorm``, as in the
reference.

Precision (DESIGN.md §8): the time and returns embeddings are fp32 from
the stored weights, GroupNorm takes fp32 statistics and rounds once,
and ``make_score_fn`` divides by std in fp32.

A fresh network returns exactly 0: ``conv2`` of every residual block,
``conv_out`` and the attention ``wo`` start at zero, as in the
reference. ``liven_zero_init`` gives those leaves random values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.precision import resolve_policy
from repro_torch.core.sde import bcast
from repro_torch.models.attention import attention
from repro_torch.models.layers import dense_init, graph_state, timestep_embedding, to_tensor

Tensor = torch.Tensor

#: the weights a fresh network holds at zero (GroupNorm biases aside)
ZERO_INIT = ("conv2", "conv_out", "wo")


@dataclasses.dataclass(frozen=True)
class TemporalUNetConfig:
    """1-D UNet over (horizon, transition) trajectories. ``horizon`` must
    be divisible by ``2 ** (len(mults) - 1)``."""

    horizon: int = 16
    #: transition width D = obs_dim + act_dim
    transition_dim: int = 6
    base: int = 32
    mults: tuple = (1, 2)
    t_dim: int = 64
    groups: int = 8
    kernel: int = 5
    #: > 0 adds the returns-to-go table with a trailing zero null row
    returns_bins: int = 0
    #: bottleneck self-attention block (zero-init output projection)
    attention: bool = False
    attn_heads: int = 4
    #: route the bottleneck attention through the flash kernel
    use_flash: bool = False
    #: run each GroupNorm → SiLU through the fused kernel
    use_fused_norm: bool = False

    def __post_init__(self):
        down = 2 ** (len(self.mults) - 1)
        if self.horizon % down:
            raise ValueError(f"horizon {self.horizon} must divide {down} "
                             f"(one stride-2 downsample per extra mult)")
        if self.attention:
            cmid = self.base * self.mults[-1]
            if cmid % self.attn_heads:
                raise ValueError(f"bottleneck width {cmid} must divide "
                                 f"attn_heads {self.attn_heads}")


def _resblock_shapes(k, cin, cout, t_dim) -> dict:
    p = {"gn1_s": (cin,), "gn1_b": (cin,), "conv1": (k, cin, cout),
         "temb_w": (t_dim, cout), "temb_b": (cout,), "gn2_s": (cout,),
         "gn2_b": (cout,), "conv2": (k, cout, cout)}
    if cin != cout:
        p["skip"] = (1, cin, cout)
    return p


def param_shapes(cfg: TemporalUNetConfig) -> dict:
    """The reference's parameter tree of ``cfg``, with shapes as leaves."""
    widths = [cfg.base * m for m in cfg.mults]
    k, td = cfg.kernel, cfg.t_dim
    p: dict = {"t_w1": (td, td), "t_w2": (td, td),
               "conv_in": (k, cfg.transition_dim, widths[0])}
    if cfg.returns_bins > 0:
        p["ret_emb"] = (cfg.returns_bins + 1, td)
    cin, downs = widths[0], []
    for i, w in enumerate(widths):
        d = {"res": _resblock_shapes(k, cin, w, td)}
        if i < len(widths) - 1:
            d["down"] = (k, w, w)
        downs.append(d)
        cin = w
    p["downs"] = downs
    p["mid1"] = _resblock_shapes(k, cin, cin, td)
    p["mid2"] = _resblock_shapes(k, cin, cin, td)
    ups = []
    for i, w in enumerate(reversed(widths)):
        u = {"up": (k, cin, w)} if i else {}
        # below the bottom level the block sees [upsampled w ; skip w]
        u["res"] = _resblock_shapes(k, 2 * w if i else cin, w, td)
        ups.append(u)
        cin = w
    p["ups"] = ups
    p["gn_out_s"], p["gn_out_b"] = (cin,), (cin,)
    p["conv_out"] = (k, cin, cfg.transition_dim)
    if cfg.attention:
        cmid = cfg.base * cfg.mults[-1]
        h, dh = cfg.attn_heads, cmid // cfg.attn_heads
        p["attn"] = {"gn_s": (cmid,), "gn_b": (cmid,), "wq": (cmid, h, dh),
                     "wk": (cmid, h, dh), "wv": (cmid, h, dh), "wo": (h, dh, cmid)}
    return p


class ParamTree(nn.Module):
    """Parameters laid out as a nested dict: a dict becomes a submodule,
    a list an ``nn.ModuleList``, a shape a zero ``nn.Parameter``. Items
    read as ``node["key"]``; ``"key" in node`` tests presence."""

    def __init__(self, shapes: Mapping[str, Any], dtype, device):
        super().__init__()
        for key, v in shapes.items():
            if isinstance(v, Mapping):
                self.add_module(key, ParamTree(v, dtype, device))
            elif isinstance(v, list):
                self.add_module(key, nn.ModuleList(ParamTree(e, dtype, device)
                                                   for e in v))
            else:
                self.register_parameter(key, nn.Parameter(
                    torch.zeros(v, dtype=dtype, device=device), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _conv(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    """``conv_general_dilated(x, w, (stride,), "SAME")`` in NHC/HIO
    layout: x (B, H, cin), w (k, cin, cout) → (B, ceil(H/stride), cout),
    contiguous."""
    H, k = x.shape[1], w.shape[0]
    out_h = -(-H // stride)
    pad = max((out_h - 1) * stride + k - H, 0)
    xt = F.pad(x.transpose(1, 2), (pad // 2, pad - pad // 2))
    y = F.conv1d(xt, w.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2).contiguous()


def _upsample2(h: Tensor) -> Tensor:
    """Nearest-neighbour ×2 along the horizon, as
    ``jax.image.resize(h, (B, 2H, C), "nearest")``."""
    return torch.repeat_interleave(h, 2, dim=1)


def _groupnorm(x: Tensor, scale: Tensor, bias: Tensor, groups: int) -> Tensor:
    """GroupNorm over (sample, group) slabs with fp32 statistics (the mean,
    then the mean of squared deviations), fp32 affine, rounded once to
    x's dtype."""
    B, H, C = x.shape
    g = min(groups, C)
    xg = x.reshape(B, H, g, C // g).to(torch.float32)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    d = xg - mu
    var = (d * d).mean(dim=(1, 3), keepdim=True)
    xg = d * torch.rsqrt(var + 1e-6)
    out = (xg.reshape(B, H, C) * scale.to(torch.float32)
           + bias.to(torch.float32))
    return out.to(x.dtype)


def _gn_silu(x: Tensor, scale: Tensor, bias: Tensor, groups: int,
             fused: bool) -> Tensor:
    """GroupNorm → SiLU: the fused kernel (one rounding) or the unfused
    chain ``silu(_groupnorm(...))``."""
    if fused:
        from repro_torch.kernels.groupnorm_silu import ops as gs

        return gs.groupnorm_silu(x, scale, bias, groups=groups)
    return F.silu(_groupnorm(x, scale, bias, groups))


def _resblock(p, x: Tensor, temb: Tensor, groups: int, fused: bool, cw) -> Tensor:
    h = _gn_silu(x, cw(p["gn1_s"]), cw(p["gn1_b"]), groups, fused)
    h = _conv(h, cw(p["conv1"]))
    h = h + (F.silu(temb) @ cw(p["temb_w"]) + cw(p["temb_b"]))[:, None, :]
    h = _gn_silu(h, cw(p["gn2_s"]), cw(p["gn2_b"]), groups, fused)
    h = _conv(h, cw(p["conv2"]))
    skip = _conv(x, cw(p["skip"])) if "skip" in p else x
    return skip + h


def _attn_block(p, x: Tensor, cfg: TemporalUNetConfig, cw) -> Tensor:
    """Bottleneck self-attention over the horizon: pre-norm (unfused
    ``_groupnorm``), per-head qkv, non-causal attention through the
    owner, zero-init output projection."""
    B, S, C = x.shape
    wq = cw(p["wq"])
    Hh, Dh = wq.shape[1], wq.shape[2]
    hn = _groupnorm(x, cw(p["gn_s"]), cw(p["gn_b"]), cfg.groups)
    q = (hn @ wq.reshape(C, Hh * Dh)).view(B, S, Hh, Dh)
    k = (hn @ cw(p["wk"]).reshape(C, Hh * Dh)).view(B, S, Hh, Dh)
    v = (hn @ cw(p["wv"]).reshape(C, Hh * Dh)).view(B, S, Hh, Dh)
    att = attention(q, k, v, causal=False, window=None, softcap=0.0,
                    use_flash=cfg.use_flash)
    return x + att.reshape(B, S, Hh * Dh) @ cw(p["wo"]).reshape(Hh * Dh, C)


class TemporalUNet(ParamTree):
    """x (B, H, D), t (B,) [, y (B,) returns bins] → noise prediction of
    x's shape."""

    def __init__(self, cfg: TemporalUNetConfig, dtype=torch.float32,
                 device="cpu"):
        super().__init__(param_shapes(cfg), dtype, device)
        self.cfg = cfg
        # building a precision policy turns cuDNN's TF32 off, so the
        # convolutions run in full fp32 on the card, as the reference's do
        resolve_policy(None)

    def graph_state(self) -> tuple:
        """``layers.graph_state`` of this net."""
        return graph_state(self)

    def forward(self, x: Tensor, t: Tensor, y: Optional[Tensor] = None,
                policy=None) -> Tensor:
        cfg = self.cfg
        f32 = lambda w: w.to(torch.float32)
        temb = timestep_embedding(t, cfg.t_dim)
        temb = F.silu(temb @ f32(self["t_w1"])) @ f32(self["t_w2"])
        if y is not None and cfg.returns_bins > 0:
            idx = torch.where(y < 0, cfg.returns_bins, y).long()
            temb = temb + f32(self["ret_emb"])[idx]
        if policy is not None:
            x = x.to(policy.compute)
            temb = temb.to(policy.compute)
            cw = lambda w: w.to(policy.compute)
        else:
            cw = lambda w: w
        fused = cfg.use_fused_norm
        h = _conv(x, cw(self["conv_in"]))
        skips = []
        for d in self["downs"]:
            h = _resblock(d["res"], h, temb, cfg.groups, fused, cw)
            if "down" in d:
                skips.append(h)
                h = _conv(h, cw(d["down"]), stride=2)
        h = _resblock(self["mid1"], h, temb, cfg.groups, fused, cw)
        if cfg.attention:
            h = _attn_block(self["attn"], h, cfg, cw)
        h = _resblock(self["mid2"], h, temb, cfg.groups, fused, cw)
        for u in self["ups"]:
            if "up" in u:
                h = _conv(_upsample2(h), cw(u["up"]))
                h = torch.cat([h, skips.pop()], dim=-1)
            h = _resblock(u["res"], h, temb, cfg.groups, fused, cw)
        h = _gn_silu(h, cw(self["gn_out_s"]), cw(self["gn_out_b"]), cfg.groups,
                     fused)
        return _conv(h, cw(self["conv_out"]))


def init_temporal_unet(cfg: TemporalUNetConfig, generator: torch.Generator,
                       dtype=torch.float32) -> TemporalUNet:
    """A network with the reference's initial distributions, drawn from
    ``generator`` on its device: convs truncated-normal × (k·cin)^-½,
    dense weights ``dense_init``, GroupNorm scales 1 and biases 0, the
    returns table 0.02·N(0, 1) with a zero null row, and ``conv2``,
    ``conv_out`` and the attention ``wo`` zero."""
    model = TemporalUNet(cfg, dtype=dtype, device=generator.device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(p.shape)
            if leaf in ZERO_INIT or leaf.endswith("_b"):
                continue
            if leaf.endswith("_s"):
                p.fill_(1.0)
            elif leaf == "ret_emb":
                table = 0.02 * torch.randn(shape, generator=generator,
                                           device=generator.device)
                table[cfg.returns_bins] = 0.0
                p.copy_(table)
            elif leaf in ("conv_in", "conv1", "skip", "down", "up"):
                # (k, cin, cout): fan-in k·cin
                p.copy_(dense_init(shape, generator=generator,
                                   fan_in=shape[0] * shape[1]))
            else:  # t_w1, t_w2, temb_w, wq, wk, wv: fan-in shape[0]
                p.copy_(dense_init(shape, generator=generator))
    return model


def liven_zero_init(model: TemporalUNet, generator: torch.Generator,
                    scale: float = 0.02) -> TemporalUNet:
    """Set ``conv2`` of every residual block, ``conv_out`` and the
    attention ``wo`` to ``scale``·N(0, 1) in place, so that the output is
    not identically 0. The returns null row stays zero."""
    with torch.no_grad():
        for name, w in model.named_parameters():
            if name.rsplit(".", 1)[-1] not in ZERO_INIT:
                continue
            w.copy_(scale * torch.randn(w.shape, generator=generator,
                                        device=generator.device))
    return model


def _copy_tree(node, tree, path: str) -> None:
    have = set(node._parameters) | set(node._modules)
    if set(tree) != have:
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != {sorted(have)}")
    for key, v in tree.items():
        where = f"{path}/{key}" if path else key
        if isinstance(v, Mapping):
            _copy_tree(node[key], v, where)
        elif isinstance(v, (list, tuple)):
            if len(v) != len(node[key]):
                raise ValueError(f"{where}: {len(v)} entries != {len(node[key])}")
            for i, e in enumerate(v):
                _copy_tree(node[key][i], e, f"{where}[{i}]")
        else:
            value, param = to_tensor(v), node[key]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{where}: shape {tuple(value.shape)} != "
                                 f"{tuple(param.shape)}")
            param.copy_(value.to(param.dtype))


def params_from_jax(tree: Mapping[str, Any], cfg: TemporalUNetConfig,
                    device="cpu") -> TemporalUNet:
    """The reference's ``init_temporal_unet`` tree (nested dicts and lists
    of numpy arrays or tensors) → a ``TemporalUNet`` holding the same
    values, in the tree's dtype. Keys and shapes must match ``cfg``."""
    dtype = to_tensor(tree["t_w1"]).dtype
    model = TemporalUNet(cfg, dtype=dtype, device=device)
    with torch.no_grad():
        _copy_tree(model, tree, "")
    return model


def temporal_unet_forward(model: TemporalUNet, x: Tensor, t: Tensor,
                          policy=None, y: Optional[Tensor] = None) -> Tensor:
    """Function form of ``model(x, t, y, policy)``: x (B, H, D), t (B,),
    optional returns-bin labels y (B,) (negative = the null row)."""
    return model(x, t, y=y, policy=policy)


def make_score_fn(model: TemporalUNet, sde, policy=None):
    """s(x, t[, y]) = −net(x, t[, y])/std(t), the adapter that lets every
    solver, and a ``ClassifierFree``/``PlanConditioner`` wrap, run on
    trajectories.

    With ``policy`` the module's parameters are cast in place to
    ``policy.param`` by ``policy.cast_params``, x goes to ``policy.compute``, the division by std
    runs in fp32, and the score comes back in ``policy.state``. The score
    carries the net's ``graph_state``, which keys the solvers' graph cache
    on it.
    """
    if policy is not None:
        policy.cast_params(model)

    def score(x: Tensor, t: Tensor, y: Optional[Tensor] = None) -> Tensor:
        _, std = sde.marginal(t)
        if policy is not None:
            x = policy.to_compute(x)
        out = model(x, t, y=y, policy=policy)
        s = -out.to(torch.float32) / bcast(std, x)
        return s if policy is None else policy.to_state(s)

    score.graph_state = model.graph_state
    return score


def param_count(model: TemporalUNet) -> int:
    return sum(p.numel() for p in model.parameters())
