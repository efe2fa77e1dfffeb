"""DiT score network over image patches with adaLN time conditioning;
port of ``repro/models/dit.py``.

``DiT`` is an ``nn.Module`` whose parameters keep the reference's
layouts (``wq/wk/wv`` (E, H, Dh), ``wo`` (H, Dh, E), ``x @ w`` dense
weights), so ``params_from_jax`` copies a reference parameter tree in
without transposes. The blocks live in a ``ModuleList`` where the
reference stacks them on axis 0 for ``lax.scan``.

Precision (DESIGN.md §8): with a ``policy`` the activations and the
weight copies the matmuls consume run in ``policy.compute``; the
timestep embedding is computed in fp32 from the stored weights and the
norms take fp32 statistics. ``make_score_fn`` divides by std in fp32 and
returns the score in ``policy.state``.

A fresh ``init_dit`` sets ``ada``, ``ada_b``, ``final_ada``,
``final_ada_b`` and ``patch_out`` to zero, as the reference does, so the
fresh network returns exactly 0 for every input. ``liven_zero_init``
gives those leaves random values, so that a network made from a seed
carries signal through attention to its output.

Every leaf is a trainable ``nn.Parameter``, as every leaf of the
reference's tree is trained (``pos_emb`` included). The samplers run
under ``torch.no_grad()``; training runs with ``use_flash=False``, as
the reference trains, since the flash kernel has no backward (its
wrapper raises under grad mode, ``kernels.autograd``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sde import bcast
from repro_torch.models.attention import attention
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, timestep_embedding, to_tensor,
)

Tensor = torch.Tensor

#: the leaves a fresh DiT holds at zero
ZERO_INIT_LAYER = ("ada", "ada_b")
ZERO_INIT_TOP = ("final_ada", "final_ada_b", "patch_out")


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    image_size: int = 32
    channels: int = 3
    patch: int = 4
    d_model: int = 256
    num_layers: int = 6
    num_heads: int = 8
    d_ff: int = 1024
    #: > 0 adds a label-embedding table with a trailing null row
    #: (DESIGN.md §9); 0 is the unconditional net
    num_classes: int = 0
    #: route block attention through the flash kernel (DESIGN.md §13)
    use_flash: bool = False

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels

    @property
    def head_dim(self) -> int:
        """``d_model // num_heads``, the reference ``ModelConfig`` rule."""
        return self.d_model // self.num_heads


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(tuple(shape), dtype=dtype, device=device))


class DiTBlock(nn.Module):
    """adaLN-modulated attention + gated-MLP block."""

    def __init__(self, cfg: DiTConfig, dtype, device):
        super().__init__()
        E, H, Dh, Fd = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
        p = lambda *s: _param(s, dtype, device)
        self.wq, self.wk, self.wv = p(E, H, Dh), p(E, H, Dh), p(E, H, Dh)
        self.wo = p(H, Dh, E)
        self.w_in, self.w_gate, self.w_out = p(E, Fd), p(E, Fd), p(Fd, E)
        self.ada, self.ada_b = p(E, 6 * E), p(6 * E)

    def forward(self, h: Tensor, silu_temb: Tensor, cw, use_flash: bool) -> Tensor:
        B, S, E = h.shape
        H, Dh = self.wq.shape[1], self.wq.shape[2]
        mod = silu_temb @ cw(self.ada) + cw(self.ada_b)
        s1, b1, g1, s2, b2, g2 = mod[:, None, :].chunk(6, dim=-1)
        hn = apply_norm(h, "layernorm_np") * (1 + s1) + b1
        q = (hn @ cw(self.wq).reshape(E, H * Dh)).view(B, S, H, Dh)
        k = (hn @ cw(self.wk).reshape(E, H * Dh)).view(B, S, H, Dh)
        v = (hn @ cw(self.wv).reshape(E, H * Dh)).view(B, S, H, Dh)
        att = attention(q, k, v, causal=False, window=None, softcap=0.0,
                        use_flash=use_flash)
        h = h + g1 * (att.reshape(B, S, H * Dh) @ cw(self.wo).reshape(H * Dh, E))
        hn = apply_norm(h, "layernorm_np") * (1 + s2) + b2
        return h + g2 * apply_mlp(hn, cw(self.w_in), cw(self.w_out), cw(self.w_gate))


class DiT(nn.Module):
    """x (B, H, W, C), t (B,) → raw network output of x's shape."""

    def __init__(self, cfg: DiTConfig, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        E = cfg.d_model
        p = lambda *s: _param(s, dtype, device)
        if cfg.num_classes > 0:
            self.label_emb = p(cfg.num_classes + 1, E)
        self.patch_in = p(cfg.patch_dim, E)
        self.pos_emb = p(cfg.tokens, E)
        self.t_mlp1, self.t_mlp2 = p(256, E), p(E, E)
        self.blocks = nn.ModuleList(DiTBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_ada, self.final_ada_b = p(E, 2 * E), p(2 * E)
        self.patch_out = p(E, cfg.patch_dim)

    def _patchify(self, x: Tensor) -> Tensor:
        c = self.cfg
        B, Hh, W, C = x.shape
        p = c.patch
        x = x.reshape(B, Hh // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, c.tokens, c.patch_dim)

    def _unpatchify(self, t: Tensor) -> Tensor:
        c = self.cfg
        B, p, n = t.shape[0], c.patch, c.image_size // c.patch
        t = t.reshape(B, n, n, p, p, c.channels).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(B, c.image_size, c.image_size, c.channels)

    def forward(self, x: Tensor, t: Tensor, y: Optional[Tensor] = None,
                policy=None) -> Tensor:
        c = self.cfg
        f32 = lambda w: w.to(torch.float32)
        temb = timestep_embedding(t, 256)
        temb = F.silu(temb @ f32(self.t_mlp1)) @ f32(self.t_mlp2)
        if y is not None and c.num_classes > 0:
            idx = torch.where(y < 0, c.num_classes, y).long()
            temb = temb + f32(self.label_emb)[idx]
        if policy is not None:
            x = x.to(policy.compute)
            cw = lambda w: w.to(policy.compute)
        else:
            cw = lambda w: w
        h = self._patchify(x) @ cw(self.patch_in) + cw(self.pos_emb)
        silu_temb = F.silu(temb.to(h.dtype))
        for block in self.blocks:
            h = block(h, silu_temb, cw, c.use_flash)
        mod = silu_temb @ cw(self.final_ada) + cw(self.final_ada_b)
        s, b = mod[:, None, :].chunk(2, dim=-1)
        h = apply_norm(h, "layernorm_np") * (1 + s) + b
        return self._unpatchify(h @ cw(self.patch_out))


def init_dit(cfg: DiTConfig, generator: torch.Generator,
             dtype=torch.float32) -> DiT:
    """A DiT with the reference's initial distributions, drawn from
    ``generator`` on its device (the zero-init leaves stay zero)."""
    model = DiT(cfg, dtype=dtype, device=generator.device)
    E, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    init = lambda shape, **kw: dense_init(shape, generator=generator,
                                          dtype=dtype, **kw)
    normal = lambda shape: (0.02 * torch.randn(
        shape, generator=generator, device=generator.device)).to(dtype)
    with torch.no_grad():
        for blk in model.blocks:
            for name in ("wq", "wk", "wv"):
                getattr(blk, name).copy_(init((E, H, Dh), fan_in=E))
            blk.wo.copy_(init((H, Dh, E), fan_in=H * Dh))
            blk.w_in.copy_(init((E, cfg.d_ff)))
            blk.w_gate.copy_(init((E, cfg.d_ff)))
            blk.w_out.copy_(init((cfg.d_ff, E)))
        if cfg.num_classes > 0:
            model.label_emb.copy_(normal((cfg.num_classes + 1, E)))
        model.patch_in.copy_(init((cfg.patch_dim, E)))
        model.pos_emb.copy_(normal((cfg.tokens, E)))
        model.t_mlp1.copy_(init((256, E)))
        model.t_mlp2.copy_(init((E, E)))
    return model


def liven_zero_init(model: DiT, generator: torch.Generator,
                    scale: float = 0.02) -> DiT:
    """Set the zero-init leaves to ``scale``·N(0, 1) in place, so that the
    network's output is not identically 0 (the reference's fresh DiT
    returns exactly 0, which would hide the attention path)."""
    tensors = [getattr(b, n) for b in model.blocks for n in ZERO_INIT_LAYER]
    tensors += [getattr(model, n) for n in ZERO_INIT_TOP]
    with torch.no_grad():
        for w in tensors:
            w.copy_(scale * torch.randn(w.shape, generator=generator,
                                        device=generator.device))
    return model


def params_from_jax(tree: Mapping[str, Any], cfg: DiTConfig,
                    device="cpu") -> DiT:
    """The reference's ``init_dit`` parameter tree (nested dict of numpy
    arrays or tensors) → a ``DiT`` holding the same values.

    The reference stacks the per-layer leaves on axis 0 for
    ``lax.scan``; they are unstacked into the ``ModuleList``. Layouts are
    kept as they are. The module takes the tree's dtype.
    """
    # the norms are parameter-free: their leaves are empty dicts
    top = {k: to_tensor(v) for k, v in tree.items()
           if k != "layers" and not isinstance(v, Mapping)}
    dtype = top["patch_in"].dtype
    model = DiT(cfg, dtype=dtype, device=device)
    layers = tree["layers"]
    per_layer = {
        "wq": layers["attn"]["wq"], "wk": layers["attn"]["wk"],
        "wv": layers["attn"]["wv"], "wo": layers["attn"]["wo"],
        "w_in": layers["mlp"]["w_in"], "w_gate": layers["mlp"]["w_gate"],
        "w_out": layers["mlp"]["w_out"], "ada": layers["ada"],
        "ada_b": layers["ada_b"],
    }
    with torch.no_grad():
        for name, stacked in per_layer.items():
            stacked = to_tensor(stacked)
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"layers/{name}: {stacked.shape[0]} layers, "
                                 f"config has {cfg.num_layers}")
            for i, blk in enumerate(model.blocks):
                _assign(getattr(blk, name), stacked[i], f"layers/{name}[{i}]")
        for name, value in top.items():
            if not hasattr(model, name):
                raise ValueError(f"unexpected parameter {name!r}")
            _assign(getattr(model, name), value, name)
    return model


def _assign(param: Tensor, value: Tensor, name: str) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(param.shape)}")
    param.copy_(value.to(param.dtype))


def dit_forward(model: DiT, x: Tensor, t: Tensor, policy=None,
                y: Optional[Tensor] = None) -> Tensor:
    """Function form of ``model(x, t, y, policy)``."""
    return model(x, t, y=y, policy=policy)


def make_score_fn(model: DiT, sde, policy=None):
    """s(x, t) = −net(x, t)/std(t) (noise-prediction parametrisation).

    With ``policy`` the module's parameters are cast in place to
    ``policy.param`` by ``policy.cast_params`` (no second copy of the
    weights is kept), x is cast
    to ``policy.compute`` on entry, the division by std runs in fp32, and
    the score is returned in ``policy.state``. With a class-conditional
    config the score takes an optional ``y``.
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

    return score


def param_count(model: DiT) -> int:
    return sum(p.numel() for p in model.parameters())

