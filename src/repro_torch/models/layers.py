"""Shared layers; port of ``repro/models/layers.py`` (the parts the DiT,
the temporal UNet and the language models use: initializer, norms,
rotary embeddings, the MLP, time embedding), and ``to_tensor``, which
carries the reference's parameter leaves across.

Norms take their statistics in fp32 whatever the activation dtype and
round once on return, like the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def graph_state(net, cfg=None) -> tuple:
    """What a cached CUDA graph of ``net``'s forward depends on besides its
    inputs (``core.solvers.adaptive.GraphKey``): the config (``cfg``, by
    default ``net.cfg``), for an ``nn.Module`` its ``training`` flag, and
    every parameter's and buffer's (data_ptr, shape, dtype), in order; for
    a tree of tensors (the language models' parameters) every leaf's. An
    in-place update of the weights keeps it; a flipped flag in the config
    (``use_flash``), a cast (``cast_params``) or a parameter bound to a
    new tensor changes it."""
    if isinstance(net, torch.nn.Module):
        cfg = net.cfg if cfg is None else cfg
        leaves = [t for _, t in net.named_parameters()] + [t for _, t in net.named_buffers()]
        head = (cfg, net.training)
    else:
        leaves = [t for t in torch.utils._pytree.tree_leaves(net) if isinstance(t, Tensor)]
        head = (cfg,)
    return head + (tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in leaves),)


def to_tensor(a) -> Tensor:
    """A parameter leaf from the reference (numpy, including ml_dtypes
    bfloat16, which numpy cannot name) or torch → a torch tensor."""
    if isinstance(a, Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


class Unseeded:
    """Stands in for a ``torch.Generator`` on the meta device, which has
    none: the init functions allocate their leaves there and draw nothing
    (``launch/specs.py::abstract_params``)."""

    device = torch.device("meta")


def draws_from(generator):
    """The ``generator=`` of a draw: None for ``Unseeded`` (a meta tensor
    holds no values), else the generator itself."""
    return None if isinstance(generator, Unseeded) else generator


def new_leaf(alloc, shape, dtype, device) -> Tensor:
    """An uninitialised parameter leaf: ``alloc(shape, dtype)`` where the
    caller hands one in (``transformer.init_model`` gives views into the
    stacked leaves), else a new tensor on ``device``."""
    if alloc is not None:
        return alloc(tuple(shape), dtype)
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def dense_init(shape, *, generator: torch.Generator, dtype=torch.float32,
               fan_in: Optional[int] = None, alloc=None) -> Tensor:
    """Truncated normal on [−2, 2] times 1/sqrt(fan_in) (fan_in = shape[0]
    by default), drawn in fp32 on the generator's device and scaled in
    place, into a leaf from ``new_leaf(alloc, ...)`` (an fp32 leaf holds
    the draw itself; another dtype takes a rounded copy)."""
    fan = fan_in if fan_in is not None else shape[0]
    out = new_leaf(alloc, shape, dtype, generator.device)
    w = out if out.dtype == torch.float32 else torch.empty(
        tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=draws_from(generator))
    w.mul_(fan ** -0.5)
    if w is not out:
        out.copy_(w)
    return out


def init_norm(dim: int, norm_type: str, dtype=torch.float32, device="cpu", alloc=None) -> dict:
    """The norm's parameters: ``rmsnorm`` a unit scale, ``layernorm`` a
    unit scale and a zero bias, ``layernorm_np`` none."""
    leaf = lambda: new_leaf(alloc, (dim,), dtype, device)
    if norm_type == "rmsnorm":
        return {"scale": leaf().fill_(1)}
    if norm_type == "layernorm":
        return {"scale": leaf().fill_(1), "bias": leaf().zero_()}
    if norm_type == "layernorm_np":
        return {}
    raise ValueError(norm_type)


def apply_norm(x: Tensor, norm_type: str, params: Optional[dict] = None,
               eps: float = 1e-6) -> Tensor:
    """``rmsnorm`` | ``layernorm`` | ``layernorm_np`` (non-parametric) over
    the last axis, with fp32 statistics; returns x's dtype."""
    xf = x.to(torch.float32)
    if norm_type == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].to(torch.float32)
    elif norm_type in ("layernorm", "layernorm_np"):
        mu = torch.mean(xf, dim=-1, keepdim=True)
        dev = xf - mu
        var = torch.mean(dev * dev, dim=-1, keepdim=True)
        y = dev * torch.rsqrt(var + eps)
        if norm_type == "layernorm":
            y = (y * params["scale"].to(torch.float32)
                 + params["bias"].to(torch.float32))
    else:
        raise ValueError(norm_type)
    return y.to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding (reference ``layers.py:64``). x (..., S, H, D),
    positions (..., S) integer: fp32 angles positions·θ^(−i/half), the
    half-split rotation, the result in x's dtype.

    The frequencies are rounded once from float64, which gives the
    reference's correctly rounded fp32 power bit for bit; cos and sin are
    torch's, within an ulp of XLA's."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.full((), theta, dtype=torch.float64, device=x.device),
                     exps.to(torch.float64)).to(torch.float32)
    angles = positions[..., :, None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def init_mlp(d_model: int, d_ff: int, glu: bool, *, generator: torch.Generator,
             dtype=torch.float32, alloc=None) -> dict:
    """``w_in`` (E, F), ``w_out`` (F, E) and, when gated, ``w_gate`` (E, F)."""
    draw = lambda shape: dense_init(shape, generator=generator, dtype=dtype, alloc=alloc)
    p = {"w_in": draw((d_model, d_ff)), "w_out": draw((d_ff, d_model))}
    if glu:
        p["w_gate"] = draw((d_model, d_ff))
    return p


def _act(x: Tensor, name: str) -> Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def apply_mlp(x: Tensor, w_in: Tensor, w_out: Tensor,
              w_gate: Optional[Tensor] = None, act: str = "silu") -> Tensor:
    """``act(x @ w_gate) * (x @ w_in) @ w_out`` when gated (the DiT's
    MLP), else ``act(x @ w_in) @ w_out``."""
    h = x @ w_in
    h = _act(x @ w_gate, act) * h if w_gate is not None else _act(h, act)
    return h @ w_out


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10_000.0) -> Tensor:
    """Sinusoidal embedding of continuous t ∈ [0, 1]; shape (B, dim), fp32.

    The arguments are t·freq·1000: t lives on [0, 1], and the factor
    spreads it over the range the frequencies were chosen for.
    """
    half = dim // 2
    # log of the period in fp32, as the reference takes it; made by a fill
    # on the device, not a host copy, so a CUDA graph can capture it
    log_period = torch.log(torch.full((), max_period, dtype=torch.float32,
                                      device=t.device))
    freqs = torch.exp(-log_period * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None, :] * 1000.0
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb
