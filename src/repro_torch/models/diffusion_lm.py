"""Diffusion language modelling: a zoo backbone as a score network over
token embeddings, sampled by the paper's solver; port of
``repro/models/diffusion_lm.py``.

Construction (the reference's, DESIGN.md §4):
  * tokens → a frozen embedding table E (V, D_e) of unit-norm rows, a
    seeded draw (the "vocabulary geometry");
  * forward process: VP diffusion on the (B, S, D_e) embeddings;
  * score net: the backbone's widths run NON-causally, with a time
    vector added at every position, predicting the noise;
  * decoding: nearest embedding (argmax E·x̂₀).

The forward is the reference's as written: its attention is the plain
``_ref_attention(causal=False)`` (no flash kernel, no rotary positions),
and it skips the backbone's qkv biases and q/k norms even where the
config has them (their leaves are in the tree, unused). ``out_proj`` is
zero at init, so a fresh net predicts exactly 0; ``liven`` fills it with
a seeded small draw. ``generate`` samples through ``core.sampling.sample``,
so an adaptive solve with ``use_fused_kernel=True`` runs K1 in every
iteration on the card. Parameters are a nested dict of tensors in the
reference's layout (layers stacked on ``backbone.num_repeats``);
``params_from_jax`` copies a reference tree into one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sampling import sample
from repro_torch.core.solvers import get_solver
from repro_torch.device import resolve_device
from repro_torch.models.attention import _ref_attention, init_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, init_mlp, init_norm, timestep_embedding)
from repro_torch.models.transformer import _copy_tree, _layer, _stack

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DiffusionLMConfig:
    backbone: ModelConfig      # any dense-family zoo config (reduced or full)
    embed_dim: int = 64        # continuous token-embedding dimension
    t_dim: int = 128

    def __post_init__(self):
        if not all(m in ("A", "L") for m in self.backbone.mixer_pattern):
            raise ValueError("diffusion-LM backbones use self-attention mixers (the solver "
                             "is inapplicable to AR decode, not to the architecture)")


def init_diffusion_lm(cfg: DiffusionLMConfig, seed: int = 0, *,
                      device="cuda") -> Dict[str, Any]:
    """Fresh parameters (reference :56), drawn from a ``torch.Generator``
    seeded ``seed`` on ``device`` (the card unless the caller asks for the
    CPU)."""
    bb = cfg.backbone
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, bb.dtype)
    emb = torch.randn(bb.vocab_size, cfg.embed_dim, generator=g, device=dev)
    emb = emb / torch.linalg.norm(emb, dim=1, keepdim=True)

    def init_layer():
        return {"attn": init_attention(bb, "A", g),
                "mlp": init_mlp(bb.d_model, bb.d_ff, bb.glu, generator=g, dtype=dtype),
                "norm1": init_norm(bb.d_model, bb.norm_type, dtype, dev),
                "norm2": init_norm(bb.d_model, bb.norm_type, dtype, dev)}

    draw = lambda shape: dense_init(shape, generator=g, dtype=dtype)
    return {
        "token_embed": emb.to(dtype),  # frozen
        "in_proj": draw((cfg.embed_dim, bb.d_model)),
        "t_w1": draw((cfg.t_dim, bb.d_model)),
        "t_w2": draw((bb.d_model, bb.d_model)),
        "layers": _stack([init_layer() for _ in range(bb.num_repeats)]),
        "final_norm": init_norm(bb.d_model, bb.norm_type, dtype, dev),
        "out_proj": torch.zeros(bb.d_model, cfg.embed_dim, dtype=dtype, device=dev),
    }


def params_from_jax(tree: Mapping[str, Any], cfg: DiffusionLMConfig,
                    device="cpu") -> Dict[str, Any]:
    """The reference's ``init_diffusion_lm`` tree (nested dicts of numpy
    arrays or tensors) → the port's parameters on ``device`` holding the
    same values."""
    params = init_diffusion_lm(cfg, device=device)
    with torch.no_grad():
        _copy_tree(params, tree, "")
    return params


def liven(params: Dict[str, Any], generator: torch.Generator,
          scale: float = 0.02) -> Dict[str, Any]:
    """Fill the zero-init ``out_proj`` with ``scale``·N(0, 1) in place, so
    that the net's output is not identically 0."""
    w = params["out_proj"]
    with torch.no_grad():
        w.copy_(scale * torch.randn(w.shape, generator=generator, device=generator.device))
    return params


def trainable(params: Dict[str, Any]) -> Dict[str, Tensor]:
    """The leaves that training moves (all but the frozen ``token_embed``),
    flat by path ("layers/attn/wq"): the same tensor objects, so an
    optimizer that updates them in place (``optim.AdamW``) updates
    ``params``."""
    flat: Dict[str, Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{path}{k}/")
            elif f"{path}{k}" != "token_embed":
                flat[f"{path}{k}"] = v

    walk(params, "")
    return flat


def diffusion_lm_forward(params, x: Tensor, t: Tensor, cfg: DiffusionLMConfig) -> Tensor:
    """x (B, S, D_e) noisy embeddings, t (B,) → the noise prediction
    (reference :87)."""
    bb = cfg.backbone
    h = x @ params["in_proj"]
    temb = timestep_embedding(t, cfg.t_dim).to(h.dtype)
    temb = F.silu(temb @ params["t_w1"]) @ params["t_w2"]
    h = h + temb[:, None, :]
    for r in range(bb.num_repeats):
        lp = _layer(params["layers"], r)
        hn = apply_norm(h, bb.norm_type, lp["norm1"])
        q = torch.einsum("bse,ehd->bshd", hn, lp["attn"]["wq"])
        k = torch.einsum("bse,ehd->bshd", hn, lp["attn"]["wk"])
        v = torch.einsum("bse,ehd->bshd", hn, lp["attn"]["wv"])
        att = _ref_attention(q, k, v, causal=False, window=None, softcap=0.0)
        h = h + torch.einsum("bshd,hde->bse", att, lp["attn"]["wo"])
        hn = apply_norm(h, bb.norm_type, lp["norm2"])
        mlp = lp["mlp"]
        h = h + apply_mlp(hn, mlp["w_in"], mlp["w_out"], mlp.get("w_gate"), act=bb.act)
    h = apply_norm(h, bb.norm_type, params["final_norm"])
    return h @ params["out_proj"]


def embed(params, tokens: Tensor) -> Tensor:
    return params["token_embed"].detach()[tokens.long()]


def round_to_tokens(params, x0_hat: Tensor) -> Tensor:
    """Nearest-embedding decoding: argmax over E·x̂₀, int32."""
    sims = torch.einsum("bsd,vd->bsv", x0_hat, params["token_embed"])
    return torch.argmax(sims, dim=-1).to(torch.int32)


def graph_state(params, cfg: DiffusionLMConfig) -> tuple:
    """What a cached graph of the net's forward depends on:
    ``layers.graph_state`` of its parameter tree under ``cfg``."""
    return layers.graph_state(params, cfg)


def make_score_fn(params, cfg: DiffusionLMConfig, sde):
    """s(x, t) = −net(x, t)/std(t); the score carries the net's
    ``graph_state``, which keys the solvers' graph cache on it."""
    def score(x: Tensor, t: Tensor) -> Tensor:
        _, std = sde.marginal(t)
        return -diffusion_lm_forward(params, x, t, cfg) / std.reshape(-1, 1, 1)

    score.graph_state = lambda: graph_state(params, cfg)
    return score


def diffusion_lm_loss(params, cfg: DiffusionLMConfig, sde, tokens: Tensor,
                      generator: Optional[torch.Generator] = None, *,
                      t: Optional[Tensor] = None, z: Optional[Tensor] = None) -> Tensor:
    """DSM on the embeddings (paper Eq. 3 in the embedding space). t ~
    U[t_eps, T] and z ~ N(0, I) come from ``generator`` unless given (the
    seams through which tests pass the reference's draws)."""
    x0 = embed(params, tokens)
    B = x0.shape[0]
    if (t is None or z is None) and generator is None:
        raise ValueError("diffusion_lm_loss needs a generator unless both t and z are given")
    if t is None:
        u = torch.rand(B, generator=generator, dtype=torch.float32, device=x0.device)
        t = sde.t_eps + u * (sde.T - sde.t_eps)
    if z is None:
        z = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
    xt = sde.perturb(x0, t, z)
    pred = diffusion_lm_forward(params, xt, t, cfg)
    return 0.5 * torch.mean(torch.sum((pred - z) ** 2, dim=-1))


def generate(params, cfg: DiffusionLMConfig, sde, batch: int, seq: int, *, seed: int = 0,
             method: str = "adaptive", device="cuda", prior: Optional[Tensor] = None,
             **solver_kw):
    """Sample token sequences with the paper's solver (reference :143);
    returns (tokens (B, S) int32, SolveResult). The solve is
    ``core.sampling.sample`` seeded ``seed``; ``prior`` (B, S, D_e) starts
    it from given x_T instead (the solver's ``noise_fn`` then feeds its
    draws: the seam through which tests replay the reference's)."""
    dev = resolve_device(device)
    score = make_score_fn(params, cfg, sde)
    shape = (batch, seq, cfg.embed_dim)
    if prior is None:
        res = sample(sde, score, shape, seed=seed, method=method, device=dev, **solver_kw)
    else:
        if tuple(prior.shape) != shape:
            raise ValueError(f"prior of shape {tuple(prior.shape)}, want {shape}")
        res = get_solver(method)(sde, score, prior.to(dev), None, device=dev, **solver_kw)
    return round_to_tokens(params, res.x), res
