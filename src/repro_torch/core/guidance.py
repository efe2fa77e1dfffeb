"""Controlled generation as score-field transforms; port of
``repro/core/guidance.py`` (``Conditioner``, the functional
``classifier_free``, ``ClassifierFree``, ``class_conditional``,
``Inpaint``, ``inpaint``, ``gray_basis``, ``Colorize``, ``colorize``,
``to_gray``, ``cond_batch``).

A conditioner has two halves (DESIGN.md §9):

  * the static half, a frozen dataclass holding no tensors, which lives
    in ``AdaptiveConfig.conditioner``;
  * the per-sample payload ``cond``, a dict of tensors that all lead
    with the batch dimension (labels (B,), masks (B, ...)), which lives
    in ``SolverCarry.cond``.

``conditioner=None`` leaves every code path as it was: no extra noise
draw, no extra cast. ``ClassifierFree`` at scale 0 evaluates the single
null-labelled forward; ``inpaint(None, ...)`` returns no conditioner at
all. Projection math runs in fp32 under every precision preset.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.sde import bcast

Tensor = torch.Tensor

#: class id meaning "unconditional" in a classifier-free payload
NULL_LABEL = -1


def _f32(*tensors):
    return tuple(a.to(torch.float32) for a in tensors)


@dataclasses.dataclass(frozen=True)
class Conditioner:
    """Protocol for score-field conditioning (DESIGN.md §9); the base
    class is the identity conditioner.

    Hooks:
      * ``wrap_score(score_fn, cond)``: the transformed score field for
        the batch payload; called inside the solver body.
      * ``project(sde, x, t, cond, z)``: post-accept projection at each
        sample's new time t, re-noising observed data with the fp32
        standard-normal ``z``; returns fp32.
      * ``finalize_project(x, cond)``: exact, noise-free constraint
        replacement on the delivered sample.
      * ``cond_struct(batch, sample_shape)``: the payload's structure, as
        ``meta`` tensors (shape and dtype, no storage), or None.
    """

    #: True for conditioners whose ``project`` does work; the solver
    #: draws projection noise only then, so unconditional noise streams
    #: stay untouched
    has_projection = False

    def wrap_score(self, score_fn: Callable, cond: Any) -> Callable:
        return score_fn

    def project(self, sde, x: Tensor, t: Tensor, cond: Any, z: Tensor) -> Tensor:
        return x

    def finalize_project(self, x: Tensor, cond: Any) -> Tensor:
        return x

    def cond_struct(self, batch: int, sample_shape) -> Any:
        return None

    def neutral_cond(self, batch: int, sample_shape) -> Any:
        """A payload that makes the conditioner a no-op: zeros of
        ``cond_struct`` by default (a zero mask projects nothing)."""
        struct = self.cond_struct(batch, sample_shape)
        if struct is None:
            return None
        return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in struct.items()}


def classifier_free(cond_score: Callable, uncond_score: Callable,
                    scale: float) -> Callable:
    """The functional classifier-free transform s_u + w·(s_c − s_u) of two
    plain ``s(x, t)`` fields, for solvers that take no conditioner (the
    fixed-grid baselines): fp32 arithmetic, cast back to the unconditional
    score's dtype. ``scale == 0`` returns ``uncond_score`` itself."""
    if scale == 0.0:
        return uncond_score

    def guided(x: Tensor, t: Tensor) -> Tensor:
        s_u = uncond_score(x, t)
        u32, c32 = _f32(s_u, cond_score(x, t))
        return (u32 + scale * (c32 - u32)).to(s_u.dtype)

    return guided


@dataclasses.dataclass(frozen=True)
class ClassifierFree(Conditioner):
    """Classifier-free guidance over a label-aware score
    ``score_fn(x, t, y)`` (DESIGN.md §9); payload ``{"label": (B,) int}``.

    The guided field is one forward over 2B rows, ``[x; x]`` with labels
    ``[y; null]``, combined as s_u + w·(s_c − s_u) in fp32 and cast back
    to the score's dtype. ``scale == 0`` evaluates the single
    null-labelled forward instead.
    """

    scale: float = 1.0
    null_label: int = NULL_LABEL

    def wrap_score(self, score_fn: Callable, cond: Any) -> Callable:
        y = cond["label"]
        null = torch.full_like(y, self.null_label)
        if self.scale == 0.0:
            return lambda x, t: score_fn(x, t, null)

        def guided(x: Tensor, t: Tensor) -> Tensor:
            b = x.shape[0]
            s2 = score_fn(torch.cat([x, x]), torch.cat([t, t]),
                          torch.cat([y, null]))  # one forward over 2B rows
            c32, u32 = _f32(s2[:b], s2[b:])
            return (u32 + self.scale * (c32 - u32)).to(s2.dtype)

        return guided

    def cond_struct(self, batch: int, sample_shape) -> Any:
        return {"label": torch.empty((batch,), dtype=torch.int32, device="meta")}

    def neutral_cond(self, batch: int, sample_shape) -> Any:
        """The null label (unconditional), not class 0."""
        return {"label": torch.full((batch,), self.null_label, dtype=torch.int32)}


def class_conditional(labels, scale: float, *,
                      null_label: int = NULL_LABEL) -> Tuple[ClassifierFree, Any]:
    """(conditioner, payload) for class-conditional sampling with
    integer ``labels`` (B,)."""
    return (ClassifierFree(scale=float(scale), null_label=null_label),
            {"label": torch.as_tensor(labels).to(torch.int32)})


@dataclasses.dataclass(frozen=True)
class Inpaint(Conditioner):
    """Inpainting as post-accept projection (Song et al. 2021 App. I;
    DESIGN.md §9). Payload ``{"mask", "observed"}``, fp32, shaped like
    the sample; mask 1 marks observed coordinates. After every accepted
    step, at each sample's own new t:

        x ← mask · (m(t)·observed + std(t)·z) + (1 − mask) · x

    in fp32; ``finalize_project`` pins the observed coordinates to
    ``observed`` exactly. A zero mask makes both the identity.
    """

    has_projection = True

    def project(self, sde, x: Tensor, t: Tensor, cond: Any, z: Tensor) -> Tensor:
        m, s = sde.marginal(t)
        x32, mask, obs, z32, m32, s32 = _f32(x, cond["mask"], cond["observed"],
                                             z, m, s)
        obs_t = bcast(m32, x32) * obs + bcast(s32, x32) * z32
        return mask * obs_t + (1.0 - mask) * x32

    def finalize_project(self, x: Tensor, cond: Any) -> Tensor:
        mask, obs = _f32(cond["mask"], cond["observed"])
        return (mask * obs + (1.0 - mask) * x.to(torch.float32)).to(x.dtype)

    def cond_struct(self, batch: int, sample_shape) -> Any:
        shape = (batch,) + tuple(sample_shape)
        return {k: torch.empty(shape, dtype=torch.float32, device="meta")
                for k in ("mask", "observed")}


def inpaint(mask, observed) -> Tuple[Optional[Inpaint], Any]:
    """(conditioner, payload) for inpainting; ``mask=None`` returns
    ``(None, None)``, the unconditional path."""
    if mask is None:
        return None, None
    return Inpaint(), {"mask": torch.as_tensor(mask).to(torch.float32),
                       "observed": torch.as_tensor(observed).to(torch.float32)}


def gray_basis(channels: int) -> Tensor:
    """Orthonormal channel basis (C, C) fp32 whose row 0 is the gray
    direction 1/√C (Song et al. 2021 App. I.2, DESIGN.md §9): the
    Householder reflection taking e₀ to 1/√C, computed in fp64 and
    rounded once."""
    c = int(channels)
    g = torch.full((c,), 1.0 / math.sqrt(c), dtype=torch.float64)
    v = g - torch.eye(c, dtype=torch.float64)[0]
    n2 = float(v @ v)
    eye = torch.eye(c, dtype=torch.float64)
    m = eye if n2 < 1e-12 else eye - 2.0 * torch.outer(v, v) / n2
    return m.T.contiguous().to(torch.float32)


def _rotate(x32: Tensor, basis: Tensor) -> Tensor:
    """Trailing channels into the gray basis: u = x · basisᵀ."""
    return torch.einsum("...c,dc->...d", x32, basis.to(x32.device))


def _unrotate(u: Tensor, basis: Tensor) -> Tensor:
    return torch.einsum("...d,dc->...c", u, basis.to(u.device))


@dataclasses.dataclass(frozen=True)
class Colorize(Conditioner):
    """Colorization: inpainting of the gray coordinate in the rotated
    channel basis of ``gray_basis`` (DESIGN.md §9). After every accepted
    step, u₀ ← m(t)·gray + std(t)·z at each sample's own t, in fp32, then
    back to the channel basis; ``finalize_project`` pins u₀ = gray
    exactly. Payload ``{"gray": (B, ..., 1)}`` fp32."""

    has_projection = True
    channels: int = 3

    def project(self, sde, x: Tensor, t: Tensor, cond: Any, z: Tensor) -> Tensor:
        basis = gray_basis(self.channels)
        m, s = sde.marginal(t)
        x32, gray, z32, m32, s32 = _f32(x, cond["gray"], z, m, s)
        u = _rotate(x32, basis)
        gray_t = bcast(m32, gray) * gray + bcast(s32, gray) * z32[..., :1]
        return _unrotate(torch.cat([gray_t, u[..., 1:]], dim=-1), basis)

    def finalize_project(self, x: Tensor, cond: Any) -> Tensor:
        basis = gray_basis(self.channels)
        x32, gray = _f32(x, cond["gray"])
        u = _rotate(x32, basis)
        return _unrotate(torch.cat([gray, u[..., 1:]], dim=-1), basis).to(x.dtype)

    def cond_struct(self, batch: int, sample_shape) -> Any:
        shape = (batch,) + tuple(sample_shape[:-1]) + (1,)
        return {"gray": torch.empty(shape, dtype=torch.float32, device="meta")}


def colorize(gray, channels: int = 3) -> Tuple[Optional[Colorize], Any]:
    """(conditioner, payload) for colorization from the known gray
    component ⟨x, 1⟩/√C, (B, ..., 1) (a (B, ...) without the trailing
    channel gains it); ``gray=None`` returns ``(None, None)``."""
    if gray is None:
        return None, None
    g = torch.as_tensor(gray).to(torch.float32)
    if g.shape[-1] != 1:
        g = g[..., None]
    return Colorize(channels=channels), {"gray": g}


def to_gray(x, channels: int = 3) -> Tensor:
    """The gray component ⟨x, 1⟩/√C over the trailing channel axis, kept
    as a singleton channel (``gray_basis``'s convention)."""
    x32 = torch.as_tensor(x).to(torch.float32)
    return torch.einsum("...c,c->...", x32, gray_basis(channels)[0].to(x32.device))[..., None]


def cond_batch(cond: Any) -> Optional[int]:
    """The batch dimension every payload leaf leads with, or None for an
    empty payload. Raises if the leaves disagree."""
    leaves = list(cond.values()) if isinstance(cond, dict) else []
    if not leaves:
        return None
    sizes = {int(v.shape[0]) for v in leaves}
    if len(sizes) != 1:
        raise ValueError(f"condition payload leaves disagree on the batch dim: {sizes}")
    return sizes.pop()
