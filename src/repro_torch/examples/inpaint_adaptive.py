"""Checkerboard-mask inpainting and colorization with the adaptive solver,
no checkpoint needed (DESIGN.md §9); port of
``examples/inpaint_adaptive.py``, with a colorization run beside it.

An exactly solvable per-pixel Gaussian process stands in for a trained
score network, so every claim can be checked: observed pixels (the gray
component, for colorization) are projected after every accepted step,
re-noised to each sample's own t, and pinned exactly at delivery; the
free region still lands on the true distribution; the NFE overhead
against the unconditional solve stays small (projection costs no score
evaluations).

  PYTHONPATH=src python -m repro_torch.examples.inpaint_adaptive [--device cpu] [--batch 64]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.guidance import colorize, inpaint, to_gray
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VESDE
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.device import resolve_device

H = W = 16  # 16×16×3 images
C = 3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    sde = VESDE(sigma_max=30.0)

    # per-pixel Gaussian data: mean mu (H, W, C), std s; the exact score
    mu = 0.5 + 0.1 * torch.randn(H, W, C, generator=g, device=dev)
    s = 0.05 + 0.2 * torch.rand(H, W, C, generator=g, device=dev)

    def score(x, t):
        m, std = sde.marginal(t)
        m, std = m.reshape(-1, 1, 1, 1), std.reshape(-1, 1, 1, 1)
        return -(x - m * mu) / ((m * s) ** 2 + std ** 2)

    shape = (args.batch, H, W, C)
    # a "photo" to damage: one draw from the data distribution
    truth = mu + s * torch.randn(shape, generator=g, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    checker = (((yy // 4 + xx // 4) % 2) == 0)[None, :, :, None]
    mask = checker.expand(shape).to(torch.float32)

    res_u = sample(sde, score, shape, seed=0, eps_rel=0.02, device=dev)
    conditioner, cond = inpaint(mask, truth)
    res = sample(sde, score, shape, seed=0, device=dev, cond=cond,
                 config=AdaptiveConfig(eps_rel=0.02, conditioner=conditioner))
    gray = to_gray(truth)
    c_col, cond_col = colorize(gray)
    res_c = sample(sde, score, shape, seed=0, device=dev, cond=cond_col,
                   config=AdaptiveConfig(eps_rel=0.02, conditioner=c_col))

    obs_resid = float(((res.x - truth) * mask).abs().max())
    n_free = float((1 - mask).sum())
    free = res.x * (1 - mask)
    free_mean_err = float(((free.sum(0) / args.batch - mu * (1 - mask[0])).sum()
                           / n_free * args.batch).abs())
    gray_resid = float((to_gray(res_c.x) - gray).abs().max())
    rec = {"unconditional_nfe": float(res_u.mean_nfe), "inpaint_nfe": float(res.mean_nfe),
           "colorize_nfe": float(res_c.mean_nfe), "observed_residual": obs_resid,
           "free_mean_err": free_mean_err, "gray_residual": gray_resid,
           "nfe_ratio": float(res.mean_nfe) / float(res_u.mean_nfe)}
    print(f"{'':24s}{'NFE':>8s}{'iters':>8s}")
    for name, r in (("unconditional", res_u), ("checkerboard inpaint", res),
                    ("colorize", res_c)):
        print(f"{name:24s}{float(r.mean_nfe):8.0f}{int(r.iterations):8d}")
    print(f"\nobserved-pixel residual (exact pin at delivery): {obs_resid:.2e}")
    print(f"gray residual of the colorized samples:        {gray_resid:.2e}")
    print(f"free-region mean error vs true per-pixel mean:   {free_mean_err:.4f}")
    print(f"NFE ratio inpaint/unconditional: {rec['nfe_ratio']:.2f}x (projection costs "
          "no score evaluations)")
    return rec


if __name__ == "__main__":
    main()
