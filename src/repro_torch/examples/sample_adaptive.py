"""Tolerance sweep on an exactly solvable high-dimensional process (the
paper's Figure 1 speed/quality trade-off) and per-sample adaptive
stepping, each sample finishing at its own NFE; port of
``examples/sample_adaptive.py``. The zoo's families (heavy-ball
``momentum`` and the probability-flow ``heun``) join the sweep.

  PYTHONPATH=src python -m repro_torch.examples.sample_adaptive [--device cpu] [--batch 64]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.sampling import sample
from repro_torch.core.sde import VESDE
from repro_torch.device import resolve_device

D = 3072  # CIFAR's dimensionality

ROWS = [
    ("em-2000 (baseline)", "em", dict(n_steps=2000)),
    ("ours eps_rel=0.01", "adaptive", dict(eps_rel=0.01)),
    ("ours eps_rel=0.02", "adaptive", dict(eps_rel=0.02)),
    ("ours eps_rel=0.05", "adaptive", dict(eps_rel=0.05)),
    ("ours eps_rel=0.10", "adaptive", dict(eps_rel=0.10)),
    ("momentum eps_rel=0.05", "momentum", dict(eps_rel=0.05)),
    ("heun eps_rel=0.05", "heun", dict(eps_rel=0.05)),
    ("prob-flow ODE", "ode", {}),
]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    mu = 0.5 * torch.randn(D, generator=g, device=dev)
    s = 0.05 + 0.45 * torch.rand(D, generator=g, device=dev)
    sde = VESDE(sigma_max=30.0)

    def score(x, t):
        m, std = sde.marginal(t)
        var = (m[:, None] * s[None, :]) ** 2 + std[:, None] ** 2
        return -(x - m[:, None] * mu[None, :]) / var

    print(f"{'method':28s}{'NFE':>8s}{'iters':>8s}{'rej%':>7s}{'mean err':>10s}{'std err':>9s}")
    out = []
    for name, method, kw in ROWS:
        res = sample(sde, score, (args.batch, D), seed=0, method=method, device=dev, **kw)
        me = float((res.x.mean(0) - mu).abs().mean())
        se = float((res.x.std(0) - s).abs().mean())
        tot = float((res.accepted + res.rejected).sum())
        rej = 100 * float(res.rejected.sum()) / max(tot, 1)
        print(f"{name:28s}{float(res.mean_nfe):8.0f}{int(res.iterations):8d}"
              f"{rej:7.1f}{me:10.4f}{se:9.4f}")
        out.append(dict(name=name, nfe=float(res.mean_nfe), mean_err=me, std_err=se))

    # per-sample adaptivity: the spread of NFE within one batch
    res = sample(sde, score, (args.batch, D), seed=0, method="adaptive", eps_rel=0.02,
                 device=dev)
    nfe = res.nfe.cpu()
    print(f"\nper-sample NFE within one batch: min {int(nfe.min())} / median "
          f"{int(nfe.median())} / max {int(nfe.max())} (paper Sec. 3.1.5: every sample "
          "steps at its own pace)")
    return out


if __name__ == "__main__":
    main()
