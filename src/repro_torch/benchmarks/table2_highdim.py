"""The paper's Table 2 analog, high-dimensional generation; port of
``benchmarks/table2_highdim.py``.

At 196k dimensions the paper found that EM cannot converge at a moderate
NFE while the adaptive solver can. The analog keeps the mechanism at
D = 3072 (CIFAR's dimension), N = 256 samples, on the VE SDE with
σ_max = 30, with data from an anisotropic Gaussian N(μ, diag(s²)) whose
score is exact at every t: the comparison measures solver error alone,
with no network error.

Rows: the reverse-diffusion + Langevin PC sampler at 1000 steps, EM at
2000 steps, the probability-flow ODE at rtol = atol = 1e-5, the adaptive
solver at ε_rel ∈ {0.01, 0.02, 0.05, 0.10}, and EM at each adaptive
row's NFE. Columns: mean NFE, the Fréchet distance on the first 8
coordinates against N reference draws, the mean absolute error of the
per-coordinate means and standard deviations, and the wall seconds of
the solve (synchronised), with the solve's CUDA-graph captures (0: each
row's key is warmed up first, ``common.warm_up``), host reads and K5
launches.

μ and s come from a ``torch.Generator`` seeded 0 (the reference draws
them from ``PRNGKey(0)``), the solves from ``sample``'s streams of seed
3 and the reference draws from a generator seeded 11: the numbers are
the port's own, comparable with the reference's only in what they show,
not digit for digit.

  python -m repro_torch.benchmarks.table2_highdim [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import frechet_gaussian, warm_up
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VESDE
from repro_torch.core.solvers import adaptive as ad
from repro_torch.device import resolve_device
from repro_torch.kernels.solver_step import ops as step_ops

D = 3072
N = 256
EPS_RELS = (0.01, 0.02, 0.05, 0.10)


def setup(device, d: int = D, seed: int = 0):
    """(sde, exact score, reference sampler) of the anisotropic Gaussian."""
    g = torch.Generator(device=device).manual_seed(seed)
    mu = 0.5 * torch.randn(d, generator=g, device=device)
    # a diagonal covariance spanning two decades
    s = 0.05 + 0.45 * torch.rand(d, generator=g, device=device) ** 2
    sde = VESDE(sigma_max=30.0)

    def score(x, t):
        m, std = sde.marginal(t)
        var = (m[:, None] * s[None, :]) ** 2 + std[:, None] ** 2
        return -(x - m[:, None] * mu[None, :]) / var

    def reference(generator, n):
        return mu + s * torch.randn(n, d, generator=generator, device=device)

    return sde, score, reference


def run(device="cuda", *, n: int = N, d: int = D) -> list:
    """Every row of the table as a dict; the solves run on ``device``."""
    dev = resolve_device(device)
    sde, score, reference = setup(dev, d)
    data = reference(torch.Generator(device=dev).manual_seed(11), n).cpu().numpy()

    def solve(method, **kw):
        warm_up(sde, score, (n, d), dev, method, **kw)  # the row's key: first use, capture
        step_ops.em_launches = 0
        c0, r0 = ad.captures, ad.host_syncs
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = sample(sde, score, (n, d), seed=3, method=method, device=dev, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        return res, wall, dict(captures=ad.captures - c0, host_reads=ad.host_syncs - r0,
                               em_step=step_ops.em_launches)

    rows = []

    def bench(name, method, **kw):
        res, wall, books = solve(method, **kw)
        x = res.x.cpu().numpy().astype(np.float64)
        rows.append({
            "name": f"table2/ve-d{d}/{name}", "method": method,
            "nfe": float(res.mean_nfe), "iterations": int(res.iterations),
            "frechet8": frechet_gaussian(x[:, :8], data[:, :8]),
            "mean_err": float(np.abs(x.mean(0) - data.mean(0)).mean()),
            "std_err": float(np.abs(x.std(0) - data.std(0)).mean()),
            "wall_s": wall, "finite": bool(np.isfinite(x).all()), **books,
        })
        return rows[-1]["nfe"]

    bench("reverse-langevin", "pc", n_steps=1000)
    bench("em-2000", "em", n_steps=2000)
    bench("prob-flow-ode", "ode", rtol=1e-5, atol=1e-5)
    for eps in EPS_RELS:
        nfe = bench(f"ours-eps{eps}", "adaptive", eps_rel=eps)
        bench(f"em-match-eps{eps}", "em", n_steps=max(int(nfe), 2))
    return rows


def format_row(r: dict) -> str:
    return (f"{r['name']},{r['wall_s']:.4f},nfe={r['nfe']:.0f};"
            f"frechet8={r['frechet8']:.4f};mean_err={r['mean_err']:.4f};"
            f"std_err={r['std_err']:.4f}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.device)
    print("name,wall_s,derived")
    for r in rows:
        print(format_row(r))
    return rows


if __name__ == "__main__":
    main()
