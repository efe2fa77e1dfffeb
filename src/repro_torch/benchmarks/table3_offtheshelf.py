"""Paper Table 3 / Appendix A analog: why off-the-shelf adaptive SDE
solvers fail on score-based reverse diffusions; port of
``benchmarks/table3_offtheshelf.py``.

The mechanisms, as variants of Algorithm 1 on the VP 4-mode mixture
(N = 2048, the ``TOY_MLP`` net of ``common.trained_mlp``):

  * lamba-style — the adaptive pair without extrapolation, the ℓ∞
    error, r = 0.5 and δ(x') (Lamba 2003's choices);
  * linf-only   — ours with the ℓ∞ norm (one coordinate stalls a sample);
  * tight-tol   — ours at ODE-solver tolerances, atol = 1e-6 and
    rtol = 1e-4 (high-order solvers chasing needless precision);
  * ours        — the paper's algorithm.

Rows give NFE and the Fréchet distance, then each variant's NFE over
ours (``slowdown``). On the card the ℓ2 variants run the fused solver
step (K1); the fused kernel implements the ℓ2 norm only, so the ℓ∞
variants take the plain step.

  python -m repro_torch.benchmarks.table3_offtheshelf [--device cpu] [--n N] [--steps S]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.benchmarks.common import (
    emit, gmm_data, solve_row, trained_mlp_score,
)
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.device import resolve_device

N = 2048

VARIANTS = {
    "ours": AdaptiveConfig(eps_rel=0.05),
    "lamba-style": AdaptiveConfig(
        eps_rel=0.05, extrapolate=False, error_norm="linf",
        r_exponent=0.5, prev_tolerance=False,
    ),
    "linf-only": AdaptiveConfig(eps_rel=0.05, error_norm="linf"),
    "tight-tol": AdaptiveConfig(eps_rel=1e-4, eps_abs=1e-6),
}


def fused(cfg: AdaptiveConfig) -> AdaptiveConfig:
    """``cfg`` with the fused solver step wherever it applies (ℓ2)."""
    return dataclasses.replace(cfg, use_fused_kernel=cfg.error_norm == "l2")


def run(device="cuda", *, n: int = N, steps: int = 600) -> list:
    """The variant rows, then the ``-vs-ours`` rows (``slowdown``)."""
    dev = resolve_device(device)
    sde, score_fn = trained_mlp_score("vp", steps=steps, device=dev)
    data = gmm_data(n, 13)
    rows = [solve_row(f"table3/vp/{name}", sde, score_fn, (n, 2), seed=5, device=dev,
                      data=data, method="adaptive", config=fused(cfg))
            for name, cfg in VARIANTS.items()]
    base = rows[0]["nfe"]
    rows += [dict(name=f"{r['name']}-vs-ours", us=0.0, slowdown=r["nfe"] / base)
             for r in rows[1:]]
    return rows


def derived(r: dict) -> str:
    if "slowdown" in r:
        return f"slowdown={r['slowdown']:.2f}x"
    return f"nfe={r['nfe']:.0f};frechet={r['frechet']:.4f}"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--steps", type=int, default=600, help="training steps of the net")
    args = ap.parse_args(argv)
    rows = run(args.device, n=args.n, steps=args.steps)
    for r in rows:
        emit(r["name"], r["us"], derived(r))
    return rows


if __name__ == "__main__":
    main()
