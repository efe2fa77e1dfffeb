"""Paper Tables 4–5 analog: ablations of Algorithm 1 on VP and VE; port
of ``benchmarks/table45_ablations.py``.

Rows (paper App. B): no change; δ(x') in place of δ(x', x'_prev); no
extrapolation; q = ∞; r ∈ {0.5, 0.8, 1.0}; the Lamba-variant
combinations; each at ε_rel = 0.05 on N = 2048 samples of the 4-mode
mixture from the ``TOY_MLP`` nets of ``common.trained_mlp``. Reported:
NFE, the Fréchet distance and the rejection rate (``rej``). On the card
the ℓ2 variants run the fused solver step (K1), the ℓ∞ ones the plain
step (the kernel implements ℓ2 only).

  python -m repro_torch.benchmarks.table45_ablations [--device cpu] [--n N] [--steps S]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.benchmarks.common import (
    emit, gmm_data, solve_row, trained_mlp_score,
)
from repro_torch.benchmarks.table3_offtheshelf import fused
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.device import resolve_device

N = 2048

BASE = AdaptiveConfig(eps_rel=0.05)

VARIANTS = {
    "no-change": {},
    "delta-no-prev": dict(prev_tolerance=False),
    "no-extrapolation": dict(extrapolate=False),
    "q-inf": dict(error_norm="linf"),
    "r0.5": dict(r_exponent=0.5),
    "r0.8": dict(r_exponent=0.8),
    "r1.0": dict(r_exponent=1.0),
    "lamba-r0.5": dict(extrapolate=False, r_exponent=0.5, prev_tolerance=False),
    "lamba-linf-theta0.8": dict(extrapolate=False, r_exponent=0.5,
                                error_norm="linf", safety=0.8),
}


def run(device="cuda", *, n: int = N, steps: int = 600) -> list:
    dev = resolve_device(device)
    rows = []
    for process in ("vp", "ve"):
        sde, score_fn = trained_mlp_score(process, steps=steps, device=dev)
        data = gmm_data(n, 17)
        for name, mods in VARIANTS.items():
            cfg = fused(dataclasses.replace(BASE, **mods))
            rows.append(solve_row(f"table45/{process}/{name}", sde, score_fn, (n, 2),
                                  seed=21, device=dev, data=data, method="adaptive",
                                  config=cfg))
    return rows


def derived(r: dict) -> str:
    return f"nfe={r['nfe']:.0f};frechet={r['frechet']:.4f};rej={r['rej']:.3f}"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--steps", type=int, default=600, help="training steps of each net")
    args = ap.parse_args(argv)
    rows = run(args.device, n=args.n, steps=args.steps)
    for r in rows:
        emit(r["name"], r["us"], derived(r))
    return rows


if __name__ == "__main__":
    main()
