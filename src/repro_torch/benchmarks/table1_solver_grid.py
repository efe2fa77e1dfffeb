"""Paper Table 1 analog: NFE and quality of every solver on VP and VE;
port of ``benchmarks/table1_solver_grid.py``.

Grid: {reverse-diffusion + Langevin (``pc``, 1000 steps), EM-1000,
DDIM-100 (VP only), the probability-flow ODE at rtol = atol = 1e-5, the
adaptive solver at ε_rel ∈ {0.01, 0.02, 0.05, 0.10, 0.50} with EM (and
DDIM on VP) at each adaptive row's NFE} × {VP, VE}, N = 4096 samples of
the 4-mode ``GMM2D`` from ``TOY_MLP`` nets trained here
(``common.trained_mlp``, 600 steps). Quality: the Fréchet distance on
raw features and sliced W2 against 4096 data draws; speed: mean NFE per
sample, and the synchronised µs of the solve.

On the card the adaptive rows run the fused solver step (K1,
``use_fused_kernel=True``) and the EM and PC rows the fused EM update
(K5), the port's only path there; DDIM and the ODE have no kernel, as in
the reference. On the CPU the same wrappers take their plain versions.

  python -m repro_torch.benchmarks.table1_solver_grid [--device cpu] [--n N] [--steps S]
"""

from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import (
    emit, gmm_data, solve_row, trained_mlp_score,
)
from repro_torch.device import resolve_device

N_SAMPLES = 4096
EPS_GRID = (0.01, 0.02, 0.05, 0.10, 0.50)


def run(process: str, device="cuda", *, n: int = N_SAMPLES, steps: int = 600,
        eps_grid=EPS_GRID) -> list:
    """Every row of one process's table, as dicts (``common.solve_row``)."""
    dev = resolve_device(device)
    sde, score_fn = trained_mlp_score(process, steps=steps, device=dev)
    data = gmm_data(n, 7)
    rows = []

    def bench(name, method, **kw):
        rows.append(solve_row(f"table1/{process}/{name}", sde, score_fn, (n, 2), seed=42,
                              device=dev, data=data, method=method, **kw))
        return rows[-1]["nfe"]

    # baselines (the paper's solver settings)
    bench("reverse-langevin", "pc", n_steps=1000)
    bench("em-1000", "em", n_steps=1000)
    if process == "vp":
        bench("ddim-100", "ddim", n_steps=100)
    bench("prob-flow-ode", "ode", rtol=1e-5, atol=1e-5)
    # ours at each tolerance, and EM/DDIM at the matched budget
    for eps in eps_grid:
        nfe = bench(f"ours-eps{eps}", "adaptive", eps_rel=eps, use_fused_kernel=True)
        matched = max(int(nfe), 2)
        bench(f"em-match-eps{eps}", "em", n_steps=matched)
        if process == "vp":
            bench(f"ddim-match-eps{eps}", "ddim", n_steps=matched)
    return rows


def derived(r: dict) -> str:
    return f"nfe={r['nfe']:.0f};frechet={r['frechet']:.4f};sw2={r['sw2']:.4f}"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N_SAMPLES)
    ap.add_argument("--steps", type=int, default=600, help="training steps of each net")
    args = ap.parse_args(argv)
    rows = []
    for process in ("vp", "ve"):
        for r in run(process, args.device, n=args.n, steps=args.steps):
            emit(r["name"], r["us"], derived(r))
            rows.append(r)
    return rows


if __name__ == "__main__":
    main()
