"""Per-workload solver auto-selection: the fewest NFE at a fixed W2 gate
(DESIGN.md §11); port of ``repro/analysis/solver_select.py``.

From conformance rows, one per (solver, workload), pick per workload the
cheapest solver (lowest mean NFE) among those that pass their own W2
gate. ``ZOO`` is the one spec of the raced configurations: registered
solver → conformance keywords and gate. The port's tests and
``chip_smoke.py`` read their gates from it. Gates are per solver: the PC
family is variance-biased on coarse grids and carries 0.25, which does
not hand it the win unless it also spends the fewest NFE.

``conformance_row`` makes a row on the port itself: the solver on the
closed-form Gaussian score of ``core/analytic.py``, W2 of its samples at
t_eps to the exact marginal. ``write_selection`` writes the report into
the directory its caller names; the port writes nothing by default.
"""

from __future__ import annotations

import json
import os

#: registered solver → {kwargs, tol[, vp_only]}: 0.08 for solvers expected
#: at EM-200's error, 0.10 for DDIM-50, 0.25 for the PC family
ZOO = {
    "em": dict(kwargs=dict(n_steps=200), tol=0.08),
    "adaptive": dict(kwargs=dict(eps_rel=0.05), tol=0.08),
    "momentum": dict(kwargs=dict(eps_rel=0.05), tol=0.08),
    "heun": dict(kwargs=dict(eps_rel=0.05), tol=0.08),
    "ode": dict(kwargs={}, tol=0.08),
    "pc": dict(kwargs=dict(n_steps=100), tol=0.25),
    "pc_hmc": dict(kwargs=dict(n_steps=100), tol=0.25),
    "ddim": dict(kwargs=dict(n_steps=50), tol=0.10, vp_only=True),
}

#: the conformance suite's data and batch: x0 ~ N(MU, S0²), (BATCH, DIM)
MU, S0 = 0.3, 0.5
BATCH, DIM = 512, 8


def zoo_cases() -> dict:
    """(kwargs, tol) per solver: the conformance suite's case table."""
    return {name: (dict(spec["kwargs"]), spec["tol"]) for name, spec in ZOO.items()}


def conformance_row(solver: str, sde_name: str, sde, *, seed: int = 0, device="cuda",
                    batch: int = BATCH, dim: int = DIM, **overrides) -> dict:
    """One summary row of ``solver`` on ``sde`` (named ``sde_name``): its
    ``ZOO`` keywords (``overrides`` on top) on the closed-form score, no
    denoise, the port's own RNG from ``seed``; W2 to the exact marginal
    at t_eps, mean NFE, the gate and the solve's iterations."""
    from repro_torch.core import analytic
    from repro_torch.core.precision import resolve_policy
    from repro_torch.core.sampling import sample

    kw, tol = zoo_cases()[solver]
    kw.update(overrides)
    res = sample(sde, analytic.gaussian_score(sde, MU, S0), (batch, dim), seed=seed,
                 method=solver, denoise=False, device=device, **kw)
    x = res.x.double()
    mean, std = x.mean().item(), x.std(unbiased=False).item()
    mu_a, s_a = analytic.gaussian_marginal_moments(sde, MU, S0)
    precision = resolve_policy(kw.get("precision")).name
    return {"solver": solver, "sde": sde_name, "precision": precision, "conditioner": "none",
            "mean_err": abs(mean - mu_a), "std_err": abs(std - s_a),
            "w2": analytic.gaussian_w2(mean, std, mu_a, s_a),
            "mean_nfe": float(res.mean_nfe), "tol": tol, "iterations": int(res.iterations)}


def select(rows) -> dict:
    """Per-workload ranking and winner from conformance rows (dicts with
    at least solver / sde / w2 / mean_nfe / tol). Only fp32, unconditioned
    rows of zoo solvers are ranked; the workload is the row's ``sde``.
    Returns {workload: {ranking, winner, winner_nfe, adaptive_nfe}}, the
    ranking by mean NFE ascending, the winner its cheapest passing entry."""
    by_workload: dict = {}
    for r in rows:
        if r.get("solver") not in ZOO:
            continue
        if r.get("precision", "fp32") != "fp32":
            continue
        if r.get("conditioner", "none") not in (None, "none"):
            continue
        by_workload.setdefault(r["sde"], []).append(r)

    report = {}
    for workload, wrows in sorted(by_workload.items()):
        ranking = [{"solver": r["solver"], "w2": float(r["w2"]), "tol": float(r["tol"]),
                    "mean_nfe": float(r["mean_nfe"]),
                    "passes": float(r["w2"]) < float(r["tol"])}
                   for r in sorted(wrows, key=lambda r: float(r["mean_nfe"]))]
        winner = next((e for e in ranking if e["passes"]), None)
        adaptive_entry = next((e for e in ranking if e["solver"] == "adaptive"), None)
        report[workload] = {
            "ranking": ranking,
            "winner": winner["solver"] if winner else None,
            "winner_nfe": winner["mean_nfe"] if winner else None,
            "adaptive_nfe": adaptive_entry["mean_nfe"] if adaptive_entry else None,
        }
    return report


def render_markdown(report: dict) -> str:
    """The selection report as markdown: the winners, then each workload's
    ranking."""
    lines = [
        "### Solver auto-selection (lowest NFE passing the W2 gate)",
        "",
        "| workload | winner | winner NFE | adaptive NFE | NFE vs adaptive |",
        "|---|---|---|---|---|",
    ]
    for workload, data in report.items():
        win, wn, an = data["winner"], data["winner_nfe"], data["adaptive_nfe"]
        ratio = f"{wn / an:.2f}x" if (wn and an) else "n/a"
        lines.append(
            f"| {workload} | {win or 'NONE PASSED'} | {wn:.0f} | {an:.0f} | {ratio} |"
            if wn is not None and an is not None
            else f"| {workload} | {win or 'NONE PASSED'} | - | - | {ratio} |")
    for workload, data in report.items():
        lines += ["", f"#### `{workload}`", "",
                  "| rank | solver | W2 | gate | mean NFE | passes |",
                  "|---|---|---|---|---|---|"]
        for i, e in enumerate(data["ranking"], 1):
            mark = "yes" if e["passes"] else "no"
            star = " (winner)" if e["solver"] == data["winner"] else ""
            lines.append(f"| {i} | {e['solver']}{star} | {e['w2']:.4f} "
                         f"| {e['tol']:.2f} | {e['mean_nfe']:.0f} | {mark} |")
    return "\n".join(lines) + "\n"


def write_selection(report: dict, out_dir: str):
    """Write selection.{md,json} into ``out_dir`` (made if missing);
    returns (md_path, json_path)."""
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, "selection.json")
    md_path = os.path.join(out_dir, "selection.md")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=1)
    with open(md_path, "w") as f:
        f.write(render_markdown(report))
    return md_path, json_path
