"""Telemetry report generator (DESIGN.md §15); port of
``repro/analysis/telemetry.py``, numpy only. Renders a serve-loop
``trace_record()`` JSON (as ``repro_torch.launch.serve --trace-out`` or
``DiffusionBatcher.trace_record()`` writes it) into a markdown report:

  * per-stage latency table from the tracer's histograms (admission /
    solve / delivery / planner rounds);
  * per-request NFE CDF from the delivered-request books;
  * step-size-vs-t and accept-rate-vs-t curves binned from the
    step-telemetry ring (the paper's Fig. 2-style adaptivity picture:
    h grows over the reverse solve, rejections cluster near t = T).

Idle-slot ring records (t ≤ t_eps) are filtered out here, on the host:
the device writes every slot's column each recorded iteration, so the
filter is a read-time concern (DESIGN.md §15).

Usage:
  PYTHONPATH=src python -m repro_torch.analysis.telemetry --trace trace.json \
      [--out TELEMETRY.md]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def active_records(telemetry: Dict) -> Dict[str, np.ndarray]:
    """Flatten a trace record's ``telemetry`` block to 1-D arrays over
    *active* records only (t > t_eps): idle slots ride the device loop
    with t pinned at/below the floor and never accept, so they carry no
    solver information."""
    t = np.asarray(telemetry["t"], np.float64).ravel()
    h = np.asarray(telemetry["h"], np.float64).ravel()
    err = np.asarray(telemetry["err"], np.float64).ravel()
    acc = np.asarray(telemetry["accept"]).astype(bool).ravel()
    t_eps = float(telemetry.get("t_eps", 0.0))
    # replicate the device's fp32 activity test exactly: the ring holds
    # fp32 t, and idle slots sit at fp32(t_eps) — a float64 threshold
    # would misread them as live (fp32(1e-3) > 1e-3 in float64)
    live = t > float(np.float32(t_eps + 1e-12))
    return {"t": t[live], "h": h[live], "err": err[live], "accept": acc[live]}


def step_size_vs_t(telemetry: Dict, bins: int = 12) -> List[Dict]:
    """Bin the active ring records by solver time t: per bin the mean
    step size h, the accept rate, and the mean scaled error norm — the
    adaptivity curves the paper's step-size analysis plots."""
    rec = active_records(telemetry)
    if rec["t"].size == 0:
        return []
    lo, hi = float(rec["t"].min()), float(rec["t"].max())
    if hi <= lo:
        hi = lo + 1e-9
    edges = np.linspace(lo, hi, bins + 1)
    idx = np.clip(np.digitize(rec["t"], edges) - 1, 0, bins - 1)
    rows = []
    for b in range(bins):
        m = idx == b
        if not m.any():
            continue
        rows.append({
            "t_lo": float(edges[b]),
            "t_hi": float(edges[b + 1]),
            "records": int(m.sum()),
            "mean_h": float(rec["h"][m].mean()),
            "accept_rate": float(rec["accept"][m].mean()),
            "mean_err": float(rec["err"][m].mean()),
        })
    return rows


def nfe_percentiles(requests: Sequence[Dict],
                    qs: Sequence[float] = (0, 10, 25, 50, 75, 90, 100),
                    ) -> List[Dict]:
    """Per-request NFE CDF points (the spread slot refill exploits)."""
    nfes = np.asarray([r["nfe"] for r in requests], np.float64)
    if nfes.size == 0:
        return []
    return [{"pct": float(q), "nfe": float(np.percentile(nfes, q))}
            for q in qs]


def _md_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out)


def telemetry_markdown(trace: Dict) -> str:
    """The full markdown report for one trace record."""
    lines = ["# Serve-loop telemetry report", ""]

    reqs = trace.get("requests", [])
    if reqs:
        total_nfe = sum(r["nfe"] for r in reqs)
        acc = sum(r.get("accepted", 0) for r in reqs)
        rej = sum(r.get("rejected", 0) for r in reqs)
        misses = sum(bool(r.get("deadline_missed")) for r in reqs)
        lines += [
            f"Delivered **{len(reqs)}** requests, total NFE {total_nfe}, "
            f"accepted/rejected steps {acc}/{rej}, "
            f"deadline misses {misses}.",
            "",
        ]

    hist = trace.get("trace", {}).get("stage_histograms", {})
    if hist:
        lines += ["## Per-stage latency", ""]
        rows = [
            (name,
             s["count"],
             f"{s['mean_s'] * 1e3:.2f}",
             f"{s['max_s'] * 1e3:.2f}",
             f"{s['total_s'] * 1e3:.1f}")
            for name, s in sorted(hist.items())
        ]
        lines += [_md_table(
            ("stage", "spans", "mean ms", "max ms", "total ms"), rows), ""]

    if reqs:
        lines += ["## Per-request NFE CDF", ""]
        rows = [(f"p{p['pct']:.0f}", f"{p['nfe']:.0f}")
                for p in nfe_percentiles(reqs)]
        lines += [_md_table(("percentile", "NFE"), rows), ""]

    tel = trace.get("telemetry")
    if tel:
        lines += [
            "## Step size and accept rate vs t",
            "",
            f"{tel['records']} ring records over "
            f"{tel['iterations']} device iterations "
            f"(active records only; idle slots filtered at t_eps).",
            "",
        ]
        rows = [
            (f"[{r['t_lo']:.3f}, {r['t_hi']:.3f})",
             r["records"],
             f"{r['mean_h']:.4f}",
             f"{r['accept_rate']:.2f}",
             f"{r['mean_err']:.3f}")
            for r in step_size_vs_t(tel)
        ]
        if rows:
            lines += [_md_table(
                ("t bin", "records", "mean h", "accept rate", "mean err"),
                rows), ""]

    stats = trace.get("class_stats") or {}
    if stats:
        lines += ["## Per-tier delivery", ""]
        rows = [
            (name,
             s["delivered"],
             f"{s['mean_nfe']:.0f}",
             s["deadline_misses"],
             f"{s['mean_wait_s'] * 1e3:.0f}")
            for name, s in sorted(stats.items())
        ]
        lines += [_md_table(
            ("tier", "delivered", "mean NFE", "deadline misses",
             "mean wait ms"), rows), ""]

    return "\n".join(lines).rstrip() + "\n"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", required=True,
                    help="trace_record() JSON (repro_torch.launch.serve --trace-out)")
    ap.add_argument("--out", default=None,
                    help="write the markdown here (default: stdout)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    md = telemetry_markdown(trace)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(f"report -> {args.out}")
    else:
        print(md)


if __name__ == "__main__":
    main()
