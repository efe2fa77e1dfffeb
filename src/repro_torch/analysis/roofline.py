"""Roofline analysis of the dry run's records on one H100; port of
``repro/analysis/roofline.py``.

Per (arch × shape × mesh), from ``launch/dryrun.py``'s counted FLOPs and
bytes (the port's path on the card: K3's visible pairs on a prefill's
"A"/"L" layers, the plain path elsewhere; a mesh record's are one
rank's):

    compute    = FLOPs / peak FLOP/s of the record's dtype
    memory     = estimated HBM traffic / HBM bandwidth
    collective = collective bytes (the reference's op kinds' result
                 bytes) / the link's bandwidth (``link_of``: NVLink in
                 one node; InfiniBand between the nodes a 256- or
                 512-card mesh spans; 0 on one card)

The peaks are the published ones of the H100 SXM5 (80 GB HBM3, 700 W)
from NVIDIA's H100 Tensor Core GPU data sheet, dense (no sparsity):
989 TFLOP/s bf16 and 495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s
fp32 on the CUDA cores (the port's fp32 runs with TF32 off, so fp32
products take the CUDA-core peak), 3.35 TB/s of HBM3, and NVLink's
900 GB/s, 450 GB/s each way. A card set below 700 W runs slower than
these peaks: a share measured on the card names the card and its power
limit.

Also derives the model FLOPs 6·N·D (train) or 2·N·D (forward) with N the
parameters that take part in a product (the embedding table excluded;
top_k / num_experts of the routed experts), as the reference does, and
the useful ratio model FLOPs / counted FLOPs (remat and dead products
show there).

  PYTHONPATH=src python -m repro_torch.analysis.roofline [--dir DIR] [--md] [--mesh 1pod]
  PYTHONPATH=src python -m repro_torch.analysis.roofline --score-eval FILE
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, Mapping, Optional

from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.configs.shapes import apply_shape_policy
from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR

#: H100 SXM5 peaks (data sheet, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 450e9           # bytes/s, NVLink one way
CARD = "H100 SXM5 80 GB, 700 W"
#: cards an NVLink domain holds (an HGX H100 node), and the link between
#: nodes: one 400 Gb/s InfiniBand NDR adapter a card (DGX H100), 50 GB/s
#: each way
NODE_CARDS = 8
INTERNODE_BW = 50e9       # bytes/s a card, one way


def link_of(rec: dict) -> dict:
    """The link a record's collective term divides by: NVLink where every
    mesh axis fits in one node, else InfiniBand (the reference's 16-wide
    "model" axis spans two 8-card nodes, and a ring over it runs at the
    slowest link's rate)."""
    devices = rec.get("devices", 1)
    if devices <= NODE_CARDS:
        return {"name": "NVLink 4, one way", "bytes_per_s": LINK_BW,
                "why": f"{devices} card(s), one node"}
    return {"name": "InfiniBand NDR 400 Gb/s a card, one way", "bytes_per_s": INTERNODE_BW,
            "why": f"{devices} cards: the 16-wide 'model' axis spans two "
                   f"{NODE_CARDS}-card nodes"}


def peak_flops(dtype: str) -> float:
    """The card's peak FLOP/s for products in ``dtype``."""
    try:
        return PEAK_FLOPS[str(dtype).removeprefix("torch.")]
    except KeyError:
        raise ValueError(f"no peak for dtype {dtype!r}; have {sorted(PEAK_FLOPS)}") from None


def _named_leaves(tree: Mapping, prefix: str = ""):
    """(path, tensor) in the reference's flattening order: keys sorted,
    nested dicts depth first, paths joined by '/'."""
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _named_leaves(v, name + "/")
        else:
            yield name, v


def _param_counts(cfg) -> Dict[str, float]:
    """(total, active) parameter counts, the embedding table excluded
    (a lookup, not a product; the LM head is a product and counts); a
    routed expert counts top_k / num_experts of itself as active."""
    from repro_torch.launch.specs import abstract_params

    total = active = 0
    for name, leaf in _named_leaves(abstract_params(cfg)):
        n = math.prod(leaf.shape)
        if name == "embed":
            continue
        total += n
        if cfg.moe and "/mlp/w_" in name and "shared" not in name:
            active += n * cfg.moe.top_k / cfg.moe.num_experts
        else:
            active += n
    return {"total": total, "active": active}


def model_flops_per_device(arch: str, shape_name: str, devices: int = 1) -> Dict:
    """6·N_active·D for train, 2·N_active·D for the forward-only shapes
    (D the tokens: one a sequence for decode)."""
    shape = get_shape(shape_name)
    cfg = apply_shape_policy(get_config(arch), shape)
    counts = _param_counts(cfg)
    if shape.kind == "train":
        tokens, factor = shape.global_batch * shape.seq_len, 6.0
    elif shape.kind == "prefill":
        tokens, factor = shape.global_batch * shape.seq_len, 2.0
    else:  # decode: one token a sequence
        tokens, factor = shape.global_batch, 2.0
    return {"model_flops_total": factor * counts["active"] * tokens,
            "model_flops_per_device": factor * counts["active"] * tokens / devices,
            "params_total": counts["total"], "params_active": counts["active"]}


def analyze_record(rec: dict, model_flops: Optional[float] = None) -> dict:
    """The roofline terms of one dry-run record. ``model_flops`` (per
    device) defaults to ``model_flops_per_device`` of its arch and shape."""
    peak = peak_flops(rec.get("dtype", "bfloat16"))
    flops = rec["cost"].get("flops", 0.0)
    nbytes = rec["cost"].get("est_hbm_traffic_bytes", 0.0)
    coll = rec.get("collectives", {}).get("total_bytes", 0)
    link = link_of(rec)
    terms = {"compute": flops / peak, "memory": nbytes / HBM_BW,
             "collective": coll / link["bytes_per_s"]}
    dominant = max(terms, key=terms.get)
    if model_flops is None:
        model_flops = model_flops_per_device(rec["arch"], rec["shape"],
                                             rec.get("devices", 1))["model_flops_per_device"]
    bound = max(terms.values())
    mem = rec.get("memory", {})
    resident = sum(mem.get(k, 0) or 0 for k in ("param_bytes", "opt_state_bytes",
                                                 "decode_state_bytes"))
    return {**{f"t_{k}_s": v for k, v in terms.items()},
            "dominant": dominant,
            "model_flops_per_device": model_flops,
            "useful_ratio": model_flops / flops if flops else float("nan"),
            "mfu_upper_bound": model_flops / peak / bound if bound else float("nan"),
            "resident_gib": resident / 2 ** 30, "collective_bytes": coll,
            "devices": rec.get("devices", 1), "link": link["name"]}


def share_of_peak(flops: float, seconds: float, dtype: str) -> float:
    """Counted FLOPs over a measured time, as a share of the dtype's peak."""
    return flops / seconds / peak_flops(dtype)


def load_all(out_dir: str = DRYRUN_DIR, mesh: str = "1card") -> Dict[str, dict]:
    """The dry run's LM records of ``mesh`` ("1card", "1pod", "2pod") in
    ``out_dir`` by "arch:shape" (reference ``load_all(mesh=)``)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(out_dir, f"*_{mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("arch") in ARCH_IDS and rec.get("mesh", "1card") == mesh:
            # the sampler's records have their own report
            out[f"{rec['arch']}:{rec['shape']}"] = rec
    return out


def score_eval_markdown(artifact: dict) -> str:
    """Per-NFE roofline join for score evaluations (reference :112).

    Each row of ``artifact["rows"]`` carries ``workload``, ``preset``,
    ``variant``, the per-NFE FLOPs and bytes (``flops_per_nfe``,
    ``bytes_per_nfe``: counted by ``launch/sample.py --dryrun``) and the
    measured ``us_per_call`` of one NFE; the join divides by the peak of
    the row's ``dtype`` (bf16 unless given) and HBM bandwidth to classify
    each evaluation as compute- or memory-bound and gives the achieved
    FLOP/s as a share of that peak. ``artifact["card"]`` names the card
    and its power limit the times were taken on.
    """
    header = ("workload", "preset", "variant", "us/NFE", "GFLOP/NFE", "t_compute_s",
              "t_memory_s", "bound", "achieved_GFLOP/s", "frac_peak")
    lines = ["| " + " | ".join(header) + " |", "|" + "---|" * len(header)]
    for r in artifact["rows"]:
        peak = peak_flops(r.get("dtype", "bfloat16"))
        flops = float(r.get("flops_per_nfe") or 0.0)
        nbytes = float(r.get("bytes_per_nfe") or 0.0)
        t_c, t_m = flops / peak, nbytes / HBM_BW
        us = float(r["us_per_call"])
        achieved = flops / (us * 1e-6) if us else 0.0
        lines.append("| " + " | ".join((
            r["workload"], r["preset"], r["variant"], f"{us:.1f}", f"{flops / 1e9:.2f}",
            f"{t_c:.3e}", f"{t_m:.3e}", "compute" if t_c >= t_m else "memory",
            f"{achieved / 1e9:.2f}", f"{achieved / peak:.2e}")) + " |")
    lines.append("")
    lines.append(f"_times: {artifact.get('card', 'card not named')}; peaks: {CARD} "
                 f"(bf16 {PEAK_FLOPS['bfloat16'] / 1e12:.0f}, fp32 "
                 f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s; HBM "
                 f"{HBM_BW / 1e12:.2f} TB/s)._")
    return "\n".join(lines)


def table(recs: Dict[str, dict], md: bool, vs: Optional[Dict[str, dict]] = None) -> str:
    """One row a record: per device (a mesh record's counts are one rank's;
    ``load_all`` reads one mesh's records). Mesh records add the
    collectives' GiB by the reference's op kinds (all-reduce, all-gather,
    reduce-scatter) and the largest tensor a rank makes; ``vs`` (another
    mesh's records) adds its FLOPs and collective bytes over these."""
    header = ("arch", "shape", "dtype", "GFLOP", "traffic_GiB", "compute_s", "memory_s",
              "coll_s", "dominant", "useful", "mfu_ub", "resident_GiB")
    mesh = any(r.get("devices", 1) > 1 for r in recs.values())
    if mesh:
        header += ("AR_GiB", "AG_GiB", "RS_GiB", "largest_GiB", "largest_op")
    if vs is not None:
        header += ("vs_flops", "vs_coll")
    sep = " | " if md else ","
    lines = []
    if md:
        lines += ["| " + sep.join(header) + " |", "|" + "---|" * len(header)]
    else:
        lines.append(sep.join(header))
    gib = 2 ** 30
    for key, rec in sorted(recs.items()):
        a = analyze_record(rec)
        row = (rec["arch"], rec["shape"], rec.get("dtype", "bfloat16"),
               f"{rec['cost']['flops'] / 1e9:.4g}",
               f"{rec['cost']['est_hbm_traffic_bytes'] / 2 ** 30:.4g}",
               f"{a['t_compute_s']:.3e}", f"{a['t_memory_s']:.3e}",
               f"{a['t_collective_s']:.3e}", a["dominant"], f"{a['useful_ratio']:.2f}",
               f"{a['mfu_upper_bound']:.2f}", f"{a['resident_gib']:.2f}")
        if mesh:
            by = rec["collectives"].get("bytes_by_kind", {})
            big = rec["memory"].get("largest_tensor") or {"bytes": 0, "op": ""}
            row += tuple(f"{by.get(k, 0) / gib:.4g}" for k in
                         ("all-reduce", "all-gather", "reduce-scatter"))
            row += (f"{big['bytes'] / gib:.4g}", big["op"])
        if vs is not None:
            other = vs.get(key)
            ratio = lambda x, y: f"{x / y:.3f}" if other is not None and y else "-"
            row += (ratio(other["cost"]["flops"], rec["cost"]["flops"]) if other else "-",
                    ratio(other["collectives"]["total_bytes"], rec["collectives"]["total_bytes"])
                    if other else "-")
        lines.append(("| " + sep.join(row) + " |") if md else sep.join(row))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DRYRUN_DIR, help="the dry run's --out directory")
    ap.add_argument("--md", action="store_true", help="markdown table")
    ap.add_argument("--mesh", choices=("1card", "1pod", "2pod"), default="1card",
                    help="the records of this mesh")
    ap.add_argument("--vs", choices=("1card", "1pod", "2pod"),
                    help="add the FLOPs and collective bytes of this mesh's records over them")
    ap.add_argument("--score-eval", metavar="FILE",
                    help="print the per-NFE roofline join of this JSON artifact")
    args = ap.parse_args(argv)
    if args.score_eval:
        with open(args.score_eval) as f:
            print(score_eval_markdown(json.load(f)))
        return
    recs = load_all(args.dir, args.mesh)
    if not recs:
        raise SystemExit(f"no {args.mesh} dry-run records in {args.dir}")
    print(table(recs, args.md, load_all(args.dir, args.vs) if args.vs else None))


if __name__ == "__main__":
    main()
