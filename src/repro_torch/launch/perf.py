"""Perf-iteration harness: named variants of an (arch × shape) dry run
with their roofline terms appended to ``<out>/<arch>_<shape>.jsonl``;
port of ``repro/launch/perf.py`` for the knobs the port has on one card.

Each variant is a knob set of ``launch/specs.py::build_dryrun`` run on
meta tensors (``launch/dryrun.py::run_one``); the record holds the
counted FLOPs and bytes, the H100 roofline terms of
``analysis/roofline.py`` and the change of each against ``baseline``
when the file already holds a baseline record.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch granite-moe-3b-a800m \\
      --shape prefill_32k --variant moe-gather --out /tmp/perf

The reference's variants that need a mesh (sequence-sharded attention,
sequence parallelism, padded experts for sharding, FSDP, ZeRO-1, flash
decode over a mesh axis) raise: they wait for the LMs' dry run under a
mesh (ROADMAP A11 (iii); the layouts themselves run, ``launch/specs.py``).
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.analysis.roofline import analyze_record
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch.dryrun import run_one

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "perf_torch")

#: named variants: keyword arguments of ``dryrun.run_one``
VARIANTS = {
    "baseline": {"last_logits_only": False},
    "last-logits": {},  # the prefill's head on the last position only (the default)
    "moe-gather": {"cfg_overrides": {"moe_dispatch": "gather"}},
    "remat-full": {"remat": "full"},
    "remat-dots": {"remat": "dots"},
}

#: the reference's variants that run only under a mesh
MESH_VARIANTS = ("seq-shard-attn", "seq-parallel", "moe-pad48", "seq-shard+moe-pad48",
                 "fsdp", "fsdp+remat", "fsdp+moe-gather", "zero1", "zero1+remat",
                 "zero1+seqpar", "flash-decode", "flash-decode-2d")

_TERMS = ("flops", "est_hbm_traffic_bytes", "t_compute_s", "t_memory_s")


def run_variant(arch: str, shape_name: str, variant: str, *, out_dir: str = OUT_DIR,
                cfg=None) -> dict:
    """One variant's dry run and roofline, appended to the combination's
    JSONL; ``cfg`` replaces the registry's config (tests)."""
    if variant in MESH_VARIANTS:
        raise NotImplementedError(f"variant {variant!r} is a dry run under a device mesh, "
                                  f"which waits for ROADMAP A11 (iii)")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; have {sorted(VARIANTS)}")
    rec = run_one(arch, shape_name, save=False, verbose=False, cfg=cfg, **VARIANTS[variant])
    roof = analyze_record(rec)
    out = {"arch": arch, "shape": shape_name, "variant": variant, "mesh": "1card",
           "flops": rec["cost"]["flops"],
           "est_hbm_traffic_bytes": rec["cost"]["est_hbm_traffic_bytes"],
           **{k: roof[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                                   "dominant", "useful_ratio")},
           "param_bytes": rec["memory"]["param_bytes"], "wall_s": rec["wall_s"]}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}_{shape_name}.jsonl")
    base = _baseline(path)
    if base is not None:
        out["vs_baseline"] = {k: out[k] / base[k] if base[k] else None for k in _TERMS}
    with open(path, "a") as f:
        f.write(json.dumps(out) + "\n")
    print(f"[{arch} × {shape_name} × {variant}] compute {out['t_compute_s']:.3e} s  memory "
          f"{out['t_memory_s']:.3e} s  dominant={out['dominant']}"
          + (f"  flops ×{out['vs_baseline']['flops']:.3f} of baseline" if base else ""),
          flush=True)
    return out


def _baseline(path: str):
    """The last baseline record of a JSONL, or None."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return next((r for r in reversed(recs) if r["variant"] == "baseline"), None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=sorted(SHAPES), required=True)
    ap.add_argument("--variant", choices=sorted(VARIANTS) + list(MESH_VARIANTS),
                    default="baseline")
    ap.add_argument("--out", default=OUT_DIR, help="directory of the JSONL files")
    args = ap.parse_args(argv)
    run_variant(args.arch, args.shape, args.variant, out_dir=args.out)


if __name__ == "__main__":
    main()
