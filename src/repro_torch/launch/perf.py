"""Perf-iteration harness: named variants of an (arch × shape × mesh) dry
run with their roofline terms appended to ``<out>/<arch>_<shape>.jsonl``;
port of ``repro/launch/perf.py``.

Each variant is a knob set of ``launch/specs.py::build_dryrun`` run on
meta tensors (``launch/dryrun.py::run_one``), on one card or as one rank
of the reference's 1pod (16, 16) or 2pod (2, 16, 16) mesh; the record
holds the counted FLOPs and bytes, the collectives by the reference's
op kinds, the H100 roofline terms of ``analysis/roofline.py`` (the
collective term over the link it names) and the change of each against
the last ``baseline`` record of the same mesh in the file.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch granite-moe-3b-a800m \\
      --shape prefill_32k --variant moe-gather --out /tmp/perf
  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen1.5-0.5b --shape train_4k \\
      --variant fsdp --mesh 1pod --out /tmp/perf

The variants that lay a step out over a mesh (sequence-sharded attention,
sequence parallelism, padded experts, FSDP, ZeRO-1, flash decode over
mesh axes) raise ``ValueError`` on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.analysis.roofline import analyze_record
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.dryrun import MESHES, run_one

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "perf_torch")

#: named variants (the reference's 17): keyword arguments of
#: ``dryrun.run_one``, and ``moe_padded_experts``
VARIANTS = {
    "baseline": {"last_logits_only": False},
    "last-logits": {},  # the prefill's head on the last position only (the default)
    "seq-shard-attn": {"cfg_overrides": {"attn_q_seq_shard": "model"}},
    "seq-parallel": {"cfg_overrides": {"attn_q_seq_shard": "model",
                                       "residual_seq_shard": "model"}},
    "moe-pad48": {"moe_padded_experts": 48},
    "seq-shard+moe-pad48": {"moe_padded_experts": 48,
                            "cfg_overrides": {"attn_q_seq_shard": "model"}},
    "moe-gather": {"cfg_overrides": {"moe_dispatch": "gather"}},
    "remat-full": {"remat": "full"},
    "remat-dots": {"remat": "dots"},
    "fsdp": {"fsdp": True},
    "fsdp+remat": {"fsdp": True, "remat": "full"},
    "fsdp+moe-gather": {"fsdp": True, "cfg_overrides": {"moe_dispatch": "gather"}},
    "zero1": {"zero1": True},
    "zero1+remat": {"zero1": True, "remat": "full"},
    "zero1+seqpar": {"zero1": True, "cfg_overrides": {"residual_seq_shard": "model"}},
    "flash-decode": {"cfg_overrides": {"decode_flash_shard": "model"}},
    "flash-decode-2d": {"cfg_overrides": {"decode_flash_shard": "data,model"}},
}

#: the variants that run only under a mesh
MESH_VARIANTS = ("seq-shard-attn", "seq-parallel", "moe-pad48", "seq-shard+moe-pad48",
                 "fsdp", "fsdp+remat", "fsdp+moe-gather", "zero1", "zero1+remat",
                 "zero1+seqpar", "flash-decode", "flash-decode-2d")

_TERMS = ("flops", "est_hbm_traffic_bytes", "collective_bytes", "t_compute_s",
          "t_memory_s", "t_collective_s", "param_bytes", "opt_state_bytes")


def variant_kwargs(variant: str, cfg) -> dict:
    """``run_one``'s keywords for ``variant`` on ``cfg``: the padded
    experts as a ``cfg_overrides["moe"]`` of ``cfg``'s MoE config
    (reference :69-74)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; have {sorted(VARIANTS)}")
    kw = dict(VARIANTS[variant])
    pad = kw.pop("moe_padded_experts", None)
    if pad:
        if cfg.moe is None:
            raise ValueError(f"variant {variant!r} pads the experts of an MoE config; "
                             f"{cfg.name} has none")
        kw["cfg_overrides"] = dict(kw.get("cfg_overrides", {}),
                                   moe=dataclasses.replace(cfg.moe, padded_experts=pad))
    return kw


def run_variant(arch: str, shape_name: str, variant: str, *, mesh: str = "1card",
                out_dir: str = OUT_DIR, cfg=None) -> dict:
    """One variant's dry run and roofline on ``mesh``, appended to the
    combination's JSONL; ``cfg`` replaces the registry's config (tests)."""
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: want one of {MESHES}")
    if variant in MESH_VARIANTS and mesh == "1card":
        raise ValueError(f"variant {variant!r} lays the step out over a mesh: run it with "
                         f"--mesh 1pod or --multi-pod (mesh='1pod' or '2pod')")
    cfg = get_config(arch) if cfg is None else cfg
    rec = run_one(arch, shape_name, mesh=mesh, save=False, verbose=False, cfg=cfg,
                  **variant_kwargs(variant, cfg))
    roof = analyze_record(rec)
    coll = rec["collectives"]
    out = {"arch": arch, "shape": shape_name, "variant": variant, "mesh": mesh,
           "devices": rec["devices"], "flops": rec["cost"]["flops"],
           "est_hbm_traffic_bytes": rec["cost"]["est_hbm_traffic_bytes"],
           "collective_bytes": coll["total_bytes"],
           "coll_by_kind": coll.get("bytes_by_kind", {}),
           "coll_counts": coll.get("counts", {}),
           **{k: roof[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "link",
                                   "dominant", "useful_ratio")},
           "param_bytes": rec["memory"]["param_bytes"],
           "opt_state_bytes": rec["memory"]["opt_state_bytes"],
           "largest_tensor": rec["memory"].get("largest_tensor"), "wall_s": rec["wall_s"]}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}_{shape_name}.jsonl")
    base = _baseline(path, mesh)
    if base is not None:
        out["vs_baseline"] = {k: out[k] / base[k] if base.get(k) else None for k in _TERMS}
    with open(path, "a") as f:
        f.write(json.dumps(out) + "\n")
    print(f"[{arch} × {shape_name} × {mesh} × {variant}] compute {out['t_compute_s']:.3e} s  "
          f"memory {out['t_memory_s']:.3e} s  collective {out['t_collective_s']:.3e} s  "
          f"dominant={out['dominant']}"
          + (f"  flops ×{out['vs_baseline']['flops']:.3f} of baseline" if base else ""),
          flush=True)
    return out


def _baseline(path: str, mesh: str):
    """The last baseline record of ``mesh`` in a JSONL, or None."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return next((r for r in reversed(recs)
                 if r["variant"] == "baseline" and r.get("mesh", "1card") == mesh), None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=sorted(SHAPES), required=True)
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="baseline")
    meshes = ap.add_mutually_exclusive_group()
    meshes.add_argument("--mesh", choices=MESHES[:2], default="1card",
                        help="one card, or one rank of the reference's 1pod (16, 16) mesh")
    meshes.add_argument("--multi-pod", action="store_true",
                        help="one rank of the 2pod (2, 16, 16) mesh")
    ap.add_argument("--out", default=OUT_DIR, help="directory of the JSONL files")
    args = ap.parse_args(argv)
    run_variant(args.arch, args.shape, args.variant,
                mesh="2pod" if args.multi_pod else args.mesh, out_dir=args.out)


if __name__ == "__main__":
    main()
