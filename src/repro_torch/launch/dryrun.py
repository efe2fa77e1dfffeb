"""Dry run: every (arch × input shape) on meta tensors, on one device;
port of ``repro/launch/dryrun.py``.

Runs the train, prefill or decode step of ``launch/specs.py`` on the
``meta`` device (shapes and dtypes, no storage, no card) under
``torch.utils.flop_counter.FlopCounterMode`` and a byte counter, and
writes one JSON record a combination to ``--out`` (default
``experiments/dryrun_torch/``, ignored by git) for
``analysis/roofline.py``:

  * ``cost.flops``: the products' FLOPs of the port's path on the card
    (matmuls, batched matmuls, convolutions; elementwise work is not
    counted). The step runs the plain attention, which computes every
    S × S product of a causal or windowed layer; on the card a prefill's
    "A"/"L" layers run K3, which computes the visible (query, key) pairs
    only, so ``k3_correction`` takes the masked products out. Train and
    decode run the plain attention on the card too and keep their count.
    ``cost.plain_path`` keeps the plain path's counts, ``cost.flops_by_op``
    its FLOPs by operator;
  * ``cost.est_hbm_traffic_bytes``: the products' operands read once and
    results written once, as if every elementwise operator were fused
    into its neighbours (the roofline's memory term); on K3's layers q, k,
    v and the output once in place of the plain path's fp32 S × S scores;
  * ``memory``: the bytes of the parameters, the optimizer moments, the
    decode state and the outputs;
  * ``devices``: 1.

Every layer runs, so the reference's depth extrapolation of XLA's
scanned loops (its ``dryrun.py:78-121``) has no counterpart. The
production mesh (``--multi-pod``) waits for the LMs' dry run under a
mesh (ROADMAP A11 (iii); the sampler's runs, ``launch/sample.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out /tmp/dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, get_config, get_shape
from repro_torch.launch.specs import DryRunSpec, build_dryrun
from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a nested structure of tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _leaves(tree) -> list:
    """Tensors of dicts, lists, tuples and dataclasses (decode states)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for f in tree.__dataclass_fields__ for t in _leaves(getattr(tree, f))]
    return []


class _Traffic(TorchDispatchMode):
    """Bytes the products (the operators with a FLOP formula) read (their
    tensor arguments) and write (their outputs)."""

    def __init__(self):
        super().__init__()
        self.product_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in flop_registry:
            self.product_bytes += tensor_bytes((args, kwargs)) + tensor_bytes(out)
        return out


def count(fn: Callable, *args) -> dict:
    """Run ``fn(*args)`` (meta tensors) under both counters: {"flops",
    "flops_by_op", "est_hbm_traffic_bytes", "output_bytes"}."""
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    with flops, traffic:
        out = fn(*args)
    by_op = {str(k): int(v) for k, v in flops.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(flops.get_total_flops()), "flops_by_op": by_op,
            "est_hbm_traffic_bytes": float(traffic.product_bytes),
            "output_bytes": tensor_bytes(out)}


def visible_pairs(S: int, window: Optional[int]) -> int:
    """The (query, key) pairs of a causal layer over S positions, each
    query seeing its last ``window`` keys (all with None)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def k3_correction(cfg: ModelConfig, shape: InputShape) -> dict:
    """K3's cost less the plain path's counted cost, summed over a
    prefill's "A"/"L" layers ({"flops", "bytes"}, both ≤ 0): K3 computes
    QKᵀ and PV over the visible pairs only (4·B·Hq·D a pair) and moves
    q, k, v and the output once; the plain path's cost is counted on a
    layer of the same shape. Zero for train and decode, and for layers
    with a logit softcap (the plain path runs there on the card too)."""
    if shape.kind != "prefill" or cfg.attn_logit_softcap:
        return {"flops": 0.0, "bytes": 0.0}
    B, S, Hq, Hkv, D = (shape.global_batch, shape.seq_len, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
    meta, dtype = torch.device("meta"), getattr(torch, cfg.dtype)
    q = torch.empty(B, S, Hq, D, dtype=dtype, device=meta)
    kv = torch.empty(B, S, Hkv, D, dtype=dtype, device=meta)
    flops = nbytes = 0.0
    for kind in cfg.mixer_pattern:
        if kind not in ("A", "L"):
            continue
        window = cfg.sliding_window if kind == "L" else None
        plain = count(lambda: attention(q, kv, kv, causal=True, window=window))
        k3_bytes = q.element_size() * B * S * D * (2 * Hq + 2 * Hkv)
        flops += cfg.num_repeats * (4 * B * Hq * D * visible_pairs(S, window) - plain["flops"])
        nbytes += cfg.num_repeats * (k3_bytes - plain["est_hbm_traffic_bytes"])
    return {"flops": flops, "bytes": nbytes}


def step_cost(spec: DryRunSpec, shape: InputShape) -> dict:
    """``count`` of the spec's step, with ``k3_correction`` applied to
    its FLOPs and traffic; the plain path's counts under "plain_path"."""
    cost = count(spec.fn, *spec.args)
    k3 = k3_correction(spec.cfg, shape)
    cost["plain_path"] = {k: cost[k] for k in ("flops", "est_hbm_traffic_bytes")}
    cost["flops"] += k3["flops"]
    cost["est_hbm_traffic_bytes"] += k3["bytes"]
    return cost


def check_meta(tree, what: str) -> None:
    """Raise if a tensor of ``tree`` lies off the meta device."""
    off = {str(t.device) for t in _leaves(tree) if t.device.type != "meta"}
    if off:
        raise RuntimeError(f"{what}: tensors on {sorted(off)}, not on the meta device")


def run_one(arch: str, shape_name: str, *, remat: str = "none", dtype: str = "bfloat16",
            cfg_overrides=None, last_logits_only: bool = True, out_dir: str = OUT_DIR,
            save: bool = True, verbose: bool = True, cfg=None) -> dict:
    """One (arch × shape) on meta tensors; the record, written to
    ``out_dir`` when ``save``. ``cfg`` replaces ``get_config(arch)``
    (tests pass scaled-down configs)."""
    shape = get_shape(shape_name)
    t0 = time.perf_counter()
    spec = build_dryrun(get_config(arch) if cfg is None else cfg, shape, remat=remat,
                        dtype=dtype, cfg_overrides=cfg_overrides,
                        last_logits_only=last_logits_only)
    check_meta(spec.args, "arguments")
    cost = step_cost(spec, shape)
    params = spec.args[0]
    opt_bytes = tensor_bytes((spec.args[1].mu, spec.args[1].nu)) if spec.kind == "train" else 0
    state_bytes = tensor_bytes(spec.args[2]) if spec.kind == "decode" else 0
    record = {
        "arch": arch, "shape": shape_name, "mesh": "1card", "kind": shape.kind,
        "remat": remat, "dtype": dtype, "devices": 1,
        "last_logits_only": last_logits_only, "cfg_overrides": cfg_overrides or {},
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "num_layers": spec.cfg.num_layers,
        "wall_s": round(time.perf_counter() - t0, 2),
        "memory": {"param_bytes": tensor_bytes(params), "opt_state_bytes": opt_bytes,
                   "decode_state_bytes": state_bytes,
                   "batch_bytes": tensor_bytes(spec.args[1 if spec.kind != "train" else 2]),
                   "output_bytes": cost.pop("output_bytes")},
        "cost": cost,
        "collectives": {"total_bytes": 0, "method": "one card: none"},
    }
    if verbose:
        gb = 2 ** 30
        print(f"[{arch} × {shape_name} × 1card] OK {record['wall_s']:.1f} s  flops "
              f"{cost['flops']:.3e}  traffic {cost['est_hbm_traffic_bytes'] / gb:.1f} GiB  "
              f"params {record['memory']['param_bytes'] / gb:.2f} GiB", flush=True)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}_{shape_name}_1card.json"), "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--out", default=OUT_DIR, help="directory of the JSON records")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production mesh: waits for ROADMAP A11 (iii)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise SystemExit("--multi-pod needs the production mesh: the dry run under a mesh "
                         "waits for ROADMAP A11 (iii)")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    failures = []
    for arch, shape in combos:
        try:
            run_one(arch, shape, remat=args.remat, dtype=args.dtype, out_dir=args.out)
        except Exception as e:  # noqa: BLE001 — report every combination
            failures.append((arch, shape, repr(e)))
            print(f"[{arch} × {shape}] FAILED: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
