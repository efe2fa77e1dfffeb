"""Dry run: every (arch × input shape) on meta tensors, on one device or
as one rank of the reference's production mesh; port of
``repro/launch/dryrun.py``.

Runs the train, prefill or decode step of ``launch/specs.py`` on the
``meta`` device (shapes and dtypes, no storage, no card) under
``torch.utils.flop_counter.FlopCounterMode`` and a byte counter, and
writes one JSON record a combination, ``{arch}_{shape}_{mesh}.json``, to
``--out`` (default ``experiments/dryrun_torch/``, ignored by git) for
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
  * ``devices``: 1, or the mesh's 256 or 512.

``--mesh 1pod`` and ``--multi-pod`` (``2pod``) count the first rank of
the reference's (16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")`` meshes
(``launch/mesh.py::make_production_mesh``): its blocks of the weights and
moments (``specs.build_dryrun(mesh=)``), its rows, its decode state, and
every collective it calls, inside ``parallel.collectives.counting()``,
through the same layers that run on the card under ``mesh=``. Such a
record adds ``rank`` (the coordinate, its rows, its query and KV heads,
its layers), ``cost.k3_calls`` on a prefill, ``collectives`` by the
reference's op kinds (result bytes) and the port's kinds (sent bytes),
and ``memory.largest_tensor``: the largest single tensor an operator of
the rank's step makes, with its operator (a counted collective's result
by its op and kind), the S × S scores of the plain attention that K3
replaces on a prefill excepted. Every cost is the rank's; K3's
correction takes the rank's calls from its layout (its rows, its heads;
under ``attn_q_seq_shard`` the rows a rank attends over).

Every layer runs, so the reference's depth extrapolation of XLA's
scanned loops (its ``dryrun.py:78-121``) has no counterpart.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out /tmp/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1pod --out /tmp/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out /tmp/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, get_config, get_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import DryRunSpec, build_dryrun
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _layer_shardings
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import lever_axes, model_rank, split_rows

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
#: one card, and one rank of the reference's (16, 16) and (2, 16, 16) meshes
MESHES = ("1card", "1pod", "2pod")


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
    tensor arguments) and write (their outputs); with ``watch``, the
    largest tensor any operator makes (``largest``: bytes, operator,
    shape; views and in-place results make none), tensors whose last two
    dimensions are one of ``scores`` excepted."""

    def __init__(self, watch: bool = False, scores=frozenset()):
        super().__init__()
        self.product_bytes = 0
        self.watch, self.scores = watch, scores
        self.largest = (0, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in flop_registry:
            self.product_bytes += tensor_bytes((args, kwargs)) + tensor_bytes(out)
        if self.watch and not _aliases(func):
            for t in _leaves(out):
                n = t.numel() * t.element_size()
                if n > self.largest[0] and tuple(t.shape[-2:]) not in self.scores:
                    self.largest = (n, str(func), tuple(t.shape))
        return out


@functools.lru_cache(maxsize=None)
def _aliases(func) -> bool:
    """Whether ``func`` returns a view or its input (it makes no tensor)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def count(fn: Callable, *args, watch: bool = False, scores=frozenset()) -> dict:
    """Run ``fn(*args)`` (meta tensors) under both counters: {"flops",
    "flops_by_op", "est_hbm_traffic_bytes", "output_bytes"}; with
    ``watch`` also "largest" (bytes, operator, shape), tensors whose last
    two dimensions are one of ``scores`` excepted."""
    flops = FlopCounterMode(display=False)
    traffic = _Traffic(watch, scores)
    with flops, traffic:
        out = fn(*args)
    by_op = {str(k): int(v) for k, v in flops.get_flop_counts().get("Global", {}).items()}
    out = {"flops": float(flops.get_total_flops()), "flops_by_op": by_op,
           "est_hbm_traffic_bytes": float(traffic.product_bytes),
           "output_bytes": tensor_bytes(out)}
    if watch:
        out["largest"] = traffic.largest
    return out


def visible_pairs(S: int, window: Optional[int]) -> int:
    """The (query, key) pairs of a causal layer over S positions, each
    query seeing its last ``window`` keys (all with None)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def k3_correction(cfg: ModelConfig, shape: InputShape, calls: Optional[list] = None) -> dict:
    """K3's cost less the plain path's counted cost, summed over a
    prefill's "A"/"L" layers ({"flops", "bytes"}, both ≤ 0): K3 computes
    QKᵀ and PV over the visible pairs only (4·B·Hq·D a pair) and moves
    q, k, v and the output once; the plain path's cost is counted on a
    layer of the same shape. Zero for train and decode, and for layers
    with a logit softcap (the plain path runs there on the card too).
    ``calls``: the K3 calls of a rank (``rank_k3_calls``: its rows, its
    heads, the rows a ``attn_q_seq_shard`` rank attends over); by default
    every layer at the shape's batch and the config's heads."""
    if shape.kind != "prefill" or cfg.attn_logit_softcap:
        return {"flops": 0.0, "bytes": 0.0}
    if calls is None:
        B, S, Hq, Hkv, D = (shape.global_batch, shape.seq_len, cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim)
        dtype = getattr(torch, cfg.dtype)
        calls = [((B, S, Hq, D), (B, S, Hkv, D),
                  cfg.sliding_window if kind == "L" else None, dtype)
                 for kind in cfg.mixer_pattern if kind in ("A", "L")] * cfg.num_repeats
    meta = torch.device("meta")
    flops = nbytes = 0.0
    for key in sorted(set(calls), key=str):
        (B, S, Hq, D), kv_shape, window, dtype = key
        q = torch.empty(B, S, Hq, D, dtype=dtype, device=meta)
        kv = torch.empty(kv_shape, dtype=dtype, device=meta)
        plain = count(lambda: attn.attention(q, kv, kv, causal=True, window=window))
        k3_bytes = q.element_size() * B * S * D * (2 * Hq + 2 * kv_shape[2])
        n = calls.count(key)
        flops += n * (4 * B * Hq * D * visible_pairs(S, window) - plain["flops"])
        nbytes += n * (k3_bytes - plain["est_hbm_traffic_bytes"])
    return {"flops": flops, "bytes": nbytes}


def step_cost(spec: DryRunSpec, shape: InputShape) -> dict:
    """``count`` of the spec's step, with ``k3_correction`` applied to
    its FLOPs and traffic; the plain path's counts under "plain_path".
    Under a mesh the step runs inside ``collectives.counting()`` (the
    books since a ``coll.reset()`` are its collectives), K3's calls are
    the rank's own (``rank_k3_calls``), and "largest_tensor" is the
    largest tensor the step makes, the S × S scores of the attention K3
    runs (it makes none) excepted: a counted collective's result by the
    op and kind ``counting`` lists it under."""
    if spec.mesh is None:
        cost = count(spec.fn, *spec.args)
        k3 = k3_correction(spec.cfg, shape)
    else:
        calls = rank_k3_calls(spec, shape)
        scores = frozenset((q[1], k[1]) for q, k, _, _ in calls)
        with coll.counting() as results:
            cost = count(spec.fn, *spec.args, watch=True, scores=scores)
        n, op, dims = max([*results, cost.pop("largest")], key=lambda t: t[0])
        cost["largest_tensor"] = {"bytes": n, "op": op, "shape": list(dims or ())}
        k3 = k3_correction(spec.cfg, shape, calls)
        cost["k3_calls"] = {"calls": len(calls),
                            "query_key_pairs": sum(visible_pairs(q[1], w) * q[0] * q[2]
                                                   for q, _, w, _ in calls)}
    cost["plain_path"] = {k: cost[k] for k in ("flops", "est_hbm_traffic_bytes")}
    cost["flops"] += k3["flops"]
    cost["est_hbm_traffic_bytes"] += k3["bytes"]
    return cost


def rank_k3_calls(spec: DryRunSpec, shape: InputShape) -> list:
    """The K3 calls of a rank's prefill, from its layout, as
    ``k3_correction`` takes them: each "A"/"L" layer's (q shape, k shape,
    window, dtype) on the rank's rows, its query heads and the KV heads
    they read (``models.attention._Heads``; every head where attention
    stays whole on every model rank). Under ``attn_q_seq_shard`` the rank
    attends with every head over the rows [a0, b) its own block [a, b)
    sees (``split_rows``; a0 = a less the window, or 0). No call on a config
    with a logit soft-cap, where K3 does not run."""
    cfg, m = spec.cfg, spec.mesh
    if shape.kind != "prefill" or cfg.attn_logit_softcap:
        return []
    n, r = model_rank(m)
    split = bool(lever_axes(cfg.attn_q_seq_shard)) and n > 1
    B, S, D = spec.rows.batch // spec.rows.n_shards, shape.seq_len, cfg.head_dim
    dtype = getattr(torch, cfg.dtype)
    calls = []
    for i, mix in enumerate(cfg.mixer_pattern):
        if mix not in ("A", "L"):
            continue
        window = cfg.sliding_window if mix == "L" else None
        hq, hkv, rows = cfg.num_heads, cfg.num_kv_heads, S
        if n > 1:
            shard = _layer_shardings(spec.layout.params["blocks"][f"p{i}"])["mixer"]
            heads = attn._Heads(cfg, shard, m, all_q=split)
            hq, hkv = len(heads.q), heads.need[1]
        if split:
            a, b = split_rows(S, n, r)
            rows = b - (0 if window is None else max(0, a - window + 1))
        calls += [((B, rows, hq, D), (B, rows, hkv, D), window, dtype)] * cfg.num_repeats
    return calls


def check_meta(tree, what: str) -> None:
    """Raise if a tensor of ``tree`` lies off the meta device."""
    off = {str(t.device) for t in _leaves(tree) if t.device.type != "meta"}
    if off:
        raise RuntimeError(f"{what}: tensors on {sorted(off)}, not on the meta device")


def run_one(arch: str, shape_name: str, *, mesh: str = "1card", fsdp: bool = False,
            zero1: bool = False, remat: str = "none",
            dtype: str = "bfloat16", cfg_overrides=None, last_logits_only: bool = True,
            out_dir: str = OUT_DIR, save: bool = True, verbose: bool = True, cfg=None) -> dict:
    """One (arch × shape × mesh) on meta tensors; the record, written to
    ``out_dir`` when ``save``. ``cfg`` replaces ``get_config(arch)``
    (tests pass scaled-down configs). ``mesh`` "1pod" / "2pod" counts the
    first rank of the production mesh, laid out with ``fsdp`` / ``zero1``
    (module docstring)."""
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: want one of {MESHES}")
    shape = get_shape(shape_name)
    t0 = time.perf_counter()
    m = None if mesh == "1card" else make_production_mesh(multi_pod=mesh == "2pod")
    spec = build_dryrun(get_config(arch) if cfg is None else cfg, shape, m, remat=remat,
                        dtype=dtype, fsdp=fsdp, zero1=zero1, cfg_overrides=cfg_overrides,
                        last_logits_only=last_logits_only)
    check_meta(spec.args, "arguments")
    coll.reset()
    cost = step_cost(spec, shape)
    books = coll.books()
    coll.reset()
    params = spec.args[0]
    opt_bytes = tensor_bytes((spec.args[1].mu, spec.args[1].nu)) if spec.kind == "train" else 0
    state_bytes = tensor_bytes(spec.args[2]) if spec.kind == "decode" else 0
    batch = spec.args[1 if spec.kind != "train" else 2]
    memory = {"param_bytes": tensor_bytes(params), "opt_state_bytes": opt_bytes,
              "decode_state_bytes": state_bytes,
              "batch_bytes": tensor_bytes([v[spec.rows.rows] for v in batch.values()]
                                          if m is not None else batch),
              "output_bytes": cost.pop("output_bytes")}
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh, "kind": shape.kind,
        "remat": remat, "dtype": dtype, "devices": 1 if m is None else m.size,
        "last_logits_only": last_logits_only, "cfg_overrides": _jsonable(cfg_overrides or {}),
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "num_layers": spec.cfg.num_layers,
        "wall_s": round(time.perf_counter() - t0, 2),
        "memory": memory,
        "cost": cost,
        "collectives": {"total_bytes": 0, "method": "one card: none"},
    }
    if m is not None:
        memory["largest_tensor"] = cost.pop("largest_tensor")
        # the reference's memory keys: the step's arguments (the rank's
        # resident bytes and its rows) and outputs; XLA's temporaries and
        # peak have no count here
        memory.update(argument_bytes=sum(memory[k] for k in (
            "param_bytes", "opt_state_bytes", "decode_state_bytes", "batch_bytes")),
            temp_bytes=None, peak_bytes=None)
        record.update(num_repeats=spec.cfg.num_repeats, fsdp=fsdp, zero1=zero1,
                      layout=spec.layout.name, rank=rank_record(spec))
        record["collectives"] = {**books, "method": "one rank, every layer, counted on meta "
                                                    "tensors (collectives.counting)"}
    if verbose:
        gb = 2 ** 30
        extra = "" if m is None else (
            f"  coll {books['total_bytes'] / gb:.2f} GiB {books['counts']}  largest "
            f"{memory['largest_tensor']['bytes'] / gb:.2f} GiB "
            f"({memory['largest_tensor']['op']})")
        print(f"[{arch} × {shape_name} × {mesh}] OK {record['wall_s']:.1f} s  flops "
              f"{cost['flops']:.3e}  traffic {cost['est_hbm_traffic_bytes'] / gb:.1f} GiB  "
              f"params {record['memory']['param_bytes'] / gb:.2f} GiB" + extra, flush=True)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}_{shape_name}_{mesh}.json"), "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
    return record


def _jsonable(overrides: dict) -> dict:
    """``cfg_overrides`` for the record: a dataclass value (``moe``) as a dict."""
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in overrides.items()}


def rank_record(spec: DryRunSpec) -> dict:
    """The counted rank: its coordinate, rows, query and KV heads (an
    attention layer's, as it projects them; the whole range under
    ``attn_q_seq_shard``, whose rows it splits), Mamba2 heads, and layers
    (every layer: the port runs no pipeline over the LMs)."""
    m, cfg = spec.mesh, spec.cfg
    out = {"coordinate": dict(zip(m.axis_names, m.coordinate)),
           "rows": spec.rows.batch // spec.rows.n_shards,
           "layers": [0, cfg.num_layers]}
    for i, mix in enumerate(cfg.mixer_pattern):
        shard = _layer_shardings(spec.layout.params["blocks"][f"p{i}"])["mixer"]
        if mix in ("A", "L") and "q_heads" not in out:
            heads = attn._Heads(cfg, shard, m, all_q=bool(cfg.attn_q_seq_shard))
            out.update(q_heads=len(heads.q), kv_heads=heads.kv[1])
        if mix == "M" and "mamba_heads" not in out:
            H = cfg.mamba.num_heads(cfg.d_model)
            out["mamba_heads"] = H // m.shape["model"] if shard["A_log"].sharded_dim() \
                is not None else H
    if cfg.attn_q_seq_shard and spec.kind != "decode":
        out["note"] = ("attn_q_seq_shard: each model rank attends over the rows up to its "
                       "own block's end, so the last model rank's rows see the most keys; "
                       "this record counts the first")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--out", default=OUT_DIR, help="directory of the JSON records")
    meshes = ap.add_mutually_exclusive_group()
    meshes.add_argument("--mesh", choices=MESHES[:2], default="1card",
                        help="one card, or one rank of the reference's 1pod (16, 16) mesh")
    meshes.add_argument("--multi-pod", action="store_true",
                        help="one rank of the 2pod (2, 16, 16) mesh")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    mesh = "2pod" if args.multi_pod else args.mesh
    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    failures = []
    for arch, shape in combos:
        try:
            run_one(arch, shape, mesh=mesh, remat=args.remat, dtype=args.dtype,
                    out_dir=args.out)
        except Exception as e:  # noqa: BLE001 — report every combination
            failures.append((arch, shape, repr(e)))
            print(f"[{arch} × {shape} × {mesh}] FAILED: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
