"""The LMs' dry run under a mesh (``launch/dryrun.py --mesh 1pod`` /
``--multi-pod``, ``launch/specs.py::build_dryrun(mesh=)``,
``launch/perf.py``'s mesh variants) on the CPU.

* The count against a real run: in one spawn of 4 gloo ranks (one thread
  each), scaled-down configs of every mixer family (gemma3's "L"/"A",
  mamba2's "M", deepseek's expert-sharded "E", granite's "E" at 3 experts
  (the F-sharded fallback) and padded to 4 (expert-sharded), the
  cross-attention "X" of llama-3.2-vision, musicgen's codebooks) on the
  meshes (2, 2) ``("data", "model")`` and (2, 1, 2) ``("pod", "data",
  "model")``. Each rank runs the dry run's own steps (``build_dryrun``'s
  layout, ``make_prefill_step``/``make_serve_step``/``make_train_step``
  under ``mesh=``) on its real shard: the prefill, with the sequence
  levers, the decode step plain and with ``decode_flash_shard`` "model"
  and "data,model", the prefill and the decode on ZeRO-3's blocks (the
  tensor-parallel steps' tokens), and the train step under "tp" (remat
  "none" and "full"), "fsdp" (remat "full") and "zero1" (with
  ``residual_seq_shard``).
  It then counts the same step on meta tensors for its coordinate of a
  mesh without process groups (``build_dryrun(mesh=)`` inside
  ``collectives.counting()``): the books are equal, call for call and
  byte for byte, by the reference's op kinds and by the port's, and the
  meta leaves have the real shard's shapes (which are
  ``init_model(mesh=)``'s where the layout is the tensor-parallel one).
* The mirrors of ``tests/test_dryrun_integration.py``'s two slow tests:
  qwen1.5-0.5b ``train_4k`` at 1pod on 256 devices, its FLOPs a rank
  within 10 % of the reference's committed record (XLA's ``flops`` also
  counts elementwise work, the port's products only), with the record's
  op kinds (all-reduces only: the loss runs on the vocab-sharded logits)
  and no tensor above the rank's fp32 logits; ``decode_32k`` at 2pod on
  512 devices with the reference's 49 all-reduces (its record's
  ``counts_r2`` of 5 at two layers is 1 + 2·2, so 1 + 2·24 at 24) and its
  two all-gathers (the tokens, and the vocab pick's (value, id) pairs).
* Every one of the 12 mesh variants of ``launch/perf.py`` on a scaled-down
  granite at 1pod, appended after its shape's baseline: "fsdp" holds
  fewer parameter bytes a rank, "zero1" fewer moment bytes, the
  flash-decode levers book flash_decode's MAX and SUM all-reduces (two
  more a layer than the head-sharded baseline cache), and padded experts
  shard the experts (fewer FLOPs a rank).
* The command line: ``--mesh 1pod`` and ``--multi-pod`` exclude each
  other; a mesh variant on one card raises naming the flags.
"""

import dataclasses
import datetime
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun, perf, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharded_selftest import meta_place, put_result, spawn_ranks
from repro_torch.launch.steps import (
    init_opt_state, make_prefill_step, make_serve_step, make_train_step)
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamW
from repro_torch.optim.tree import leaves
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import init_mesh
from repro_torch.parallel.sharding import batch_sharding

torch.set_num_threads(2)

WORLD = 4
B, S = 4, 16
#: (pod, data, model) sizes (pod 0: no pod axis)
MESHES = {"2x2": (0, 2, 2), "2x1x2": (2, 1, 2)}
SEQ = {"attn_q_seq_shard": "model", "residual_seq_shard": "model"}
#: (step, kind, layout, remat, config overrides)
FULL = (("prefill", "prefill", "tp", "none", {}),
        ("prefill_seq_levers", "prefill", "tp", "none", SEQ),
        ("prefill_fsdp", "prefill", "fsdp", "none", {}),
        ("decode", "decode", "tp", "none", {}),
        ("decode_fsdp", "decode", "fsdp", "none", {}),
        ("decode_flash", "decode", "tp", "none", {"decode_flash_shard": "model"}),
        ("decode_flash_2d", "decode", "tp", "none", {"decode_flash_shard": "data,model"}),
        ("train_tp", "train", "tp", "none", {}),
        ("train_tp_remat", "train", "tp", "full", {}),
        ("train_fsdp_remat", "train", "fsdp", "full", {}),
        ("train_zero1_seqpar", "train", "zero1", "none", {"residual_seq_shard": "model"}))


def _short(train_layout: str, remat: str = "none"):
    return (("prefill", "prefill", "tp", "none", {}), ("decode", "decode", "tp", "none", {}),
            (f"train_{train_layout}", "train", train_layout, remat, {}))


def _granite(padded: int = 0):
    cfg = get_config("granite-moe-3b-a800m").scaled_down()
    return cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=3, padded_experts=padded))


CASES = {
    "gemma3": (lambda: get_config("gemma3-12b").scaled_down(), FULL),
    "mamba2": (lambda: get_config("mamba2-2.7b").scaled_down(), _short("tp", "full")),
    "deepseek": (lambda: get_config("deepseek-moe-16b").scaled_down(), _short("fsdp")),
    "granite_ffn": (_granite, _short("tp")),
    "granite_padded": (lambda: _granite(4), _short("zero1")),
    "vlm": (lambda: get_config("llama-3.2-vision-90b").scaled_down(), _short("tp")),
    "codebook": (lambda: get_config("musicgen-medium").scaled_down(), _short("fsdp", "full")),
}
PARAMS = [(c, m, step[0]) for c in CASES for m in MESHES for step in CASES[c][1]]


def _batch(cfg, seq: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (B, seq, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, seq)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))}
    if cfg.vision_dim:
        out["cross_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.num_patches, cfg.vision_dim)).astype(np.float32))
    return out


def _real_step(cfg, kind, lay, remat, mesh, shard, batch):
    """The dry run's step of ``kind`` on the rank's real shard."""
    if kind == "prefill":
        return make_prefill_step(cfg, use_flash=False, use_kernel_ssd=False, mesh=mesh,
                                 shardings=lay.params)(shard, batch)
    if kind == "decode":
        state = tr.init_decode_state(cfg, B, S, device="cpu", mesh=mesh)
        return make_serve_step(cfg, mesh=mesh, shardings=lay.params)(shard, batch, state)[0]
    opt = AdamW(lr=1e-4)
    step = make_train_step(cfg, opt, remat=remat, mesh=mesh, shardings=lay)
    return step(shard, init_opt_state(opt, shard, lay), batch)[2]["loss"]


def _rank(rank, world, port, out_dir, _):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        for mname, (pod, data, msize) in MESHES.items():
            mesh = init_mesh(data, msize, device="cpu", pod=pod or None)
            place = meta_place(mesh)
            for case, (make, steps) in CASES.items():
                base = make()
                full = tr.init_model(base, 0, device="cpu")
                for step, kind, layout, remat, over in steps:
                    cfg = base.replace(**over)
                    shape = InputShape(step, S, B, kind)
                    spec = specs.build_dryrun(base, shape, place, remat=remat,
                                              dtype=base.dtype, fsdp=layout == "fsdp",
                                              zero1=layout == "zero1", cfg_overrides=over)
                    lay = specs._layout(cfg, mesh, layout)
                    shard = tr.shard_params(full, mesh, cfg, shardings=lay.params)
                    batch = _batch(cfg, S if kind != "decode" else 1, seed=3)
                    coll.reset()
                    real = _real_step(cfg, kind, lay, remat, mesh, shard, batch)
                    books = (coll.op_counts(), coll.counts())
                    coll.reset()
                    with coll.counting():
                        counted = spec.fn(*spec.args)
                    counted_books = (coll.op_counts(), coll.counts())
                    coll.reset()
                    if kind == "train":
                        counted = counted[2]["loss"]
                    elif kind == "decode":
                        counted = counted[0]
                    want_shapes = None
                    if not (cfg.moe and cfg.moe.padded_experts):
                        # the layouts' shards as the training path builds them
                        built = tr.init_model(cfg, device="meta", mesh=place)
                        if layout == "fsdp":
                            built = tr.data_blocks(built, specs.train_layout(
                                cfg, place, "fsdp").params)
                        want_shapes = [tuple(t.shape) for t in leaves(built)]
                    out[(case, mname, step)] = {
                        "books": books, "counted": counted_books,
                        "shapes": [tuple(t.shape) for t in leaves(shard)],
                        "meta_shapes": [tuple(t.shape) for t in leaves(spec.args[0])],
                        "init_shapes": want_shapes,
                        "out_shapes": (tuple(real.shape), tuple(counted.shape)),
                        "tokens": real.tolist() if kind != "train" else None,
                        "finite": bool(torch.isfinite(real.float()).all())}
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned():
    return spawn_ranks(_rank, WORLD, None)


@pytest.mark.parametrize("case,mesh,step", PARAMS, ids=["-".join(p) for p in PARAMS])
def test_meta_count_equals_real_books(spawned, case, mesh, step):
    for r in spawned:
        res = r[(case, mesh, step)]
        assert res["counted"] == res["books"]
        assert res["meta_shapes"] == res["shapes"]
        if res["init_shapes"] is not None:
            assert res["meta_shapes"] == res["init_shapes"]
        assert res["out_shapes"][0] == res["out_shapes"][1] and res["finite"]
    ops = [r[(case, mesh, step)]["books"][0] for r in spawned]
    assert all("all-reduce" in o for o in ops)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_zero3_serving_steps_equal_tensor_parallel(spawned, mesh):
    """The prefill and the decode step on ZeRO-3's blocks (every leaf
    gathered over the data axes where it is used) give the tensor-parallel
    steps' tokens: the gathers rebuild the same weights."""
    for r in spawned:
        for step in ("prefill", "decode"):
            assert r[("gemma3", mesh, f"{step}_fsdp")]["tokens"] == \
                r[("gemma3", mesh, step)]["tokens"]
            assert "fsdp_gather" in r[("gemma3", mesh, f"{step}_fsdp")]["books"][1]


def test_meta_counts_cover_the_layouts(spawned):
    """The port's kinds of each layout appear in the books: the train
    layouts' data-axis collectives, remat's recompute, flash_decode's two
    all-reduces a layer beyond the head-sharded decode, and every step's
    result gather."""
    kinds = {k: spawned[0][("gemma3", "2x2", k)]["books"][1] for k in (
        "prefill", "decode", "decode_flash", "train_tp", "train_tp_remat", "train_fsdp_remat",
        "train_zero1_seqpar")}
    assert "result_gather" in kinds["prefill"] and "result_gather" in kinds["decode"]
    assert "recompute" in kinds["train_tp_remat"] and "recompute" not in kinds["train_tp"]
    assert {"fsdp_gather", "fsdp_scatter"} <= set(kinds["train_fsdp_remat"])
    assert {"grad_reduce", "zero1_gather"} <= set(kinds["train_zero1_seqpar"])
    layers = get_config("gemma3-12b").scaled_down().num_layers
    reduces = {k: spawned[0][("gemma3", "2x2", k)]["books"][0]["all-reduce"][0]
               for k in ("decode", "decode_flash")}
    assert reduces["decode_flash"] == reduces["decode"] + 2 * layers


def _reference_record(name: str) -> dict:
    path = os.path.join(os.path.dirname(__file__), "..", "experiments", "dryrun", name)
    with open(path) as f:
        return json.load(f)


def test_qwen_train_4k_1pod_against_the_reference_record():
    rec = dryrun.run_one("qwen1.5-0.5b", "train_4k", mesh="1pod", save=False, verbose=False)
    want = _reference_record("qwen1.5-0.5b_train_4k_1pod.json")
    assert rec["devices"] == want["devices"] == 256 and rec["mesh"] == "1pod"
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["cost"]["flops"] == pytest.approx(want["cost"]["flops"], rel=0.10)
    assert rec["rank"]["rows"] == 16 and rec["rank"]["layers"] == [0, 24]
    # the loss on the vocab-sharded logits, as GSPMD keeps it: the
    # reference's op kinds (all-reduces only, no gather of the logits), and
    # no tensor above the rank's (16, 4096, 151936 / 16) fp32 logits
    assert set(rec["collectives"]["bytes_by_kind"]) == set(want["collectives"]["bytes_by_kind"])
    assert rec["memory"]["largest_tensor"]["bytes"] <= 16 * 4096 * (151936 // 16) * 4


def test_qwen_decode_32k_2pod_books_the_reference_all_reduces():
    rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", mesh="2pod", save=False, verbose=False)
    want = _reference_record("qwen1.5-0.5b_decode_32k_2pod.json")
    assert rec["devices"] == want["devices"] == 512 and rec["mesh"] == "2pod"
    assert rec["collectives"]["counts"]["all-reduce"] == 1 + 2 * 24 == 49
    assert want["collectives"]["counts_r2"]["all-reduce"] == 1 + 2 * 2
    assert rec["rank"]["rows"] == 128 // 32
    # the reference's two gathers: the tokens (128 int32) and the vocab
    # pick's (value, id) pairs in fp32 over 16 model ranks (4 rows), never
    # the logits
    assert rec["collectives"]["counts"]["all-gather"] == \
        want["collectives"]["counts_r2"]["all-gather"] == 2
    assert rec["collectives"]["bytes_by_kind"]["all-gather"] == 128 * 4 + 16 * 4 * 2 * 4


def test_counting_lists_the_gathers_results():
    """``counting()`` yields the results its counted gathers made, each
    under the op and kind it was booked as; a sum makes none."""
    mesh = make_production_mesh()
    t = torch.empty(2, 3, 8, dtype=torch.bfloat16, device="meta")
    coll.reset()
    with coll.counting() as made:
        whole = coll.gather_rows(t, mesh, batch_sharding(mesh, 32, 3))
        coll.all_reduce_sum(t, mesh, "model")
    coll.reset()
    assert tuple(whole.shape) == (32, 3, 8)
    assert made == [(32 * 3 * 8 * 2, "all-gather (result_gather)", (32, 3, 8))]


def test_largest_tensor_names_a_counted_gather():
    """A rank's largest tensor made by a counted collective is named by
    its op and kind: qwen1.5-0.5b's long_500k decode step under ZeRO-3,
    whose largest tensor is the gather of the rank's vocab block of the
    embedding over the data axes. (The head's logits are no longer
    gathered: the step picks its token over the rank's vocab columns.)"""
    rec = dryrun.run_one("qwen1.5-0.5b", "long_500k", mesh="1pod", fsdp=True, save=False,
                         verbose=False)
    assert rec["memory"]["largest_tensor"] == {"bytes": 151936 // 16 * 1024 * 2,
                                               "op": "all-gather (fsdp_gather)",
                                               "shape": [151936 // 16, 1024]}


#: (config, prefill length): "A" over heads that split over 16 ranks and
#: that do not (every rank attends with every head), "L" layers with a
#: window, "X" layers beside "A"
K3_CASES = {"gemma3": ("gemma3-12b", 64), "qwen3": ("qwen3-14b", 48),
            "vlm": ("llama-3.2-vision-90b", 32)}
K3_PARAMS = [(c, m, lever) for c in K3_CASES for m in ("1pod", "2pod") for lever in (None, "model")]


@pytest.mark.parametrize("case,mesh,lever", K3_PARAMS,
                         ids=[f"{c}-{m}-{'seq' if v else 'heads'}" for c, m, v in K3_PARAMS])
def test_rank_k3_calls_are_the_prefills_attention_calls(monkeypatch, case, mesh, lever):
    """``dryrun.rank_k3_calls`` (from the rank's layout) lists exactly the
    causal self-attention calls the rank's prefill makes, which K3 runs
    on the card: the same shapes, windows and dtypes, as many times."""
    from repro_torch.models import attention as attn

    arch, seq = K3_CASES[case]
    base = get_config(arch).scaled_down()
    cfg = base.replace(num_heads=32, num_kv_heads=8) if case == "gemma3" else base
    shape = InputShape("prefill", seq, 64, "prefill")
    spec = specs.build_dryrun(cfg, shape, make_production_mesh(multi_pod=mesh == "2pod"),
                              cfg_overrides={"attn_q_seq_shard": lever} if lever else None)
    seen, plain = [], attn.attention

    def attention(q, k, v, *, causal=False, window=None, softcap=0.0, use_flash=False):
        if causal and not softcap and q.shape[1] == k.shape[1]:
            seen.append((tuple(q.shape), tuple(k.shape), window, q.dtype))
        return plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     use_flash=use_flash)

    monkeypatch.setattr(attn, "attention", attention)
    with coll.counting():
        spec.fn(*spec.args)
    coll.reset()
    assert seen
    assert sorted(map(str, dryrun.rank_k3_calls(spec, shape))) == sorted(map(str, seen))


#: each mesh variant's shape: the sequence levers and padded experts on a
#: prefill, the layouts on a train step, the flash-decode levers on a decode
VARIANT_SHAPES = {"seq-shard-attn": "prefill_32k", "seq-parallel": "prefill_32k",
                  "moe-pad48": "prefill_32k", "seq-shard+moe-pad48": "prefill_32k",
                  "fsdp": "train_4k", "fsdp+remat": "train_4k", "fsdp+moe-gather": "train_4k",
                  "zero1": "train_4k", "zero1+remat": "train_4k", "zero1+seqpar": "train_4k",
                  "flash-decode": "decode_32k", "flash-decode-2d": "decode_32k"}


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("perf"))
    # 16 heads and KV heads: the baseline decode's caches shard their heads
    cfg = get_config("granite-moe-3b-a800m").scaled_down().replace(num_heads=16,
                                                                   num_kv_heads=16)
    kw = dict(mesh="1pod", out_dir=out_dir, cfg=cfg)
    recs = {("baseline", s): perf.run_variant("granite-moe-3b-a800m", s, "baseline", **kw)
            for s in sorted(set(VARIANT_SHAPES.values()))}
    for v, s in VARIANT_SHAPES.items():
        recs[(v, s)] = perf.run_variant("granite-moe-3b-a800m", s, v, **kw)
    return recs, out_dir


@pytest.mark.parametrize("variant", sorted(VARIANT_SHAPES))
def test_mesh_variant_runs(variants, variant):
    recs, out_dir = variants
    shape = VARIANT_SHAPES[variant]
    rec, base = recs[(variant, shape)], recs[("baseline", shape)]
    assert rec["mesh"] == "1pod" and rec["devices"] == 256 and rec["variant"] == variant
    assert rec["vs_baseline"]["flops"] == pytest.approx(rec["flops"] / base["flops"])
    assert rec["collective_bytes"] > 0 and rec["coll_by_kind"]
    assert rec["t_collective_s"] > 0 and rec["link"].startswith("InfiniBand")
    if variant.startswith("fsdp"):
        assert rec["param_bytes"] < base["param_bytes"]
        assert rec["coll_counts"]["reduce-scatter"] > 0
    if variant.startswith("zero1"):
        assert rec["opt_state_bytes"] < base["opt_state_bytes"]
        assert rec["param_bytes"] == base["param_bytes"]
    if variant.startswith("flash-decode"):
        layers = sum(m == "A" for m in get_config("granite-moe-3b-a800m").scaled_down()
                     .mixer_pattern)
        assert rec["coll_counts"]["all-reduce"] == base["coll_counts"]["all-reduce"] + 2 * layers
    if "moe-pad48" in variant:
        assert rec["flops"] < base["flops"]
    lines = open(os.path.join(out_dir, f"granite-moe-3b-a800m_{shape}.jsonl")).read()
    assert f'"variant": "{variant}"' in lines


def test_cli_mesh_flags_and_one_card_refusal(tmp_path):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh", "1pod",
                     "--multi-pod", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="--mesh 1pod or --multi-pod"):
        perf.run_variant("qwen1.5-0.5b", "train_4k", "fsdp", out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="mesh="):
        specs.build_dryrun(get_config("qwen1.5-0.5b").scaled_down(),
                           InputShape("t", 16, 4, "train"), fsdp=True)
