"""The dry run on meta tensors and the H100 roofline: ``launch/specs.py``,
``launch/dryrun.py``, ``launch/perf.py``, ``analysis/roofline.py`` and
``launch/sample.py --dryrun``.

* ``_param_counts`` and ``model_flops_per_device`` equal the reference's
  (``repro.analysis.roofline``, through ``jax.eval_shape``, no mesh) for
  every architecture × shape: the total count exactly, the active count
  (a float sum with the routed experts' top_k / num_experts share) within
  1e-12 relative;
* a scaled-down dense prefill's counted FLOPs equal a hand count of its
  products and its attention within 1 %;
* a prefill's cost on the card (``step_cost``) counts K3's layers by
  their visible pairs and q, k, v and the output once, exactly as a hand
  count, causal and windowed; train and decode keep the plain count;
* remat "full" counts more train FLOPs than "none";
* every architecture at scaled-down widths runs its train, prefill and
  decode step on meta tensors, and no operator makes a tensor off the
  meta device;
* ``analyze_record`` and ``score_eval_markdown`` on hand-made records;
* ``_precision_record``'s bytes equal the reference's field for field
  for HIGHRES_DIT at batch 512 under every preset (a one-device mesh).
"""

import json
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis import roofline as jroof
from repro.configs import diffusion as jdiff
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import sample as jsample
from repro.models import dit as jdit
from repro_torch.analysis import roofline
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, get_config
from repro_torch.launch import dryrun, perf, sample
from repro_torch.launch.specs import build_dryrun

torch.set_num_threads(2)

COMBOS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", COMBOS, ids=[f"{a}-{s}" for a, s in COMBOS])
def test_model_flops_match_reference(arch, shape):
    got = roofline.model_flops_per_device(arch, shape, 1)
    want = jroof.model_flops_per_device(arch, shape, 1)
    assert got["params_total"] == want["params_total"]
    for key in ("params_active", "model_flops_total", "model_flops_per_device"):
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key


def test_dense_prefill_flops_equal_a_hand_count():
    """olmo-1b scaled down, (2, 64) prefill, head on the last position:
    q/k/v/o, the gated MLP's three products, QKᵀ and PV over every (query,
    key) pair of the plain path, and the head."""
    cfg = get_config("olmo-1b").scaled_down()
    B, S = 2, 64
    spec = build_dryrun(cfg, InputShape("p64", S, B, "prefill"), dtype="float32")
    got = dryrun.count(spec.fn, *spec.args)["flops"]
    E, H, Kv, Dh, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                          cfg.d_ff, cfg.vocab_size)
    T = B * S
    proj = 2 * T * E * Dh * (2 * H + 2 * Kv)
    mlp = 2 * T * E * F * (3 if cfg.glu else 2)
    attn = 2 * 2 * B * H * S * S * Dh
    want = cfg.num_layers * (proj + mlp + attn) + 2 * B * E * V
    assert got == pytest.approx(want, rel=0.01)


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-12b"])
def test_prefill_cost_counts_k3_visible_pairs(arch):
    """olmo-1b (causal "A") and gemma3-12b ("L" with a window of 16 once
    scaled down, and "A") at a (2, 64) prefill in fp32: FLOPs as the
    dense hand count with QKᵀ and PV over the visible pairs only; bytes as
    the plain path's less its fp32 attention products (QKᵀ reads q and k
    and writes the scores, PV reads them and v and writes the output:
    4·B·Hq·(4·S·D + 2·S²) a layer) plus K3's q, k, v and output."""
    cfg = get_config(arch).scaled_down()
    B, S = 2, 64
    shape = InputShape("p64", S, B, "prefill")
    cost = dryrun.step_cost(build_dryrun(cfg, shape, dtype="float32"), shape)
    E, H, Kv, Dh, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                          cfg.d_ff, cfg.vocab_size)
    T = B * S
    proj = 2 * T * E * Dh * (2 * H + 2 * Kv)
    mlp = 2 * T * E * F * (3 if cfg.glu else 2)
    windows = [cfg.sliding_window if m == "L" else None for m in cfg.mixer_pattern]
    pairs = cfg.num_repeats * sum(
        sum(min(i + 1, w or S) for i in range(S)) for w in windows)
    dense = cfg.num_layers * (proj + mlp + 4 * B * H * Dh * S * S) + 2 * B * E * V
    assert cost["flops"] == cfg.num_layers * (proj + mlp) + 4 * B * H * Dh * pairs + 2 * B * E * V
    assert cost["plain_path"]["flops"] == dense
    per_layer = 4 * B * S * Dh * (2 * H + 2 * Kv) - 4 * B * H * (4 * S * Dh + 2 * S * S)
    assert cost["est_hbm_traffic_bytes"] == (cost["plain_path"]["est_hbm_traffic_bytes"]
                                             + cfg.num_layers * per_layer)
    for kind in ("train", "decode"):
        assert dryrun.k3_correction(cfg, InputShape("x", S, B, kind)) == {"flops": 0.0,
                                                                          "bytes": 0.0}


def test_remat_full_counts_more_train_flops():
    cfg = get_config("qwen1.5-0.5b").scaled_down()
    shape = InputShape("t64", 64, 2, "train")
    counts = {}
    for remat in ("none", "full"):
        spec = build_dryrun(cfg, shape, remat=remat)
        counts[remat] = dryrun.count(spec.fn, *spec.args)["flops"]
    assert counts["full"] > counts["none"] > 0


class _OnMeta(TorchDispatchMode):
    """Records the device of every tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree_util.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


KINDS = [(a, s) for a in ARCH_IDS for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", KINDS, ids=[f"{a}-{s}" for a, s in KINDS])
def test_every_arch_runs_on_meta(arch, shape):
    cfg = get_config(arch).scaled_down()
    guard = _OnMeta()
    with guard:
        rec = dryrun.run_one(arch, shape, cfg=cfg, save=False, verbose=False)
    assert guard.devices == {"meta"}
    assert rec["devices"] == 1 and rec["kind"] == SHAPES[shape].kind
    assert rec["cost"]["flops"] > 0 and rec["cost"]["est_hbm_traffic_bytes"] > 0
    assert rec["memory"]["param_bytes"] > 0
    assert (rec["memory"]["opt_state_bytes"] > 0) == (rec["kind"] == "train")
    assert (rec["memory"]["decode_state_bytes"] > 0) == (rec["kind"] == "decode")


def test_run_one_writes_a_record_that_load_all_reads(tmp_path):
    cfg = get_config("mamba2-2.7b").scaled_down()
    rec = dryrun.run_one("mamba2-2.7b", "decode_32k", cfg=cfg, out_dir=str(tmp_path),
                         verbose=False)
    recs = roofline.load_all(str(tmp_path))
    assert list(recs) == ["mamba2-2.7b:decode_32k"]
    assert recs["mamba2-2.7b:decode_32k"]["cost"]["flops"] == rec["cost"]["flops"]
    table = roofline.table(recs, md=True)
    assert table.splitlines()[2].startswith("| mamba2-2.7b | decode_32k | bfloat16 |")


def test_analyze_record_by_hand():
    rec = {"arch": "olmo-1b", "shape": "prefill_32k", "devices": 1, "dtype": "bfloat16",
           "cost": {"flops": 989e12, "est_hbm_traffic_bytes": 3.35e12 * 0.5},
           "collectives": {"total_bytes": 0},
           "memory": {"param_bytes": 2 ** 30, "opt_state_bytes": 0,
                      "decode_state_bytes": 2 ** 30}}
    a = roofline.analyze_record(rec, model_flops=494.5e12)
    assert a["t_compute_s"] == pytest.approx(1.0) and a["t_memory_s"] == pytest.approx(0.5)
    assert a["t_collective_s"] == 0 and a["dominant"] == "compute"
    assert a["useful_ratio"] == pytest.approx(0.5)
    assert a["mfu_upper_bound"] == pytest.approx(0.5)
    assert a["resident_gib"] == pytest.approx(2.0)
    fp32 = dict(rec, dtype="float32", cost={"flops": 67e12, "est_hbm_traffic_bytes": 0})
    assert roofline.analyze_record(fp32, model_flops=1.0)["t_compute_s"] == pytest.approx(1.0)
    mem = dict(rec, cost={"flops": 0.0, "est_hbm_traffic_bytes": 6.7e12})
    assert roofline.analyze_record(mem, model_flops=1.0)["dominant"] == "memory"
    assert roofline.share_of_peak(494.5e12, 1.0, "bfloat16") == pytest.approx(0.5)
    with pytest.raises(ValueError):
        roofline.peak_flops("float16")


def test_score_eval_markdown_by_hand():
    art = {"card": "a test card, 700 W", "rows": [
        {"workload": "dit", "preset": "bf16", "variant": "flash", "us_per_call": 1000.0,
         "flops_per_nfe": 494.5e9, "bytes_per_nfe": 1e6},
        {"workload": "dit", "preset": "fp32", "variant": "plain", "us_per_call": 2000.0,
         "flops_per_nfe": 1e6, "bytes_per_nfe": 3.35e9, "dtype": "float32"}]}
    lines = roofline.score_eval_markdown(art).splitlines()
    assert lines[0].startswith("| workload | preset | variant | us/NFE | GFLOP/NFE")
    first = [c.strip() for c in lines[2].strip("|").split("|")]
    assert first[3:5] == ["1000.0", "494.50"] and first[7] == "compute"
    assert first[8] == "494500.00" and float(first[9]) == pytest.approx(0.5)
    second = [c.strip() for c in lines[3].strip("|").split("|")]
    assert second[7] == "memory"
    assert "a test card, 700 W" in lines[-1]


def test_score_eval_cli(tmp_path, capsys):
    art = {"rows": [{"workload": "w", "preset": "bf16", "variant": "v", "us_per_call": 1.0,
                     "flops_per_nfe": 1e9, "bytes_per_nfe": 1e9}]}
    path = tmp_path / "art.json"
    path.write_text(json.dumps(art))
    roofline.main(["--score-eval", str(path)])
    assert "| w | bf16 | v |" in capsys.readouterr().out


@pytest.mark.parametrize("preset", ["fp32", "bf16", "bf16_full"])
def test_precision_record_matches_reference(preset):
    """``launch/sample.py --dryrun``'s policy record: the reference's
    ``_precision_record`` on a one-device mesh, field for field."""
    jpol = JPolicy(preset)
    params = jax.eval_shape(jpol.cast_params, jax.eval_shape(
        lambda k: jdit.init_dit(jdiff.HIGHRES_DIT, k), jax.random.PRNGKey(0)))
    x = jax.ShapeDtypeStruct((512, 256, 256, 3), jpol.state)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    want = jsample._precision_record(jpol, params, x, mesh)
    got = sample.dryrun(512, preset, save=False)
    assert got["precision"] == want
    assert got["devices"] == 1 and got["cost"]["flops"] > 2 * got["per_nfe"]["flops"] * 0.99


def test_sample_dryrun_cli_and_mesh_modes(tmp_path):
    recs = sample.main(["--dryrun", "--batch", "4", "--precision", "bf16_full",
                        "--out", str(tmp_path)])
    assert recs[0]["shape"] == "sample_b4_256px"
    assert (tmp_path / "dit-highres-sampler_sample_b4_256px_1card_bf16_full.json").exists()
    # the sampler's mesh dry runs write their records, and so do the LMs'
    for flags, name in ((["--dryrun-loop", "--loop-devices", "4"],
                         "dit-cifar-sampler-whole-loop_sample_b4_32px_data4.json"),
                        (["--multi-pod", "--pipeline"],
                         "dit-highres-sampler-pipelined_sample_b4_256px_2pod.json"),
                        (["--multi-pod"], "dit-highres-sampler_sample_b4_256px_2pod.json")):
        sample.main(flags + ["--batch", "4", "--out", str(tmp_path)])
        assert (tmp_path / name).exists()
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--multi-pod",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen1.5-0.5b_decode_32k_2pod.json").read_text())
    assert rec["mesh"] == "2pod" and rec["devices"] == 512


def test_perf_variants(tmp_path):
    cfg = get_config("deepseek-moe-16b").scaled_down()
    kw = dict(out_dir=str(tmp_path), cfg=cfg)
    base = perf.run_variant("deepseek-moe-16b", "prefill_32k", "baseline", **kw)
    last = perf.run_variant("deepseek-moe-16b", "prefill_32k", "last-logits", **kw)
    gather = perf.run_variant("deepseek-moe-16b", "prefill_32k", "moe-gather", **kw)
    assert last["flops"] < base["flops"] and gather["flops"] < last["flops"]
    assert last["vs_baseline"]["flops"] == pytest.approx(last["flops"] / base["flops"])
    lines = (tmp_path / "deepseek-moe-16b_prefill_32k.jsonl").read_text().splitlines()
    assert [json.loads(line)["variant"] for line in lines] == [
        "baseline", "last-logits", "moe-gather"]
    for variant in ("fsdp", "zero1", "seq-shard-attn"):
        with pytest.raises(ValueError, match="--mesh 1pod or --multi-pod"):
            perf.run_variant("deepseek-moe-16b", "prefill_32k", variant, **kw)
        rec = perf.run_variant("deepseek-moe-16b", "prefill_32k", variant, mesh="1pod", **kw)
        assert rec["mesh"] == "1pod" and rec["variant"] == variant and "vs_baseline" not in rec
    remat = perf.run_variant("qwen1.5-0.5b", "train_4k", "remat-dots",
                             out_dir=str(tmp_path), cfg=get_config("qwen1.5-0.5b").scaled_down())
    assert remat["dominant"] in ("compute", "memory") and math.isfinite(remat["flops"])
