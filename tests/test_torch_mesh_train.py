"""LM training under a ``("data", "model")`` mesh on the CPU, against the
reference's unsharded train step (``jax.value_and_grad`` of its loss,
then its ``AdamW.update``).

Ranks are spawned processes in a gloo process group
(``sharded_selftest.spawn_ranks``): one spawn at world 2 for the meshes
(1, 2) and (2, 1), one at world 4 for (2, 2). The reference runs once in
the pytest process; its numpy results are handed to the ranks through a
file, and each rank holds its own blocks against them (the ranks never
import ``jax``). The families, scaled down: "A" (olmo-1b), "L"
(gemma3-12b, window 8, past it at 16 positions), "M" (mamba2-2.7b at 2
layers, so that ZeRO-3 cuts ``A_log``/``D``/``dt_bias`` on the repeat
axis: the broadcast path), "E" (deepseek-moe-16b, its aux loss in the
objective; experts sharded over "model"), "X" (llama-3.2-vision-90b with
image embeddings), codebooks with a tied head (musicgen-medium), and two
attention cases at 2 ranks of "model": ``kv_odd`` (qwen1.5-0.5b with 6
query heads over 3 KV heads: the rank's query heads read a slice of the
replicated ``wk``/``wv``/``bk``/``bv``, in uneven groups) and ``h_odd``
(qwen3-14b with 3 heads: ``wq`` replicated, q/k norms).

Bounds (``tests/test_torch_lm_train.py``'s): the loss within 1e-5
relative, ce and aux within 1e-6; each rank's block of every gradient
leaf within 2e-4·(1 + max|g|); its block of every new leaf within
2e-4·(1 + max|update|) where the clipped gradient is above
``WELL_CONDITIONED``, else 2·lr. The clip scale the same bits on every
rank and within 1e-6 of the reference's. Layouts "fsdp" (ZeRO-3) and
"zero1" at (2, 1) and (2, 2) within the same bounds of the "tp" layout's
blocks. ``remat`` "full" and "dots" at (1, 2) exactly "none"'s bits. The
sequence levers under autograd at (1, 2) within the same bounds.
``train_loop(mesh=)`` and the selftest's training plan are
``tests/test_torch_mesh_train_loop.py``'s.
"""

import datetime
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
from repro.data import tokens as jtokens
from repro.models import transformer as jtr
from repro.optim import AdamW as JAdamW
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.launch import steps as tsteps
from repro_torch.launch.sharded_selftest import flat_tree, put_result, spawn_ranks
from repro_torch.launch.specs import train_layout
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamW
from repro_torch.parallel import init_mesh
from repro_torch.parallel.sharding import RowSharding

LOSS_RTOL = 1e-5
PART_TOL = 1e-6
GRAD_TOL = 2e-4
LR = 1e-3
WELL_CONDITIONED = 1e3 * 1e-8
B, S = 4, 16
CASES = {
    "A": ("olmo-1b", {}),
    "L": ("gemma3-12b", dict(sliding_window=8)),
    "M": ("mamba2-2.7b", dict(num_layers=2)),
    "E": ("deepseek-moe-16b", {}),
    "X": ("llama-3.2-vision-90b", {}),
    "codebooks": ("musicgen-medium", dict(tie_embeddings=True)),
    "kv_odd": ("qwen1.5-0.5b", dict(num_heads=6, num_kv_heads=3, head_dim=32)),
    "h_odd": ("qwen3-14b", dict(num_heads=3, num_kv_heads=3, head_dim=32)),
}
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
LAYOUTS = ("tp", "fsdp", "zero1")
REMAT_CASES = ("L", "E")
#: the cases trained at (1, 2) with ``attn_q_seq_shard`` and
#: ``residual_seq_shard`` over "model" (every sequence split and gather
#: carries its backward)
LEVER_CASES = ("A", "L", "M", "E", "codebooks", "kv_odd")


def _cfg(mod, name):
    arch, over = CASES[name]
    return mod.get_config(arch).scaled_down().replace(**over)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    K = cfg.num_codebooks
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S) + ((K,) if K > 1 else ()))
         .astype(np.int32)}
    if cfg.vision_dim:
        b["cross_embeds"] = rng.standard_normal((B, cfg.num_patches, cfg.vision_dim)) \
            .astype(np.float32)
    return b


def _jloss(jcfg):
    def loss_fn(p, batch):
        logits, aux = jtr.forward(p, batch["tokens"], jcfg,
                                  cross_embeds=batch.get("cross_embeds"))
        ce = jtokens.lm_loss(logits, batch["tokens"])
        return ce + aux, (ce, aux)
    return loss_fn


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flat_tree(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per case: the reference's tree and batch, its loss, ce and aux, its
    gradients, its AdamW update's new leaves (lr 1e-3, defaults otherwise)
    and clip scale; per leaf max|g| and max|update|. Written to a file
    for the ranks."""
    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    out = {}
    for name in CASES:
        jcfg = _cfg(jconfigs, name)
        jparams = jtr.init_model(jcfg, jax.random.PRNGKey(11))
        batch = _batch(jcfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (jl, (jce, jaux)), jg = jax.jit(jax.value_and_grad(_jloss(jcfg), has_aux=True))(
            jparams, jbatch)
        jopt = JAdamW(lr=LR)
        jnew, _ = jax.jit(jopt.update)(jg, jopt.init(jparams), jparams)
        clip = jnp.minimum(1.0, jopt.clip_norm / jnp.maximum(jadamw.global_norm(jg), 1e-9))
        old, grads, new = _flat_np(jparams), _flat_np(jg), _flat_np(jnew)
        out[name] = {"tree": jax.tree.map(np.asarray, jparams), "batch": batch,
                     "loss": float(jl), "ce": float(jce), "aux": float(jaux),
                     "clip": float(clip), "grads": grads, "new": new, "old": old,
                     "grad_max": {k: float(np.abs(g).max()) for k, g in grads.items()},
                     "update_max": {k: float(np.abs(new[k] - old[k]).max()) for k in new}}
    path = os.path.join(tmp, "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return out, path


def _hold(got: dict, ref: dict, shards: dict, clip: float) -> dict:
    """Each leaf's gradient and new block against the reference's: (max
    error, bound) of the gradient; (max error where well conditioned, its
    bound, max error anywhere) of the new value."""
    grads, news = {}, {}
    for key, g in got["grads"].items():
        idx = shards[key].index(ref["grads"][key].shape)
        g_ref = ref["grads"][key][idx]
        grads[key] = (float(np.abs(g.numpy() - g_ref).max()),
                      GRAD_TOL * (1 + ref["grad_max"][key]))
        err = np.abs(got["new"][key].numpy() - ref["new"][key][idx])
        sharp = np.abs(g_ref) * clip > WELL_CONDITIONED
        news[key] = (float(err[sharp].max()) if sharp.any() else 0.0,
                     GRAD_TOL * (1 + ref["update_max"][key]), float(err.max()))
    return {"grads": grads, "new": news}


def _against(got: dict, base: dict, shards: dict) -> dict:
    """Blocks of another layout against the "tp" layout's (``base``, the
    tensor-parallel blocks, cut to ``got``'s by the data part of
    ``shards``): the largest error over each leaf's bound, per part."""
    out = {}
    for part, tol in (("grads", "grad_max"), ("new", "update_max")):
        worst = 0.0
        for key, t in got[part].items():
            want = shards[key].data_part().local(base[part][key])
            err = float((t - want).abs().max()) if t.numel() else 0.0
            worst = max(worst, err / (GRAD_TOL * (1 + base[tol][key])))
        out[part] = worst
    return out


def _one_step(mesh, cfg, full, ref, layout, remat="none"):
    """One train step of the rank's shard (cut from ``full``, the
    reference's weights) under ``layout``: the metrics, the clip scale's
    bits, and the rank's gradient and new blocks."""
    lay = train_layout(cfg, mesh, layout)
    params = tr.shard_params(full, mesh, cfg, lay.params)
    opt = AdamW(lr=LR)
    step = tsteps.make_train_step(cfg, opt, remat=remat, mesh=mesh, shardings=lay)
    seen = {}
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    params, _, m = step(params, tsteps.init_opt_state(opt, params, lay), batch, record=seen)
    clip = m["clip_scale"].reshape(1)
    return {"loss": float(m["loss"]), "ce": float(m["ce"]), "aux": float(m["moe_aux"]),
            "clip": float(clip), "clip_bits": int(clip.view(torch.int32)),
            "grads": {k: g.detach().clone() for k, g in flat_tree(seen["grads"]).items()},
            "new": {k: p.detach().clone() for k, p in flat_tree(params).items()},
            "shards": flat_tree(lay.params)}


def _refusals(mesh, ref):
    """A batch that does not split over "data", and an "E" layer whose
    gathered rows are not the batch its groups were cut from."""
    cfg = _cfg(configs, "E")
    params = tr.shard_params(tr.params_from_jax(ref["tree"], cfg, device="cpu"), mesh, cfg)
    opt = AdamW(lr=LR)
    step = tsteps.make_train_step(cfg, opt, mesh=mesh)
    toks = torch.from_numpy(ref["batch"]["tokens"])
    out = {}
    try:
        step(params, opt.init(params), {"tokens": toks[:3]})
    except ValueError as e:
        out["uneven"] = str(e)
    rows = RowSharding(mesh, ("data",), B + 2, 2)
    try:
        with torch.enable_grad():
            tr.forward(params, toks[:B // 2], cfg, mesh=mesh, rows=rows, use_flash=False)
    except ValueError as e:
        out["groups"] = str(e)
    return out


def _rank(rank, world, port, out_dir, ref_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with open(ref_path, "rb") as f:
            refs = pickle.load(f)
        out = {}
        for data, model in MESHES[world]:
            mesh = init_mesh(data, model, device="cpu")
            per = out[(data, model)] = {"coord": mesh.coordinate}
            for name in CASES:
                cfg, ref = _cfg(configs, name), refs[name]
                full = tr.params_from_jax(ref["tree"], cfg, device="cpu")
                res = per[name] = {}
                tp = None
                for layout in LAYOUTS if data > 1 else ("tp",):
                    got = _one_step(mesh, cfg, full, ref, layout)
                    res[layout] = {k: got[k] for k in ("loss", "ce", "aux", "clip", "clip_bits")}
                    res[layout]["hold"] = _hold(got, ref, got["shards"], ref["clip"])
                    if layout == "tp":
                        tp = dict(got, grad_max=ref["grad_max"], update_max=ref["update_max"])
                    else:
                        res[layout]["vs_tp"] = _against(got, tp, got["shards"])
                if (data, model) == (1, 2) and name in LEVER_CASES:
                    lcfg = cfg.replace(attn_q_seq_shard="model", residual_seq_shard="model")
                    got = _one_step(mesh, lcfg, full, ref, "tp")
                    res["levers"] = {k: got[k] for k in ("loss", "clip", "clip_bits")}
                    res["levers"]["hold"] = _hold(got, ref, got["shards"], ref["clip"])
                if (data, model) == (1, 2) and name in REMAT_CASES:
                    for remat in ("full", "dots"):
                        got = _one_step(mesh, cfg, full, ref, "tp", remat)
                        res[remat] = {"loss": got["loss"] == tp["loss"], "same_bits": all(
                            torch.equal(got[part][k], tp[part][k])
                            for part in ("grads", "new") for k in tp[part])}
            if world == 2:
                per["refusals"] = _refusals(mesh, refs["E"])
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(reference):
    return {w: spawn_ranks(_rank, w, reference[1]) for w in (2, 4)}


def _ranks(spawned, world, mesh, name):
    return [r[mesh][name] for r in spawned[world]]


STEP_CASES = [(w, m, n, lay) for w in (2, 4) for m in MESHES[w] for n in CASES
              for lay in (LAYOUTS if m[0] > 1 else ("tp",))]


@pytest.mark.parametrize("world,mesh,name,layout", STEP_CASES)
def test_loss_and_gradient_blocks_match_reference(spawned, reference, world, mesh, name,
                                                  layout):
    ref = reference[0][name]
    for res in _ranks(spawned, world, mesh, name):
        got = res[layout]
        assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
        assert abs(got["ce"] - ref["ce"]) <= PART_TOL * max(1.0, ref["ce"])
        assert abs(got["aux"] - ref["aux"]) <= PART_TOL
        assert (ref["aux"] > 0) == (name == "E")
        for key, (err, bound) in got["hold"]["grads"].items():
            assert err <= bound, f"{name} {layout} {key}: max|Δg| {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("world,mesh,name,layout", STEP_CASES)
def test_update_and_clip_scale_match_reference(spawned, reference, world, mesh, name, layout):
    """Each rank's new blocks against the reference's AdamW update; the
    clip scale the same bits on every rank, within 1e-6 of the
    reference's."""
    ref = reference[0][name]
    ranks = _ranks(spawned, world, mesh, name)
    assert len({r[layout]["clip_bits"] for r in ranks}) == 1
    for res in ranks:
        got = res[layout]
        assert abs(got["clip"] - ref["clip"]) <= 1e-6
        for key, (sharp, bound, anywhere) in got["hold"]["new"].items():
            assert sharp <= bound, f"{name} {layout} {key}: {sharp:.3e} > {bound:.3e}"
            assert anywhere <= 2 * LR, f"{name} {layout} {key}: {anywhere:.3e}"


@pytest.mark.parametrize("world,mesh,name,layout",
                         [c for c in STEP_CASES if c[3] != "tp"])
def test_zero_layouts_equal_tensor_parallel(spawned, world, mesh, name, layout):
    """ZeRO-3 and ZeRO-1 against the "tp" layout on the same mesh: every
    gradient and new block within the bounds, the same metrics to
    1e-6."""
    for res in _ranks(spawned, world, mesh, name):
        got, tp = res[layout], res["tp"]
        assert got["vs_tp"]["grads"] <= 1.0 and got["vs_tp"]["new"] <= 1.0, got["vs_tp"]
        assert abs(got["loss"] - tp["loss"]) <= PART_TOL * max(1.0, abs(tp["loss"]))
        assert abs(got["clip"] - tp["clip"]) <= PART_TOL


@pytest.mark.parametrize("name", LEVER_CASES)
def test_seq_levers_train_within_the_bounds(spawned, reference, name):
    """``attn_q_seq_shard`` and ``residual_seq_shard`` at (1, 2): the
    sequence splits and gathers carry their backward passes, and every
    gradient and new block stays within the reference's bounds."""
    ref = reference[0][name]
    for res in _ranks(spawned, 2, (1, 2), name):
        got = res["levers"]
        assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
        for key, (err, bound) in got["hold"]["grads"].items():
            assert err <= bound, f"{name} {key}: max|Δg| {err:.3e} > {bound:.3e}"
        for key, (sharp, bound, anywhere) in got["hold"]["new"].items():
            assert sharp <= bound and anywhere <= 2 * LR, key


@pytest.mark.parametrize("name", REMAT_CASES)
def test_remat_under_a_mesh_is_exact(spawned, name):
    """``remat`` "full" and "dots" recompute each layer, its collectives
    with it, and give "none"'s loss, gradients and update bit for bit."""
    for res in _ranks(spawned, 2, (1, 2), name):
        for remat in ("full", "dots"):
            assert res[remat]["loss"] and res[remat]["same_bits"], remat


def test_refusals_under_a_mesh(spawned):
    """A batch that does not split over "data", and rows that do not
    gather to the batch an "E" layer's groups hold: ``ValueError``."""
    for r in spawned[2]:
        got = r[(2, 1)]["refusals"]
        assert "does not split evenly" in got["uneven"]
        assert "routes groups of the whole batch" in got["groups"]
    assert "uneven" not in spawned[2][0][(1, 2)]["refusals"]  # no data axis to split


def test_fsdp_leaf_on_the_repeat_axis():
    """ZeRO-3 on the 2-layer "M" case at (2, 1): ``A_log``, ``D`` and
    ``dt_bias`` are cut over "data" on the repeat axis (one layer a rank),
    the case whose gather is a broadcast from the layer's owner."""
    from repro_torch.parallel.mesh import Mesh

    cfg = _cfg(configs, "M")
    lay = train_layout(cfg, Mesh(("data", "model"), (2, 1), (1, 0)), "fsdp")
    mixer = lay.params["blocks"]["p0"]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert mixer[name].data_dim() == 0
        assert mixer[name].local_shape((2, 16)) == (1, 16)
    assert mixer["in_x"].data_dim() not in (None, 0)


def test_train_step_without_a_mesh_is_unchanged():
    """``make_train_step`` without a mesh keeps its metrics; ``record``
    receives the gradients and the clip scale."""
    cfg = _cfg(configs, "A")
    params = tr.init_model(cfg, 0, device="cpu")
    opt = AdamW(lr=LR)
    seen = {}
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    _, _, m = tsteps.make_train_step(cfg, opt, device="cpu")(params, opt.init(params), b,
                                                            record=seen)
    assert set(m) == {"loss", "ce", "moe_aux"}
    assert set(seen) == {"grads", "clip_scale"} and 0 < float(seen["clip_scale"]) <= 1
