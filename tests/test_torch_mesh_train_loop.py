"""``train_loop(mesh=)`` and the sharded selftest's training plan on the
CPU (gloo ranks spawned at world 2, one spawn a test).

``train_loop(mesh=)`` for 3 steps at meshes (1, 2) and (2, 1) replays the
reference's own ``train_loop`` (musicgen-medium scaled down): each rank
draws the reference's initial tree and tokens in place of the port's
seeded ones (``init_model`` and ``synth_batch`` patched in the rank's
process) and trains under the reference's warmup-cosine schedule. The
reference runs on an Auto-axes 1×1 mesh: its default host mesh has
Explicit axes under jax 0.9.0, on which it fails (ROADMAP §C). Every
rank's losses are the same, within 1e-5 relative of the reference's.
The checkpoint global rank 0 writes holds the reference checkpoint's
keys and shapes; each value is within 2e-4·(1 + max|Δ|) of the
reference's, Δ the reference's move from its initial tree, where the
clipped gradient is above ``WELL_CONDITIONED`` at every step (the port's
unsharded replay of the same steps finds those elements), and within
2·Σ lr_t elsewhere (``tests/test_torch_lm_train.py``'s bounds, a step
at a time). The peak lr is high enough that the bound tells the steps
apart: the initial tree and the replay's tree one step short miss it.
A world-1 group in this process: ``train_loop(mesh=)`` on a 1×1 mesh
equals the unsharded loop bit for bit (losses and parameters).

The training plan (``sharded_selftest.run_train``): gemma3-12b scaled
down at (1, 2) "tp", "tp" with ``remat="full"`` (bitwise the first), and
at (2, 1) "fsdp" and "zero1", against an unsharded record made here by
``train_record``; then a ``train_loop`` run.
"""

import datetime
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
from repro.data import tokens as jtokens
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.launch import sharded_selftest as st
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.parallel import init_mesh

LOSS_RTOL = 1e-5
#: the train_loop replay's peak lr: its last step (lr/10 under warmup-cosine)
#: moves a weight by more than the bound below, so a stale tree misses it
LOOP_LR = 1e-2
#: the training plan's lr
LR = 1e-3
B, S = 4, 16
ARCH, STEPS = "musicgen-medium", 3
MESHES = ((1, 2), (2, 1))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``train_loop`` and what replaying it needs: its
    initial tree and its tokens (the image embeddings do not arise:
    musicgen has no cross-attention); and the port's unsharded replay of
    the same steps: where the clipped gradient is above
    ``WELL_CONDITIONED`` at every step, and its tree one step short."""
    from jax.sharding import Mesh

    from repro.launch.train import train_loop as jtrain_loop

    tmp = str(tmp_path_factory.mktemp("mesh_train_loop"))
    jcfg = jconfigs.get_config(ARCH).scaled_down()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ckpt = os.path.join(tmp, "reference_ckpt")
    _, losses = jtrain_loop(jcfg, steps=STEPS, batch=B, seq=S, lr=LOOP_LR, mesh=mesh,
                            ckpt_dir=ckpt, log_every=STEPS)
    pipe = jtokens.TokenPipelineConfig(vocab_size=jcfg.vocab_size, seq_len=S, global_batch=B,
                                       num_codebooks=jcfg.num_codebooks, seed=0)
    npz = [f for f in os.listdir(ckpt) if f.endswith(".npz")]
    ref = {"losses": losses,
           "tree": jax.tree.map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(0))),
           "tokens": [np.asarray(jtokens.synth_batch(pipe, s)) for s in range(STEPS)],
           "ckpt": dict(np.load(os.path.join(ckpt, npz[0])))}
    cfg = configs.get_config(ARCH).scaled_down()
    params = tr.params_from_jax(ref["tree"], cfg, device="cpu")
    ref["initial"] = _flat_numpy(params)
    opt = AdamW(lr=warmup_cosine(LOOP_LR, max(STEPS // 10, 1), STEPS))
    state, step = opt.init(params), make_train_step(cfg, opt, device="cpu")
    sharp = None
    for i, toks in enumerate(ref["tokens"]):
        if i == STEPS - 1:
            ref["one_short"] = _flat_numpy(params)
        seen = {}
        params, state, _ = step(params, state, {"tokens": torch.tensor(toks)}, record=seen)
        clip = float(seen["clip_scale"])
        now = {f"params/{k}": g.abs().numpy() * clip > st.WELL_CONDITIONED
               for k, g in st.flat_tree(seen["grads"]).items()}
        sharp = now if sharp is None else {k: sharp[k] & now[k] for k in now}
    ref["sharp"] = sharp
    path = os.path.join(tmp, "loop.pkl")
    with open(path, "wb") as f:
        pickle.dump({k: ref[k] for k in ("tree", "tokens")}, f)
    return ref, path, tmp


def _flat_numpy(params) -> dict:
    return {f"params/{k}": v.detach().numpy().copy() for k, v in st.flat_tree(params).items()}


def _checkpoint_misses(got: dict, ref: dict) -> dict:
    """Each leaf of ``got`` against the reference checkpoint: the ratio of
    its worst error to the bound (module docstring), by key, where it
    exceeds 1."""
    sched = warmup_cosine(LOOP_LR, max(STEPS // 10, 1), STEPS)
    loose = 2 * sum(float(sched(torch.full((), s + 1.0))) for s in range(STEPS))
    out = {}
    for key, want in ref["ckpt"].items():
        err = np.abs(got[key] - want)
        sharp = ref["sharp"][key]
        tight = st.TRAIN_GRAD_TOL * (1 + np.abs(want - ref["initial"][key]).max())
        ratio = max(err[sharp].max() / tight if sharp.any() else 0.0, err.max() / loose)
        if ratio > 1:
            out[key] = float(ratio)
    return out


def _loop_rank(rank, world, port, out_dir, ref_path, ckpt_base):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        cfg = configs.get_config(ARCH).scaled_down()
        # the reference's draws in place of the port's seeded ones (this process only)
        ttrain.init_model = lambda cfg, seed, device, mesh: tr.shard_params(
            tr.params_from_jax(ref["tree"], cfg, device=device), mesh, cfg)
        ttrain.synth_batch = lambda pipe, step: torch.from_numpy(ref["tokens"][step])
        out = {}
        for data, model in MESHES:
            mesh = init_mesh(data, model, device="cpu")
            ckpt = os.path.join(ckpt_base, f"mesh{data}x{model}")
            _, losses = ttrain.train_loop(cfg, steps=STEPS, batch=B, seq=S, lr=LOOP_LR,
                                          mesh=mesh, ckpt_dir=ckpt, log_every=STEPS)
            out[(data, model)] = {"losses": losses, "ckpt": ckpt}
        st.put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def loops(reference):
    _, path, tmp = reference
    return st.spawn_ranks(_loop_rank, 2, path, tmp)


@pytest.mark.parametrize("mesh", MESHES)
def test_train_loop_under_a_mesh_matches_reference(loops, reference, mesh):
    """``train_loop(mesh=)`` replaying the reference's ``train_loop``: every
    rank's losses the same, within 1e-5 of the reference's; global rank
    0's checkpoint the whole tree, within the bound of the reference's
    checkpoint (module docstring), which the initial tree and the tree
    one step short both miss."""
    ref = reference[0]
    per = [r[mesh] for r in loops]
    assert all(p["losses"] == per[0]["losses"] for p in per)
    for got, want in zip(per[0]["losses"], ref["losses"]):
        assert abs(got - want) <= LOSS_RTOL * abs(want)
    ckpt = per[0]["ckpt"]
    npz = [f for f in os.listdir(ckpt) if f.endswith(".npz")]
    assert len(npz) == 1
    got = dict(np.load(os.path.join(ckpt, npz[0])))
    assert sorted(got) == sorted(ref["ckpt"])
    for key, want in ref["ckpt"].items():
        assert got[key].shape == want.shape, key
    assert _checkpoint_misses(got, ref) == {}
    assert _checkpoint_misses(ref["initial"], ref)
    assert _checkpoint_misses(ref["one_short"], ref)


def test_train_loop_on_a_one_rank_mesh_is_the_unsharded_loop():
    """A world-1 gloo group in this process: ``train_loop`` on a 1×1 mesh
    gives the unsharded loop's losses and parameters, bit for bit; so
    does the selftest's "train_loop" run at world 1 (its one rank in this
    process, as ``chip_smoke.py`` runs world 1)."""
    cfg = configs.get_config("olmo-1b").scaled_down()
    kw = dict(steps=STEPS, batch=2, seq=S, lr=LR, log_every=STEPS)
    want_params, want = ttrain.train_loop(cfg, device="cpu", **kw)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{st.free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        params, losses = ttrain.train_loop(cfg, mesh=init_mesh(1, 1, device="cpu"), **kw)
    finally:
        dist.destroy_process_group()
    assert losses == want
    got, ref = st.flat_tree(params), st.flat_tree(want_params)
    assert all(torch.equal(got[k].detach(), ref[k].detach()) for k in ref)
    threads = torch.get_num_threads()
    res = st.run_train(1, [dict(arch="olmo-1b", reduced=True, kind="train_loop", mesh=[1, 1],
                                steps=STEPS, batch=2, seq=S, lr=LR)],
                       device="cpu")
    run = res["train"][0]
    assert res["ok"] and run["losses_bitwise"] and run["params_bitwise"]
    assert run["losses"] == want and torch.get_num_threads() == threads


def test_selftest_training_plan_against_unsharded_record(tmp_path):
    """``sharded_selftest.run_train`` at world 2 over gloo: "tp" at (1, 2),
    then ``remat="full"`` (the same bits), "fsdp" and "zero1" at (2, 1),
    each against an unsharded ``train_record`` made here; then a
    ``train_loop`` run. Every run passes its checks, the ranks agree,
    and the counts name the kinds."""
    cfg = st.lm_config("gemma3-12b", reduced=True)
    batches = st.train_batches(cfg, 2, S, 2)
    rec = st.train_record(cfg, tr.init_model(cfg, 0, device="cpu"), batches,
                          torch.device("cpu"), lr=LR)
    path = str(tmp_path / "unsharded.pt")
    torch.save(rec, path)
    run = dict(arch="gemma3-12b", reduced=True, steps=2, batch=2, seq=S, lr=LR, record=path)
    plan = [dict(run, mesh=[1, 2], layout="tp", keep=True),
            dict(run, mesh=[1, 2], layout="tp", remat="full", same_bits_as=0),
            dict(run, mesh=[2, 1], layout="fsdp"), dict(run, mesh=[2, 1], layout="zero1"),
            dict(arch="musicgen-medium", reduced=True, kind="train_loop", steps=2, batch=2,
                 seq=S, mesh=[2, 1])]
    res = st.run_train(2, plan, device="cpu")
    assert res["ok"], [(r.get("layout"), r["ok"], r.get("hold")) for r in res["train"]]
    tp, remat, fsdp, zero1, loop = res["train"]
    assert all(p["same_bits"] for p in remat["ranks"])
    assert set(tp["counts"][0]) == {"forward", "backward", "clip_norm"}
    assert "recompute" in remat["counts"][0]
    assert {"fsdp_gather", "fsdp_scatter"} <= set(fsdp["counts"][0])
    assert {"grad_reduce", "zero1_gather"} <= set(zero1["counts"][0])
    assert loop["kind"] == "train_loop" and len(loop["losses"]) == 2
