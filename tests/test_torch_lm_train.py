"""Port ↔ reference parity: language-model training (``data/tokens.py``,
``launch/steps.py::make_train_step``, ``launch/train.py``).

The train step runs on each family scaled down: dense "A" (olmo-1b),
"L" (gemma3-12b, past its window of 16), "M" (mamba2-2.7b, the plain
SSD), "E" (deepseek-moe-16b, its aux loss in the loss), "X"
(llama-3.2-vision-90b, with image embeddings) and codebooks
(musicgen-medium). The reference's ``init_model`` draws the weights,
``params_from_jax`` carries them across; tokens and embeddings are numpy
draws (the port's ``synth_batch`` draws are its own, so the parity tests
hand both packages the same tokens).

Bounds: the loss within 1e-5 relative and the cross-entropy and aux
within 1e-6 (fp32, sums in another order); each gradient leaf within
2e-4·(1 + max|g|) of ``jax.value_and_grad`` of the reference's loss; the
AdamW update of each leaf (new − old) within 2e-4·(1 + max|update|) of
the reference's train step's where the clipped gradient is above
``WELL_CONDITIONED`` (1e3·ε): the first step moves an element by
lr·g/(|g| + ε), which turns a gradient's last-bit difference into an
update difference of up to lr where |g| is near ε (measured: 0.19·lr on
gemma3's scaled-down "L" stack), so there the bound is 2·lr, the most
two first steps can differ; ``lm_loss`` within 1e-6;
``apply_delay_pattern`` exactly. ``remat`` "full" and "dots" recompute
the same operations on the same inputs, so their loss and gradients
equal "none"'s exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import tokens as jtokens
from repro.models import transformer as jtr
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.data import tokens
from repro_torch.launch import steps, train
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamW

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PART_TOL = 1e-6
GRAD_TOL = 2e-4
LR = 1e-3
#: |clipped gradient| above which AdamW's first update is within 0.1 % of
#: lr·sign(g): 1e3 times its ε
WELL_CONDITIONED = 1e3 * 1e-8
#: family → arch; each scaled down, one pattern repeat
FAMILIES = {"A": "olmo-1b", "L": "gemma3-12b", "M": "mamba2-2.7b", "E": "deepseek-moe-16b",
            "X": "llama-3.2-vision-90b", "codebooks": "musicgen-medium"}


def _build(name, **kw):
    jcfg = jconfigs.get_config(name).scaled_down().replace(**kw)
    cfg = configs.get_config(name).scaled_down().replace(**kw)
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(11))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree


def _batch(cfg, B=2, S=24, seed=0):
    """numpy tokens (B, S[, K]) and, for "X" layers, image embeddings."""
    rng = np.random.default_rng(seed)
    K = cfg.num_codebooks
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S) + ((K,) if K > 1 else ()))
         .astype(np.int32)}
    if cfg.vision_dim:
        b["cross_embeds"] = rng.standard_normal((B, cfg.num_patches, cfg.vision_dim)) \
            .astype(np.float32)
    return b


def _pairs(ours, theirs, path=""):
    """(path, port tensor, reference array) over matching leaves."""
    if isinstance(ours, dict):
        assert set(ours) == set(theirs), path
        for k in ours:
            yield from _pairs(ours[k], theirs[k], f"{path}/{k}")
    else:
        yield path, ours, np.asarray(theirs)


def _jloss(jcfg):
    """The reference's ``loss_fn`` (``launch/steps.py:35``)."""
    def loss_fn(p, batch):
        logits, aux = jtr.forward(p, batch["tokens"], jcfg,
                                  cross_embeds=batch.get("cross_embeds"))
        ce = jtokens.lm_loss(logits, batch["tokens"])
        return ce + aux, (ce, aux)
    return loss_fn


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jcfg, cfg, jparams, tree = _build(FAMILIES[request.param])
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, (jce, jaux)), jgrads = jax.jit(jax.value_and_grad(_jloss(jcfg), has_aux=True))(
        jparams, jbatch)
    # the reference's train step (launch/steps.py:44) is this value_and_grad
    # followed by its AdamW's update
    jopt = JAdamW(lr=LR)
    jnew, _ = jax.jit(jopt.update)(jgrads, jopt.init(jparams), jparams)
    ref = {"loss": float(jl), "ce": float(jce), "aux": float(jaux),
           "grads": jax.tree.map(np.asarray, jgrads), "new": jax.tree.map(np.asarray, jnew),
           "metrics": {"loss": float(jl), "ce": float(jce), "moe_aux": float(jaux)}}
    return request.param, cfg, tree, batch, ref


def _port_grads(cfg, tree, batch, remat="none"):
    params = tr.params_from_jax(tree, cfg, device="cpu")
    flat = []
    tr._map(flat.append, params)
    for p in flat:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, ce, aux = steps.make_loss_fn(cfg, remat=remat)(params, tb)
    grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
    return loss, ce, aux, tr._map(lambda _: next(it), params)


def test_loss_and_gradients_match_reference(family):
    name, cfg, tree, batch, ref = family
    loss, ce, aux, grads = _port_grads(cfg, tree, batch)
    loss, ce, aux = (float(t.detach()) for t in (loss, ce, aux))
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert abs(ce - ref["ce"]) <= PART_TOL * max(1.0, ref["ce"])
    assert abs(aux - ref["aux"]) <= PART_TOL
    assert (ref["aux"] > 0) == (name == "E")
    for path, g, want in _pairs(grads, ref["grads"]):
        bound = GRAD_TOL * (1 + np.abs(want).max())
        err = np.abs(g.numpy() - want).max()
        assert err <= bound, f"{name} {path}: max|Δg| {err:.3e} > {bound:.3e}"


def test_train_step_matches_reference(family):
    """One ``make_train_step`` (AdamW at lr 1e-3, the reference's defaults
    otherwise) against the reference's step on the same batch: the
    metrics, and each leaf's update."""
    name, cfg, tree, batch, ref = family
    params = tr.params_from_jax(tree, cfg, device="cpu")
    opt = AdamW(lr=LR)
    step = steps.make_train_step(cfg, opt, device="cpu")
    new, state, metrics = step(params, opt.init(params),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert new is params and state.step == 1
    assert set(metrics) == {"loss", "ce", "moe_aux"}
    assert all(m.dtype == torch.float32 and m.ndim == 0 for m in metrics.values())
    jm = ref["metrics"]
    assert abs(float(metrics["loss"]) - jm["loss"]) <= LOSS_RTOL * abs(jm["loss"])
    assert abs(float(metrics["moe_aux"]) - jm["moe_aux"]) <= PART_TOL
    gnorm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for _, _, g in
                        _pairs(new, ref["grads"])))
    clip = min(1.0, opt.clip_norm / max(gnorm, 1e-9))
    for (path, p, want), (_, _, old), (_, _, g) in zip(
            _pairs(new, ref["new"]), _pairs(new, tree), _pairs(new, ref["grads"])):
        upd, want_upd = p.detach().numpy() - old, want - old
        err = np.abs(upd - want_upd)
        sharp = np.abs(g) * clip > WELL_CONDITIONED
        bound = GRAD_TOL * (1 + np.abs(want_upd).max())
        assert (err[sharp] <= bound).all(), (
            f"{name} {path}: max|Δupdate| {err[sharp].max():.3e} > {bound:.3e}")
        assert (err <= 2 * LR).all(), f"{name} {path}: max|Δupdate| {err.max():.3e}"


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "deepseek-moe-16b"])
def test_remat_gives_the_same_loss_and_gradients(name):
    """``remat`` "full" and "dots" (the checkpointed layers' recompute)
    against "none": the same loss and gradients, bit for bit."""
    _, cfg, _, tree = _build(name)
    batch = _batch(cfg, seed=4)
    loss, _, _, grads = _port_grads(cfg, tree, batch)
    want = []
    tr._map(want.append, grads)
    for remat in ("full", "dots"):
        l2, _, _, g2 = _port_grads(cfg, tree, batch, remat=remat)
        got = []
        tr._map(got.append, g2)
        assert torch.equal(l2, loss)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), remat
    with pytest.raises(ValueError, match="remat"):
        _port_grads(cfg, tree, batch, remat="some")


def test_remat_dots_saves_only_unbatched_products():
    """The "dots" policy keeps ``mm``/``addmm`` and batch-1 ``bmm`` (the
    einsum projections) and recomputes the per-head products."""
    aten = torch.ops.aten
    policy = tr._save_unbatched_products
    save, recompute = (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE,
                       torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    one, many = torch.zeros(1, 2, 3), torch.zeros(4, 2, 3)
    assert policy(None, aten.mm.default, one[0], one[0].T) == save
    assert policy(None, aten.bmm.default, one, one.transpose(1, 2)) == save
    assert policy(None, aten.bmm.default, many, many.transpose(1, 2)) == recompute
    assert policy(None, aten.add.Tensor, many, many) == recompute


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_registered_arch_trains_a_step(arch):
    """The mirror of ``tests/test_models_smoke.py``'s train rows: every
    registered architecture, scaled down, takes one step from seeded
    weights: a finite loss, every parameter moved."""
    cfg = configs.get_config(arch).scaled_down()
    params = tr.init_model(cfg, 0, device="cpu")
    before = []
    tr._map(lambda a: before.append(a.clone()), params)
    opt = AdamW(lr=1e-3)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, S=24, seed=6).items()}
    params, _, metrics = steps.make_train_step(cfg, opt, device="cpu")(
        params, opt.init(params), b)
    assert bool(torch.isfinite(metrics["loss"]))
    after = []
    tr._map(after.append, params)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


# --------------------------------------------------------------------------
# data/tokens.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 4), (3, 5, 4), (1, 7, 2), (2, 9, 1)])
def test_apply_delay_pattern_equals_reference(shape):
    toks = np.random.default_rng(1).integers(1, 100, shape).astype(np.int32)
    want = np.asarray(jtokens.apply_delay_pattern(jnp.asarray(toks)))
    got = tokens.apply_delay_pattern(torch.from_numpy(toks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 10, 32), (2, 10, 4, 32)], ids=["rank3", "rank4"])
def test_lm_loss_matches_reference(shape):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    toks = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(jtokens.lm_loss(jnp.asarray(logits), jnp.asarray(toks)))
    got = tokens.lm_loss(torch.from_numpy(logits), torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))
    uniform = tokens.lm_loss(torch.zeros(shape), torch.from_numpy(toks))
    assert abs(float(uniform) - np.log(shape[-1])) < 1e-5


def test_token_stream_deterministic_and_shaped():
    cfg = tokens.TokenPipelineConfig(vocab_size=100, seq_len=32, global_batch=4)
    b1, b2, b3 = (tokens.synth_batch(cfg, s) for s in (3, 3, 4))
    assert torch.equal(b1, b2) and not torch.equal(b1, b3)
    assert b1.shape == (4, 32) and b1.dtype == torch.int32
    assert int(b1.min()) >= 0 and int(b1.max()) < 100
    assert not torch.equal(b1, tokens.synth_batch(dataclasses.replace(cfg, seed=1), 3))
    assert (b1[:, ::64] == 0).all()
    it = tokens.batches(cfg, start_step=3)
    assert torch.equal(next(it), b1) and torch.equal(next(it), b3)


def test_token_stream_zipfian():
    cfg = tokens.TokenPipelineConfig(vocab_size=1000, seq_len=4096, global_batch=8)
    b = tokens.synth_batch(cfg, 0).numpy().ravel()
    assert np.mean(b < 50) > 5 * np.mean(b >= 500)
    # local repetition: a position copies its predecessor's draw with p 0.3,
    # which that position kept with p 0.7 (plus the Zipf marginal's own
    # repeats): about 0.21 + 0.06 of neighbours are equal
    rows = tokens.synth_batch(cfg, 1).numpy()
    same = np.mean(rows[:, 1:] == rows[:, :-1])
    assert 0.22 < same < 0.32


def test_codebook_stream_shape_and_delay():
    cfg = tokens.TokenPipelineConfig(vocab_size=64, seq_len=16, global_batch=2,
                                     num_codebooks=4)
    b = tokens.synth_batch(cfg, 0)
    assert b.shape == (2, 16, 4) and b.dtype == torch.int32
    for k in range(4):
        assert (b[:, :k, k] == 0).all()


# --------------------------------------------------------------------------
# launch/train.py
# --------------------------------------------------------------------------

def test_train_loop_on_the_cpu(tmp_path, capsys):
    """musicgen-medium scaled down, 8 steps: finite, falling cross-entropy,
    a time a step, a checkpoint; ``mesh=`` a mesh without process groups
    raises rather than training unsharded (``train_loop(mesh=)`` runs in
    ``tests/test_torch_mesh_train_loop.py``)."""
    cfg = configs.get_config("musicgen-medium").scaled_down()
    times = []
    params, losses = train.train_loop(cfg, steps=8, batch=2, seq=32, lr=3e-3,
                                      ckpt_dir=str(tmp_path), log_every=4, step_times=times,
                                      device="cpu")
    assert len(losses) == len(times) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert (tmp_path / "ckpt_00000008.npz").exists()
    assert "step    4" in capsys.readouterr().out
    from repro_torch.parallel.mesh import Mesh

    with pytest.raises(RuntimeError, match="no process groups"):
        train.train_loop(cfg, steps=1, batch=2, seq=8,
                         mesh=Mesh(("data", "model"), (1, 2), (0, 0)))


def test_train_launcher_on_the_cpu(capsys):
    losses = train.main(["--arch", "llama-3.2-vision-90b", "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "final ce" in capsys.readouterr().out
