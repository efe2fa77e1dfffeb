"""Port ↔ reference parity: the mixture-of-experts language models
(deepseek-moe-16b, granite-moe-3b-a800m and jamba-v0.1-52b's hybrid
M/A/D/E stack) through ``forward``, ``decode_step``, ``serve_batch`` and
``ContinuousBatcher``; and ``init_model``'s in-place build of the
stacked weights.

Each architecture runs at its ``scaled_down()`` widths (one pattern
repeat, d_model ≤ 256, ≤ 4 experts of ≤ 64, top-2, vocab ≤ 512). The
reference's ``init_model`` draws the weights and ``params_from_jax``
carries them across (the router in fp32); inputs are numpy draws.

Bounds: logits rtol = atol = 2e-4, the LM bound of
``tests/test_torch_lm.py`` (fp32, sums in another order); the aux loss
within 1e-6; greedy tokens, the batcher's finishing order and its step
counts exactly equal. The in-place ``init_model`` gives every config
ported before the MoE slice the same bits as stacking separately drawn
layers (``_stacked_build``, the former build).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as jtr
from repro.serving import scheduler as jsched
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import transformer as tr
from repro_torch.serving.scheduler import ContinuousBatcher, Request

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
AUX_TOL = 1e-6
ARCHS = ("deepseek-moe-16b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
#: the architectures the port ran before its mixture-of-experts slice
EARLIER = ("gemma3-12b", "mamba2-2.7b", "olmo-1b", "qwen1.5-0.5b", "qwen3-14b")
#: the cross-attention and codebook architectures, ported after it, and a
#: tied codebook variant: the in-place build holds their seeded weights too
LATER = ("llama-3.2-vision-90b", "musicgen-medium", "musicgen-medium+tied")

jforward = jax.jit(jtr.forward, static_argnames=("cfg", "last_logits_only"))
jdecode = jax.jit(jtr.decode_step, static_argnames="cfg")


def _prompts(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _build(name, **kw):
    jcfg = jconfigs.get_config(name).scaled_down().replace(**kw)
    cfg = configs.get_config(name).scaled_down().replace(**kw)
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(5))
    params = tr.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _build(request.param)


def test_forward_matches_reference(arch):
    """Whole forwards (the port's defaults, the plain versions of K3 and
    K7 on the CPU, against the reference's plain path): logits, the aux
    loss summed over the "E" layers, one routing record a layer."""
    jcfg, cfg, jparams, params = arch
    toks = _prompts(cfg.vocab_size, 2, 40)
    want, want_aux = jforward(jparams, jnp.asarray(toks), jcfg)
    rec = []
    got, aux = tr.forward(params, torch.from_numpy(toks), cfg, moe_routing=rec)
    assert got.shape == want.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(want_aux) > 0 and abs(float(aux) - float(want_aux)) <= AUX_TOL
    assert len(rec) == cfg.mlp_pattern.count("E") * cfg.num_repeats
    assert all(r["tokens"] == 80 and r["expert_idx"].shape == (1, 80, cfg.moe.top_k)
               for r in rec)


def test_forward_last_logits_and_gather_dispatch(arch):
    """``last_logits_only`` and ``moe_dispatch="gather"`` on both sides."""
    jcfg, cfg, jparams, params = arch
    toks = _prompts(cfg.vocab_size, 2, 24, seed=1)
    jg, g = jcfg.replace(moe_dispatch="gather"), cfg.replace(moe_dispatch="gather")
    want, want_aux = jforward(jparams, jnp.asarray(toks), jg, last_logits_only=True)
    got, aux = tr.forward(params, torch.from_numpy(toks), g, last_logits_only=True)
    assert got.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


def test_decode_steps_match_reference(arch):
    """Six decode steps of a batch of 3 from empty states: every "E"
    layer routes the step's 3 tokens as one group."""
    jcfg, cfg, jparams, params = arch
    toks = _prompts(cfg.vocab_size, 3, 6, seed=2)
    jstate = jtr.init_decode_state(jcfg, 3, 8)
    state = tr.init_decode_state(cfg, 3, 8, device="cpu")
    for i in range(toks.shape[1]):
        want, jstate = jdecode(jparams, jnp.asarray(toks[:, i:i + 1]), jstate, jcfg)
        rec = []
        got, state = tr.decode_step(params, torch.from_numpy(toks[:, i:i + 1]), state, cfg,
                                    moe_routing=rec)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert [r["tokens"] for r in rec] == [3] * cfg.mlp_pattern.count("E")


def test_serve_batch_tokens_equal_reference(arch):
    """``serve_batch`` (prefill by replay, then greedy) gives the
    reference's tokens."""
    jcfg, cfg, jparams, params = arch
    prompts = _prompts(cfg.vocab_size, 4, 8, seed=3)
    want = jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts), gen_len=8)
    got = serve.serve_batch(cfg, params, torch.from_numpy(prompts), gen_len=8, device="cpu")
    assert got.shape == (4, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ARCHS[:2])
def test_batcher_matches_reference(name):
    """``ContinuousBatcher`` against the reference's on the same requests:
    each request's tokens, the finishing order, the steps and the wasted
    share. A request's tokens depend on its seatmates through capacity
    (and free slots' token 0) in both packages alike."""
    jcfg, cfg, jparams, params = _build(name)
    rng = np.random.RandomState(6)
    reqs = [(uid, rng.randint(0, cfg.vocab_size, size=n).astype(np.int32), m)
            for uid, (n, m) in enumerate(zip((5, 3, 7, 2, 4, 6), (6, 8, 3, 7, 5, 4)))]
    jb = jsched.ContinuousBatcher(jcfg, jparams, slots=3, cache_len=64)
    b = ContinuousBatcher(cfg, params, slots=3, cache_len=64, device="cpu")
    for uid, p, m in reqs:
        jb.submit(jsched.Request(uid=uid, prompt=p, max_new_tokens=m))
        b.submit(Request(uid=uid, prompt=p, max_new_tokens=m))
    jdone, done = jb.run_to_completion(), b.run_to_completion()
    assert list(done) == list(jdone)
    assert {u: r.output for u, r in done.items()} == {u: r.output for u, r in jdone.items()}
    assert (b.total_steps, b.useful_steps) == (jb.total_steps, jb.useful_steps)
    assert b.wasted_step_fraction == jb.wasted_step_fraction


def test_batcher_refuses_the_hybrid():
    """jamba's Mamba2 layers cannot be masked per slot: refused, as in the
    reference."""
    cfg = configs.get_config("jamba-v0.1-52b").scaled_down()
    with pytest.raises(ValueError, match="SSM"):
        ContinuousBatcher(cfg, None, device="cpu")


def test_full_width_configs():
    """The three configs at their published widths: the parameter count
    the leaves' shapes give, equal to the reference's (deepseek-moe-16b:
    16,879,568,896, the one that one 80 GB card holds whole in fp32)."""
    counts = {}
    for name in ARCHS:
        jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
        shapes = jax.eval_shape(lambda: jtr.init_model(jcfg, jax.random.PRNGKey(0)))
        counts[name] = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
        assert cfg.num_repeats == jcfg.num_repeats and cfg.moe == cfg.moe.__class__(
            **jcfg.moe.__dict__)
    assert counts["deepseek-moe-16b"] == 16_879_568_896
    assert counts["granite-moe-3b-a800m"] == 3_374_295_552
    assert counts["jamba-v0.1-52b"] == 51_459_770_368


def _stacked_build(cfg, seed=0):
    """The former ``init_model``: every layer drawn as its own tree, then
    ``torch.stack``ed (peak: the weights twice over for a position's
    leaves), scaling out of place."""
    def dense(shape, g, dtype, fan=None):
        w = torch.empty(tuple(shape), dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
        return (w * (fan if fan is not None else shape[0]) ** -0.5).to(dtype)

    g = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    lead = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    embed = dense((*lead, cfg.vocab_size, cfg.d_model), g, dtype, cfg.d_model)
    blocks = {}
    for i in range(len(cfg.mixer_pattern)):
        layers_i = [tr._init_block_position(cfg, i, g) for _ in range(cfg.num_repeats)]
        blocks[f"p{i}"] = tr._stack(layers_i)
    out = {"embed": embed, "blocks": blocks,
           "final_norm": layers.init_norm(cfg.d_model, cfg.norm_type, dtype)}
    if not cfg.tie_embeddings:
        out["lm_head"] = dense((*lead, cfg.d_model, cfg.vocab_size), g, dtype)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", EARLIER + LATER)
def test_init_in_place_keeps_seeded_weights(name, dtype):
    """Three pattern repeats (a real stack), in fp32 and in bf16: the
    same leaves, dtypes and bits as the former build (for the later
    architectures, as that build would have drawn them: the codebook
    embedding and heads, no head when tied)."""
    name, _, tied = name.partition("+")
    base = configs.get_config(name).scaled_down()
    cfg = base.replace(num_layers=3 * len(base.mixer_pattern), dtype=dtype,
                       tie_embeddings=bool(tied))
    got, want = [], []
    tr._map(got.append, tr.init_model(cfg, 7, device="cpu"))
    tr._map(want.append, _stacked_build(cfg, 7))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_init_stacks_moe_layers_in_place():
    """An "E" stack: each stacked leaf is one allocation whose layer views
    were drawn in place (layer r of the stack equals the r-th separately
    drawn layer), the router fp32 under a bf16 config."""
    base = configs.get_config("deepseek-moe-16b").scaled_down()
    cfg = base.replace(num_layers=3, dtype="bfloat16")
    params = tr.init_model(cfg, 1, device="cpu")
    mlp = params["blocks"]["p0"]["mlp"]
    assert mlp["router"].dtype == torch.float32 and mlp["w_in"].dtype == torch.bfloat16
    assert mlp["w_in"].shape == (3, cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_ffn)
    want = _stacked_build(cfg, 1)["blocks"]["p0"]["mlp"]
    for key in ("router", "w_in", "w_gate", "w_out"):
        assert torch.equal(mlp[key], want[key])
    assert torch.equal(mlp["shared"]["w_out"], want["shared"]["w_out"])
