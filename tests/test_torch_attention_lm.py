"""Port ↔ reference parity: the attention language models (rotary
positions, the ring-buffer KV cache, the "A" and "L" mixers, the four
dense attention architectures through forward, decode, the prefill step
and ``serve_batch``), and the port's copy of ``configs/shapes.py``.

Each architecture runs at its ``scaled_down()`` widths (one pattern
repeat, d_model ≤ 256, vocab ≤ 512, window 16). The reference's
``init_model`` draws the weights, and ``params_from_jax`` gives the port
the same values; inputs are numpy draws from a seed.

Bounds: activations and logits rtol = atol = 2e-4, the LM bound of
``tests/test_torch_lm.py`` (fp32 throughout, sums in another order);
greedy tokens and the cache's slots, positions and masks exactly equal.
``rope`` holds its angles' frequencies bit for bit (the port rounds the
power from float64, as XLA's correctly rounded fp32 power does), but
torch's cos and sin differ from XLA's CPU ones by an ulp, so its output
is held within 4 fp32 ulps of the largest |x| (a CPU reading: ~1 ulp).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import attention as jatt
from repro.models import kvcache as jkv
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve, steps
from repro_torch.models import attention as att
from repro_torch.models import kvcache as kv
from repro_torch.models import layers
from repro_torch.models import transformer as tr

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("gemma3-12b", "olmo-1b", "qwen1.5-0.5b", "qwen3-14b")

jforward = jax.jit(jtr.forward, static_argnames=("cfg", "use_flash", "last_logits_only"))
jdecode = jax.jit(jtr.decode_step, static_argnames="cfg")


def _prompts(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jconfigs.get_config(request.param).scaled_down()
    cfg = configs.get_config(request.param).scaled_down()
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(0))
    params = tr.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


#: one attention layer with every option: GQA 4:2, qkv biases, q/k norms,
#: window 16 on "L" (the reference's init gives zero biases: draw them)
MIXER = dict(name="mix", arch_type="dense", num_layers=1, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64, qkv_bias=True,
             qk_norm=True, sliding_window=16)


def _mixer(kind, softcap=0.0):
    jcfg = jconfigs.gemma3_12b.CONFIG.replace(**MIXER, mixer_pattern=(kind,),
                                              mlp_pattern=("D",), attn_logit_softcap=softcap)
    cfg = configs.get_config("gemma3-12b").replace(**MIXER, mixer_pattern=(kind,),
                                                    mlp_pattern=("D",),
                                                    attn_logit_softcap=softcap)
    rng = np.random.default_rng(11)
    jp = jax.tree.map(np.asarray, jatt.init_attention(jax.random.PRNGKey(1), jcfg, kind))
    jp = {k: (v if k in ("wq", "wk", "wv", "wo") or isinstance(v, dict)
              else rng.standard_normal(v.shape).astype(np.float32) * 0.1)
          for k, v in jp.items()}
    jp["q_norm"] = {"scale": 1 + 0.1 * rng.standard_normal(16).astype(np.float32)}
    p = {k: ({"scale": layers.to_tensor(v["scale"])} if isinstance(v, dict)
             else layers.to_tensor(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _rope_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 4, 64)).astype(np.float32)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1)) + 1000
    return x, pos


@functools.cache
def _reference_rope(theta: float) -> np.ndarray:
    """The reference's rope on ``_rope_inputs``, computed once a process by
    an executable this process compiles: its bits depend on the target
    XLA compiles for, and the persistent compilation cache
    (``tests/conftest.py``) would hand over an executable compiled
    elsewhere, so it is bypassed here (ROADMAP §C)."""
    x, pos = _rope_inputs()
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        fn = jax.jit(lambda a, b: jlayers.rope(a, b, theta))
        return np.asarray(fn(jnp.asarray(x), jnp.asarray(pos)))
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    x, pos = _rope_inputs()
    want = _reference_rope(theta)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert got.dtype == torch.float32 and got.shape == x.shape
    ulp = np.spacing(np.float32(np.abs(x).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * ulp)
    # bf16 input: fp32 angles, the result cast back to x's dtype
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.rope(xb, torch.from_numpy(pos), theta).dtype == torch.bfloat16


def test_cache_write_matches_reference():
    """Twelve writes into a ring of five slots: k, v, pos and length
    exactly the reference's after every write (the slot wraps twice)."""
    rng = np.random.default_rng(1)
    jc = jkv.init_kv_cache(2, 5, 2, 8, jnp.float32)
    c = kv.init_kv_cache(2, 5, 2, 8)
    for _ in range(12):
        k, v = (rng.standard_normal((2, 1, 2, 8)).astype(np.float32) for _ in range(2))
        jc = jkv.cache_write(jc, jnp.asarray(k), jnp.asarray(v))
        same = kv.cache_write(c, torch.from_numpy(k), torch.from_numpy(v))
        assert same is c  # written in place
        for name in ("k", "v", "pos", "length"):
            np.testing.assert_array_equal(getattr(c, name).numpy(),
                                          np.asarray(getattr(jc, name)), err_msg=name)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("lanes", [False, True], ids=["shared", "start_pos"])
def test_valid_mask_matches_reference(window, lanes):
    jc = jkv.init_kv_cache(3, 6, 1, 4, jnp.float32)
    c = kv.init_kv_cache(3, 6, 1, 4)
    start = np.array([0, 4, 7], np.int32)
    for _ in range(9):
        z = np.zeros((3, 1, 1, 4), np.float32)
        jc = jkv.cache_write(jc, jnp.asarray(z), jnp.asarray(z))
        kv.cache_write(c, torch.from_numpy(z), torch.from_numpy(z))
        want = jkv.valid_mask(jc, window, jnp.asarray(start) if lanes else None)
        got = kv.valid_mask(c, window, torch.from_numpy(start) if lanes else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("kind", ["A", "L"])
def test_attention_forward_matches_reference(kind, use_flash):
    """With ``use_flash`` on both sides: the reference's Pallas kernel in
    interpret mode, the port's flash wrapper (its plain version on the
    CPU). S = 40 spans more than two windows of 16."""
    jcfg, cfg, jp, p = _mixer(kind)
    x = np.random.default_rng(2).standard_normal((2, 40, 64)).astype(np.float32)
    pos = np.arange(40)[None, :]
    want = jatt.attention_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg, kind,
                                  jnp.asarray(pos), use_flash=use_flash)
    got = att.attention_forward(p, torch.from_numpy(x), cfg, kind, torch.from_numpy(pos),
                                use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_softcap_takes_the_plain_path(monkeypatch):
    """A soft-capped config never reaches the flash wrapper, as in the
    reference; its result matches the reference's."""
    jcfg, cfg, jp, p = _mixer("A", softcap=5.0)
    x = np.random.default_rng(3).standard_normal((1, 24, 64)).astype(np.float32)
    pos = np.arange(24)[None, :]
    monkeypatch.setattr(flash_ops, "attention", lambda *a, **k: pytest.fail("flash called"))
    got = att.attention_forward(p, torch.from_numpy(x), cfg, "A", torch.from_numpy(pos),
                                use_flash=True)
    want = jatt.attention_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg, "A",
                                  jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["A", "L"])
def test_attention_decode_matches_reference(kind):
    """30 tokens through a cache of 24 (an "L" layer's ring is its window,
    16, so it wraps), with per-lane starts: the output and the cache."""
    jcfg, cfg, jp, p = _mixer(kind)
    jp = jax.tree.map(jnp.asarray, jp)
    eff = 24 if kind == "A" else 16
    jc = jkv.init_kv_cache(3, eff, 2, 16, jnp.float32)
    c = kv.init_kv_cache(3, eff, 2, 16)
    start = np.array([0, 5, 11], np.int32)
    step = jax.jit(lambda p_, x_, c_: jatt.attention_decode(p_, x_, jcfg, kind, c_,
                                                            start_pos=jnp.asarray(start)))
    xs = np.random.default_rng(4).standard_normal((30, 3, 1, 64)).astype(np.float32)
    for x in xs:
        want, jc = step(jp, jnp.asarray(x), jc)
        got, c = att.attention_decode(p, torch.from_numpy(x), cfg, kind, c,
                                      start_pos=torch.from_numpy(start))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jc.pos))


def test_forward_matches_reference(arch):
    """Whole forwards, plain and with flash on both sides; S = 40 passes
    the scaled window of 16."""
    jcfg, cfg, jparams, params = arch
    toks = _prompts(cfg.vocab_size, 2, 40)
    for use_flash in (False, True):
        want, _ = jforward(jparams, jnp.asarray(toks), jcfg, use_flash=use_flash)
        got, aux = tr.forward(params, torch.from_numpy(toks), cfg, use_flash=use_flash)
        assert got.shape == want.shape and float(aux) == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_step_matches_reference(arch):
    """24 decode steps from empty caches of 32 ("L": its window of 16,
    wrapping), logits and the first layer's cache."""
    jcfg, cfg, jparams, params = arch
    toks = _prompts(cfg.vocab_size, 3, 24, seed=2)
    jstate = jtr.init_decode_state(jcfg, 3, 32)
    state = tr.init_decode_state(cfg, 3, 32, device="cpu")
    for i in range(toks.shape[1]):
        want, jstate = jdecode(jparams, jnp.asarray(toks[:, i:i + 1]), jstate, jcfg)
        got, state = tr.decode_step(params, torch.from_numpy(toks[:, i:i + 1]), state, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(state["p0"], name).numpy(),
                                   np.asarray(getattr(jstate["p0"], name)), **TOL)
    for name in ("pos", "length"):
        np.testing.assert_array_equal(getattr(state["p0"], name).numpy(),
                                      np.asarray(getattr(jstate["p0"], name)))


def test_decode_matches_forward_in_port(arch):
    _, cfg, _, params = arch
    toks = torch.from_numpy(_prompts(cfg.vocab_size, 2, 20, seed=3))
    full, _ = tr.forward(params, toks, cfg)
    state = tr.init_decode_state(cfg, 2, 20, device="cpu")
    outs = []
    for i in range(20):
        lg, state = tr.decode_step(params, toks[:, i:i + 1], state, cfg)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), **TOL)


def test_prefill_and_serve_tokens_equal_reference(arch):
    """``make_prefill_step`` (flash on both sides, and plain) and
    ``serve_batch`` give the reference's greedy tokens; the prefill's
    token is serve's first. Prompt 12 + 12 generated passes the window."""
    jcfg, cfg, jparams, params = arch
    prompts = _prompts(cfg.vocab_size, 4, 12, seed=4)
    for use_flash in (True, False):
        want = jax.jit(jsteps.make_prefill_step(jcfg, use_flash=use_flash))(
            jparams, {"tokens": jnp.asarray(prompts)})
        got = steps.make_prefill_step(cfg, use_flash=use_flash, device="cpu")(
            params, {"tokens": torch.from_numpy(prompts)})
        assert got.dtype == torch.int32 and got.shape == (4, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts), gen_len=12)
    got = serve.serve_batch(cfg, params, torch.from_numpy(prompts), gen_len=12, device="cpu")
    assert got.shape == (4, 12) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :1].numpy(), np.asarray(
        steps.make_prefill_step(cfg, device="cpu")(params, {"tokens": torch.from_numpy(prompts)})))


def test_ring_buffer_past_the_window():
    """gemma3's scaled-down "L" layers hold a ring of 16 slots; a prompt of
    10 plus 20 generated tokens wraps it. The tokens equal the
    reference's, also with a cache shorter than the prompt plus
    generation for the global layer (cache_len 40 ≥ 30, so no wrap
    there)."""
    jcfg = jconfigs.get_config("gemma3-12b").scaled_down()
    cfg = configs.get_config("gemma3-12b").scaled_down()
    assert cfg.sliding_window == 16 and cfg.mixer_pattern.count("L") == 5
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(5))
    params = tr.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    prompts = _prompts(cfg.vocab_size, 2, 10, seed=5)
    want = jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts), gen_len=20, cache_len=40)
    got = serve.serve_batch(cfg, params, torch.from_numpy(prompts), gen_len=20, cache_len=40,
                            device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    state = tr.init_decode_state(cfg, 2, 40, device="cpu")
    assert state["p0"].k.shape[2] == 16 and state["p5"].k.shape[2] == 40


def test_default_prefill_takes_the_flash_route(arch, monkeypatch):
    """Without ``use_flash`` the prefill calls the flash wrapper once an
    attention layer, causal, windowed on "L" layers; the tokens are the
    plain path's."""
    _, cfg, _, params = arch
    toks = torch.from_numpy(_prompts(cfg.vocab_size, 2, 30, seed=6))
    calls = []
    wrapper = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention",
                        lambda *a, **k: calls.append((k["causal"], k["window"])) or wrapper(*a, **k))
    got = steps.make_prefill_step(cfg, device="cpu")(params, {"tokens": toks})
    want = [(True, cfg.sliding_window if m == "L" else None) for m in cfg.mixer_pattern]
    assert calls == want * cfg.num_repeats
    plain = steps.make_prefill_step(cfg, use_flash=False, device="cpu")(params, {"tokens": toks})
    assert len(calls) == cfg.num_layers and torch.equal(got, plain)


def test_init_model_tree_matches_reference_layout(arch):
    jcfg, cfg, jparams, _ = arch
    ours = tr.init_model(cfg, 0, device="cpu")
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    tshapes = tr._map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]), ours)
    assert tshapes == jshapes
    mixer = ours["blocks"]["p0"]["mixer"]
    assert ("bq" in mixer) == cfg.qkv_bias and ("q_norm" in mixer) == cfg.qk_norm


def test_mesh_levers_and_cross_attention_raise():
    """A mesh lever without a mesh raises ValueError (the reference's
    sharding constraint has no axis to name without an ambient mesh), in
    forward, decode and the attention mixer; init_model does not look at
    the levers."""
    cfg = configs.get_config("olmo-1b").scaled_down()
    toks = torch.zeros(1, 4, dtype=torch.long)
    for lever in ("attn_q_seq_shard", "residual_seq_shard", "decode_flash_shard"):
        lcfg = cfg.replace(**{lever: "model"})
        params = tr.init_model(lcfg, device="cpu")
        with pytest.raises(ValueError, match="no mesh"):
            tr.forward(params, toks, lcfg)
        with pytest.raises(ValueError, match="no mesh"):
            tr.init_decode_state(lcfg, 1, 8, device="cpu")
    p = att.init_attention(cfg, "A", torch.Generator().manual_seed(0))
    x = torch.zeros(1, 4, cfg.d_model)
    # a cross-attention layer without its image embeddings raises
    with pytest.raises(ValueError, match="cross_kv"):
        att.attention_forward(p, x, cfg, "X", torch.arange(4)[None])
    with pytest.raises(ValueError, match="no mesh"):
        att.attention_forward(p, x, cfg.replace(attn_q_seq_shard="model"), "A",
                              torch.arange(4)[None])


def test_shapes_equal_reference():
    """The port's copy of configs/shapes.py: the same shapes, window and
    per-(arch × shape) policy for every reference architecture."""
    from repro.configs import shapes as jshapes

    assert shapes.LONG_CONTEXT_SWA_WINDOW == jshapes.LONG_CONTEXT_SWA_WINDOW
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for arch in jconfigs.ARCH_IDS:
        jcfg = jconfigs.get_config(arch)
        for name in shapes.SHAPES:
            s, js = shapes.get_shape(name), jshapes.get_shape(name)
            assert shapes.needs_swa_override(jcfg, s) == jshapes.needs_swa_override(jcfg, js)
            assert shapes.apply_shape_policy(jcfg, s) == jshapes.apply_shape_policy(jcfg, js)
    with pytest.raises(ValueError, match="unknown shape"):
        shapes.get_shape("no-such-shape")
    assert configs.get_shape("long_500k") is shapes.SHAPES["long_500k"]


def test_launcher_on_the_cpu(capsys):
    rec = serve.main(["--arch", "gemma3-12b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "5", "--gen-len", "3"])
    assert rec["arch"] == "gemma3-12b" and len(rec["tokens"]) == 2
    assert all(len(t) == 3 and all(0 <= v < 512 for v in t) for t in rec["tokens"])
    assert "generated (2, 3)" in capsys.readouterr().out


def test_serve_lm_example_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm

    rec = serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                         "--gen-len", "3"])
    assert len(rec["tokens"]) == 2 and all(len(t) == 3 for t in rec["tokens"])
    assert rec["mean_nfe"] > 0 and "[AR] gemma3-12b (reduced)" in capsys.readouterr().out
