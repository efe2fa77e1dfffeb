"""Port ↔ reference parity: the language-model serving path
(``repro_torch.models.transformer``, ``launch/steps.py``,
``launch/serve.py``, the config registry).

The model is mamba2-2.7b's ``scaled_down()`` with two layers (d_model
256, 16 SSD heads of 32, d_state 32, vocab 512). The reference's
``init_model`` draws the weights; ``params_from_jax`` gives the port the
same values. Prompts are numpy draws.

Bounds: logits and decode states rtol = atol = 2e-4, the reference's own
bound of decode against forward (``tests/test_kernels_ssd.py:76``): fp32
throughout, sums in another order. Greedy tokens are equal exactly.
Configurations are equal field for field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.launch import serve, steps
from repro_torch.models import MambaConfig, ModelConfig, MoEConfig
from repro_torch.models import transformer as tr

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)

#: the reference's forward and decode step, compiled once per shape
jforward = jax.jit(jtr.forward, static_argnames=("cfg", "use_pallas_ssd", "last_logits_only"))
jdecode = jax.jit(jtr.decode_step, static_argnames="cfg")


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_config("mamba2-2.7b").scaled_down().replace(num_layers=2)
    cfg = configs.get_config("mamba2-2.7b").scaled_down().replace(num_layers=2)
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(0))
    params = tr.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port_config(jcfg):
    """The same configuration built by the port's dataclasses."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if kw["moe"] is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(kw["moe"]))
    if kw["mamba"] is not None:
        kw["mamba"] = MambaConfig(**dataclasses.asdict(kw["mamba"]))
    return ModelConfig(**kw)


@pytest.mark.parametrize("last_only", [False, True], ids=["all", "last"])
def test_forward_matches_reference(setup, last_only):
    jcfg, cfg, jparams, params = setup
    toks = _prompts(cfg, 2, 40)
    want, _ = jforward(jparams, jnp.asarray(toks), jcfg, last_logits_only=last_only)
    got, aux = tr.forward(params, torch.from_numpy(toks), cfg, last_logits_only=last_only)
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_kernel_path_matches_reference_pallas(setup):
    """``use_kernel_ssd`` against the reference's ``use_pallas_ssd`` (its
    Pallas kernel in interpret mode on the CPU), at one small S."""
    jcfg, cfg, jparams, params = setup
    toks = _prompts(cfg, 2, 16, seed=1)
    want, _ = jforward(jparams, jnp.asarray(toks), jcfg, use_pallas_ssd=True)
    got, _ = tr.forward(params, torch.from_numpy(toks), cfg, use_kernel_ssd=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_step_matches_reference(setup):
    jcfg, cfg, jparams, params = setup
    toks = _prompts(cfg, 3, 5, seed=2)
    jstate = jtr.init_decode_state(jcfg, 3, 8)
    state = tr.init_decode_state(cfg, 3, 8, device="cpu")
    for i in range(toks.shape[1]):
        want, jstate = jdecode(jparams, jnp.asarray(toks[:, i:i + 1]), jstate, jcfg)
        got, state = tr.decode_step(params, torch.from_numpy(toks[:, i:i + 1]), state, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(getattr(state["p0"], name).numpy(),
                                   np.asarray(getattr(jstate["p0"], name)), **TOL)


def test_decode_matches_forward_in_port(setup):
    _, cfg, _, params = setup
    toks = torch.from_numpy(_prompts(cfg, 2, 12, seed=3))
    full, _ = tr.forward(params, toks, cfg, use_kernel_ssd=True)
    state = tr.init_decode_state(cfg, 2, 12, device="cpu")
    outs = []
    for i in range(12):
        lg, state = tr.decode_step(params, toks[:, i:i + 1], state, cfg)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), **TOL)


def test_prefill_step_tokens_equal_reference(setup):
    jcfg, cfg, jparams, params = setup
    toks = _prompts(cfg, 4, 33, seed=4)
    want = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(toks)})
    for use_kernel in (False, True):
        got = steps.make_prefill_step(cfg, use_kernel_ssd=use_kernel, device="cpu")(
            params, {"tokens": torch.from_numpy(toks)})
        assert got.dtype == torch.int32 and got.shape == (4, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_prefill_takes_the_kernel_route_with_the_plain_bits(setup, monkeypatch):
    """Without ``use_kernel_ssd`` the prefill goes through the K7 wrapper
    (one call a layer), which on CPU tensors runs ``ssd_chunked`` at the
    plain path's chunk: logits and tokens bitwise those of the explicit
    plain path (``use_kernel_ssd=False``)."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    _, cfg, _, params = setup
    toks = torch.from_numpy(_prompts(cfg, 3, 45, seed=8))
    calls = []
    wrapper = ssd_ops.ssd_scan
    monkeypatch.setattr(ssd_ops, "ssd_scan", lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    default, _ = tr.forward(params, toks, cfg)
    assert len(calls) == cfg.num_layers
    plain, _ = tr.forward(params, toks, cfg, use_kernel_ssd=False)
    assert len(calls) == cfg.num_layers
    assert torch.equal(default, plain)
    got = steps.make_prefill_step(cfg, device="cpu")(params, {"tokens": toks})
    assert len(calls) == 2 * cfg.num_layers
    want = steps.make_prefill_step(cfg, use_kernel_ssd=False, device="cpu")(
        params, {"tokens": toks})
    assert torch.equal(got, want)


def test_serve_step_tokens_equal_reference(setup):
    jcfg, cfg, jparams, params = setup
    toks = _prompts(cfg, 2, 1, seed=5)
    want, _ = jsteps.make_serve_step(jcfg)(jparams, {"tokens": jnp.asarray(toks)},
                                          jtr.init_decode_state(jcfg, 2, 4))
    got, _ = steps.make_serve_step(cfg, device="cpu")(
        params, {"tokens": torch.from_numpy(toks)}, tr.init_decode_state(cfg, 2, 4, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_tokens_equal_reference(setup):
    """Prefill by replay, then greedy decode: the same tokens, and the
    first equals the fused prefill's next token."""
    jcfg, cfg, jparams, params = setup
    prompts = _prompts(cfg, 4, 10, seed=6)
    want = jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts), gen_len=8)
    got = serve.serve_batch(cfg, params, torch.from_numpy(prompts), gen_len=8, device="cpu")
    assert got.shape == (4, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    first = steps.make_prefill_step(cfg, use_kernel_ssd=True, device="cpu")(
        params, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_array_equal(first.numpy(), got[:, :1].numpy())


def test_mlp_layers_match_reference():
    """An "M" mixer with a dense gated MLP ("D"), two repeats."""
    common = dict(name="md", arch_type="hybrid", num_layers=2, d_model=64, num_heads=1,
                  num_kv_heads=1, d_ff=96, vocab_size=64, mixer_pattern=("M",),
                  mlp_pattern=("D",))
    jcfg = jconfigs.mamba2_2_7b.CONFIG.replace(
        **common, mamba=dataclasses.replace(jconfigs.mamba2_2_7b.CONFIG.mamba, d_state=16,
                                            head_dim=16))
    cfg = _port_config(jcfg)
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(7))
    params = tr.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert "mlp" in params["blocks"]["p0"] and "w_gate" in params["blocks"]["p0"]["mlp"]
    toks = _prompts(cfg, 2, 9, seed=7)
    want, _ = jforward(jparams, jnp.asarray(toks), jcfg)
    got, _ = tr.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jstate, state = jtr.init_decode_state(jcfg, 2, 4), tr.init_decode_state(cfg, 2, 4, device="cpu")
    want, _ = jdecode(jparams, jnp.asarray(toks[:, :1]), jstate, jcfg)
    got, _ = tr.decode_step(params, torch.from_numpy(toks[:, :1]), state, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_model_tree_matches_reference_layout(setup):
    jcfg, cfg, jparams, _ = setup
    ours = tr.init_model(cfg, 0, device="cpu")
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    tshapes = tr._map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]), ours)
    assert tshapes == jshapes
    assert tr.param_count(ours) == sum(a.size for a in jax.tree.leaves(jparams))


def test_params_from_jax_rejects_a_wrong_tree(setup):
    jcfg, cfg, jparams, _ = setup
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="keys"):
        tr.params_from_jax({k: v for k, v in tree.items() if k != "lm_head"}, cfg)
    with pytest.raises(ValueError, match="shape"):
        tr.params_from_jax(tree, cfg.replace(vocab_size=cfg.vocab_size + 1))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_fields_equal_reference(arch):
    """Every reference architecture, built by the port's dataclasses, has
    the same fields, num_repeats and scaled_down() as the reference's."""
    jcfg = jconfigs.get_config(arch)
    cfg = _port_config(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.scaled_down()) == dataclasses.asdict(jcfg.scaled_down())
    assert (cfg.num_repeats, cfg.uses_attention, cfg.is_subquadratic) == (
        jcfg.num_repeats, jcfg.uses_attention, jcfg.is_subquadratic)
    assert dataclasses.asdict(configs.get_config(arch)) == dataclasses.asdict(jcfg)


def test_registry_names_what_is_not_ported():
    """Every reference architecture is registered; nothing is refused."""
    assert set(configs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    assert configs.ARCH_IDS == ("deepseek-moe-16b", "gemma3-12b", "granite-moe-3b-a800m",
                                "jamba-v0.1-52b", "llama-3.2-vision-90b", "mamba2-2.7b",
                                "musicgen-medium", "olmo-1b", "qwen1.5-0.5b", "qwen3-14b")
    assert configs.NOT_PORTED == ()
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config("no-such-model")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_registered_arch_runs_scaled_down(arch):
    """Every registered architecture, scaled down, builds on the CPU,
    prefills and decodes a step: finite logits of the vocabulary's width
    (a head a codebook with codebooks; image embeddings for the
    cross-attention layers), the decode step's within the LM bound of the
    forward's.

    A mixture-of-experts forward routes all 12 tokens as one group, a
    decode step the 2 of its step, and their capacities drop different
    choices by design (in the reference too), so those configs run at
    the capacity factor X/k, where the capacity is the group and no
    choice is dropped (held below), and the cache path must then agree."""
    cfg = configs.get_config(arch).scaled_down()
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = tr.init_model(cfg, 0, device="cpu")
    K = cfg.num_codebooks
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6) + ((K,) if K > 1 else ()))
                            .astype(np.int32))
    cross = None
    if cfg.vision_dim:
        cross = torch.from_numpy(rng.standard_normal((2, cfg.num_patches, cfg.vision_dim))
                                 .astype(np.float32))
    routing = []
    full, _ = tr.forward(params, toks, cfg, cross_embeds=cross, moe_routing=routing)
    want = (2, 6) + ((K,) if K > 1 else ()) + (cfg.vocab_size,)
    assert full.shape == want and bool(torch.isfinite(full).all())
    assert all(bool(r["keep"].all()) for r in routing)
    state = tr.init_decode_state(cfg, 2, 8, device="cpu")
    for i in range(6):
        step, state = tr.decode_step(params, toks[:, i:i + 1], state, cfg, cross_embeds=cross)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), **TOL)


def test_config_checks_raise():
    with pytest.raises(ValueError, match="MambaConfig"):
        ModelConfig(name="x", arch_type="ssm", num_layers=1, d_model=32, num_heads=1,
                    num_kv_heads=1, d_ff=0, vocab_size=16, mixer_pattern=("M",),
                    mlp_pattern=("N",))
    with pytest.raises(ValueError, match="divisible"):
        configs.get_config("mamba2-2.7b").replace(num_layers=3, mixer_pattern=("M", "M"),
                                                  mlp_pattern=("N", "N"))


def test_launcher_on_the_cpu(capsys):
    rec = serve.main(["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "5", "--gen-len", "3"])
    assert rec["arch"] == "mamba2-2.7b" and len(rec["tokens"]) == 2
    assert all(len(t) == 3 and all(0 <= v < 512 for v in t) for t in rec["tokens"])
    assert "generated (2, 3)" in capsys.readouterr().out
