"""Port ↔ reference parity: the last two language-model architectures,
cross-attention (llama-3.2-vision-90b's "X" layers over image embeddings)
and codebook heads (musicgen-medium's four summed embeddings and four
heads), and tied embeddings, through ``forward``, ``decode_step``,
``make_prefill_step`` and ``serve_batch``.

The cases are the ``scaled_down()`` llama-3.2-vision-90b (4 "A" + 1 "X",
d_model 256, vision_dim 64, 16 patches) and musicgen-medium (one "A"+"D"
layer, 4 codebooks of 512), a scaled-down olmo-1b with
``tie_embeddings=True`` and musicgen with it (the head is the codebook
embeddings). The reference's ``init_model`` draws the weights and
``params_from_jax`` carries them across; tokens and image embeddings are
numpy draws.

Bounds: logits rtol = atol = 2e-4, the LM bound of
``tests/test_torch_lm.py`` (fp32, sums in another order); greedy tokens
exactly equal; decode against the port's own forward within the
reference's teacher-forcing bound, 5e-4 (``tests/test_models_smoke.py``).
"""

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
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as tr
from repro_torch.serving.scheduler import ContinuousBatcher

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
TEACHER_FORCING_TOL = 5e-4
#: (arch, tie_embeddings)
CASES = {"vlm": ("llama-3.2-vision-90b", False), "codebooks": ("musicgen-medium", False),
         "tied": ("olmo-1b", True), "codebooks_tied": ("musicgen-medium", True)}

jforward = jax.jit(jtr.forward, static_argnames=("cfg", "last_logits_only"))
jdecode = jax.jit(jtr.decode_step, static_argnames="cfg")


def _build(name, tied):
    jcfg = jconfigs.get_config(name).scaled_down().replace(tie_embeddings=tied)
    cfg = configs.get_config(name).scaled_down().replace(tie_embeddings=tied)
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(3))
    params = tr.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _inputs(cfg, B, S, seed=0):
    """Tokens (B, S) or (B, S, K) and, for "X" layers, image embeddings
    (B, num_patches, vision_dim), as numpy."""
    rng = np.random.default_rng(seed)
    K = cfg.num_codebooks
    toks = rng.integers(0, cfg.vocab_size, (B, S) + ((K,) if K > 1 else ())).astype(np.int32)
    cross = None
    if cfg.vision_dim:
        cross = rng.standard_normal((B, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return toks, cross


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _build(*CASES[request.param])


@pytest.mark.parametrize("last_only", [False, True], ids=["all", "last"])
def test_forward_matches_reference(case, last_only):
    jcfg, cfg, jparams, params = case
    toks, cross = _inputs(cfg, 2, 24)
    want, _ = jforward(jparams, jnp.asarray(toks), jcfg, cross_embeds=_j(cross),
                       last_logits_only=last_only)
    got, aux = tr.forward(params, torch.from_numpy(toks), cfg, cross_embeds=_t(cross),
                          last_logits_only=last_only)
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_steps_match_reference(case):
    """Ten decode steps against the reference's, logits and greedy tokens
    (the mirror of ``tests/test_models_smoke.py:102-128``, musicgen
    included); an "X" layer's state stays ``{}``."""
    jcfg, cfg, jparams, params = case
    toks, cross = _inputs(cfg, 3, 10, seed=1)
    jstate = jtr.init_decode_state(jcfg, 3, 12)
    state = tr.init_decode_state(cfg, 3, 12, device="cpu")
    for i in range(10):
        want, jstate = jdecode(jparams, jnp.asarray(toks[:, i:i + 1]), jstate, jcfg,
                               cross_embeds=_j(cross))
        got, state = tr.decode_step(params, torch.from_numpy(toks[:, i:i + 1]), state, cfg,
                                    cross_embeds=_t(cross))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))
    for i, mix in enumerate(cfg.mixer_pattern):
        if mix == "X":
            assert state[f"p{i}"] == {} and jstate[f"p{i}"] == {}


def test_decode_matches_teacher_forcing(case):
    """Incremental decode reproduces the port's own teacher-forced logits
    (the reference's ``test_decode_matches_teacher_forcing`` bound)."""
    _, cfg, _, params = case
    toks, cross = _inputs(cfg, 2, 10, seed=2)
    full, _ = tr.forward(params, torch.from_numpy(toks), cfg, cross_embeds=_t(cross))
    state = tr.init_decode_state(cfg, 2, 12, device="cpu")
    outs = []
    for i in range(10):
        lg, state = tr.decode_step(params, torch.from_numpy(toks[:, i:i + 1]), state, cfg,
                                   cross_embeds=_t(cross))
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, dim=1) - full).abs().max()) < TEACHER_FORCING_TOL


def test_prefill_step_tokens_equal_reference(case):
    """Greedy next tokens of the fused prefill: (B, 1), or (B, 1, K)."""
    jcfg, cfg, jparams, params = case
    toks, cross = _inputs(cfg, 4, 17, seed=3)
    batch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if cross is not None:
        batch["cross_embeds"], tbatch["cross_embeds"] = jnp.asarray(cross), _t(cross)
    want = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, batch)
    got = steps.make_prefill_step(cfg, device="cpu")(params, tbatch)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert got.shape == (4, 1) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_tokens_equal_reference(case):
    """Prefill by replay, then greedy decode: the reference's tokens; the
    first equal to the fused prefill's."""
    jcfg, cfg, jparams, params = case
    prompts, cross = _inputs(cfg, 3, 6, seed=4)
    want = jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts), gen_len=5,
                              cross_embeds=_j(cross))
    got = serve.serve_batch(cfg, params, torch.from_numpy(prompts), gen_len=5,
                            cross_embeds=_t(cross), device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tbatch = {"tokens": torch.from_numpy(prompts)}
    if cross is not None:
        tbatch["cross_embeds"] = _t(cross)
    first = steps.make_prefill_step(cfg, device="cpu")(params, tbatch)
    np.testing.assert_array_equal(first.numpy(), got[:, :1].numpy())


def test_init_tree_matches_reference_layout(case):
    """Keys, shapes and dtypes of the reference's tree: a (K, V, E)
    embedding and (K, E, V) heads with codebooks, no ``lm_head`` when
    tied, (vision_dim, Kv, Dh) k/v projections on "X" layers."""
    jcfg, cfg, jparams, _ = case
    ours = tr.init_model(cfg, 0, device="cpu")
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    tshapes = tr._map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]), ours)
    assert tshapes == jshapes
    assert ("lm_head" in ours) == (not cfg.tie_embeddings)


def test_cross_attention_at_num_patches_takes_the_plain_path(monkeypatch):
    """S == num_patches: the attention owner would send same-length q/k to
    the flash wrapper, but an "X" layer never asks for it (the reference
    passes no ``use_flash`` there). With ``use_flash`` only the 4 "A"
    layers reach the wrapper, and the logits equal the plain path's."""
    jcfg, cfg, jparams, params = _build("llama-3.2-vision-90b", False)
    toks, cross = _inputs(cfg, 2, cfg.num_patches, seed=5)
    calls = []
    wrapper = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention",
                        lambda q, k, v, **kw: calls.append(q.shape) or wrapper(q, k, v, **kw))
    fast, _ = tr.forward(params, torch.from_numpy(toks), cfg, cross_embeds=_t(cross))
    assert len(calls) == cfg.mixer_pattern.count("A") == 4
    plain, _ = tr.forward(params, torch.from_numpy(toks), cfg, cross_embeds=_t(cross),
                          use_flash=False)
    assert len(calls) == 4 and torch.equal(fast, plain)
    want, _ = jforward(jparams, jnp.asarray(toks), jcfg, cross_embeds=jnp.asarray(cross))
    np.testing.assert_allclose(fast.numpy(), np.asarray(want), **TOL)


def test_params_from_jax_rejects_a_tied_tree_for_an_untied_config():
    jcfg, cfg, jparams, _ = _build("musicgen-medium", True)
    tied = jax.tree.map(np.asarray, jparams)
    assert "lm_head" not in tied
    with pytest.raises(ValueError, match="keys"):
        tr.params_from_jax(tied, cfg.replace(tie_embeddings=False))
    untied = jax.tree.map(np.asarray, _build("musicgen-medium", False)[2])
    with pytest.raises(ValueError, match="keys"):
        tr.params_from_jax(untied, cfg)


def test_cross_attention_needs_its_embeddings():
    _, cfg, _, params = _build("llama-3.2-vision-90b", False)
    toks, _ = _inputs(cfg, 1, 4)
    with pytest.raises(ValueError, match="cross_embeds"):
        tr.forward(params, torch.from_numpy(toks), cfg)


@pytest.mark.parametrize("name,match", [("llama-3.2-vision-90b", "cross-attention"),
                                        ("musicgen-medium", "one-codebook")])
def test_batcher_refuses_cross_attention_and_codebooks(name, match):
    """The reference's batcher asserts one codebook and passes no image
    embeddings: the port's refuses both kinds with a clear error."""
    cfg = configs.get_config(name).scaled_down()
    with pytest.raises(ValueError, match=match):
        ContinuousBatcher(cfg, None, device="cpu")


def test_full_width_configs():
    """Parameter counts at the published widths, from the reference's tree
    (``jax.eval_shape``) and from the port's leaf shapes: musicgen-medium
    whole, llama-3.2-vision-90b whole and cut to one 5-layer period."""
    counts = {}
    for name, layers in (("musicgen-medium", None), ("llama-3.2-vision-90b", None),
                         ("llama-3.2-vision-90b", 5)):
        jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
        if layers:
            jcfg, cfg = jcfg.replace(num_layers=layers), cfg.replace(num_layers=layers)
        shapes = jax.eval_shape(lambda: jtr.init_model(jcfg, jax.random.PRNGKey(0)))
        counts[(name, layers)] = n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
        E, V, K = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
        H, Kv, Dh, F = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
        norm = {"rmsnorm": E, "layernorm": 2 * E}[cfg.norm_type]
        per = {mix: (E * H * Dh + 2 * (cfg.vision_dim if mix == "X" else E) * Kv * Dh
                     + H * Dh * E + 2 * norm + (3 if cfg.glu else 2) * E * F)
               for mix in set(cfg.mixer_pattern)}
        port = (K * V * E * (1 if cfg.tie_embeddings else 2) + norm
                + cfg.num_repeats * sum(per[m] for m in cfg.mixer_pattern))
        assert port == n
    assert counts[("musicgen-medium", None)] == 1_384_418_304
    assert counts[("llama-3.2-vision-90b", None)] == 87_645_822_976
    assert counts[("llama-3.2-vision-90b", 5)] == 6_378_577_920


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "musicgen-medium"])
def test_launcher_on_the_cpu(arch, capsys):
    rec = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "4", "--gen-len", "3"])
    cfg = configs.get_config(arch).scaled_down()
    assert rec["arch"] == arch and len(rec["tokens"]) == 2
    toks = np.asarray(rec["tokens"])
    assert toks.shape == (2, 3) + ((4,) if cfg.num_codebooks > 1 else ())
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert f"generated {toks.shape}" in capsys.readouterr().out
