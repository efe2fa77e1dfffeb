"""Port ↔ reference parity: the language models in bf16
(``ModelConfig.dtype="bfloat16"``), one family of mixers each: gemma3's
"L"/"A" attention, mamba2's "M" (SSD) and deepseek's "E" (mixture of
experts, its router fp32). jamba's hybrid stack is held in fp32 only
(``tests/test_torch_moe_lm.py``): its scaled-down routers take top-k
choices at margins below bf16's 2^-8, so the two packages' roundings flip
a route now and then, and its Mamba2 layers carry the flipped token's
change into every later position.

Each architecture runs at its ``scaled_down()`` widths in bf16. The
reference's ``init_model`` draws the weights (bf16 leaves, and the fp32
leaves it keeps: the router, mamba's A_log, D and dt_bias), and
``params_from_jax`` carries them across; prompts are numpy draws.

Bound: the two packages round to bf16 at other places (XLA keeps fused
bf16 arithmetic at higher precision; torch rounds each operator), so the
logits are held to the bound of ``chip_smoke.py``'s phase 9 for bf16
against fp32: max|Δ| ≤ 4·sqrt(2·layers)·2^-8·max|logit| (each layer's two
residual updates rounded to bf16, 2^-8 relative, independent roundings in
quadrature, the largest of the vocabulary's errors at 4 standard
deviations); greedy tokens equal wherever the reference's top-2 gap
exceeds the bound. The fp32 leaves, the cache's and the Mamba2 state's
dtypes equal the reference's exactly (KV caches in bf16, the SSM state
fp32, the conv state bf16).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.models import transformer as tr

torch.set_num_threads(2)

ARCHS = ("gemma3-12b", "mamba2-2.7b", "deepseek-moe-16b")
B, S, STEPS = 2, 24, 6

jforward = jax.jit(jtr.forward, static_argnames=("cfg", "last_logits_only"))
jdecode = jax.jit(jtr.decode_step, static_argnames="cfg")


def bound(num_layers: int, scale: float) -> float:
    return 4.0 * math.sqrt(2 * num_layers) * 2.0 ** -8 * scale


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jconfigs.get_config(request.param).scaled_down().replace(dtype="bfloat16")
    cfg = configs.get_config(request.param).scaled_down().replace(dtype="bfloat16")
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(0))
    params = tr.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, cfg, jparams, params


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _hold(got: torch.Tensor, want, num_layers: int) -> None:
    """``got`` within ``bound`` of ``want``, and the same argmax wherever
    the reference's top-2 gap exceeds it."""
    got, want = got.float().numpy(), _f32(want)
    assert np.isfinite(got).all()
    lim = bound(num_layers, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= lim, (np.abs(got - want).max(), lim)
    rows_g, rows_w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    top2 = np.sort(rows_w, axis=-1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    differ = rows_g.argmax(-1) != rows_w.argmax(-1)
    assert not (differ & (gap > lim)).any()


def _prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, vocab, (B, S)).astype(np.int32)


def test_params_keep_the_reference_dtypes(arch):
    jcfg, cfg, jparams, params = arch
    want = {"/".join(str(getattr(k, "key", k)) for k in path): str(leaf.dtype)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                got[f"{prefix}{k}"] = str(v.dtype).removeprefix("torch.")

    walk(params, "")
    assert got == want
    assert "bfloat16" in got.values()


def test_forward_bf16_matches_reference(arch):
    jcfg, cfg, jparams, params = arch
    toks = _prompts(cfg.vocab_size)
    want, _ = jforward(jparams, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, _ = tr.forward(params, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _hold(got, want, cfg.num_layers)


def test_decode_bf16_matches_reference(arch):
    jcfg, cfg, jparams, params = arch
    toks = _prompts(cfg.vocab_size)
    jstate = jtr.init_decode_state(jcfg, B, S + STEPS)
    state = tr.init_decode_state(cfg, B, S + STEPS, device="cpu")
    jl = sorted(str(a.dtype) for a in jax.tree_util.tree_leaves(jstate))
    tl = []
    tr._map(lambda a: tl.append(str(a.dtype).removeprefix("torch.")), state)
    assert sorted(tl) == jl  # KV caches and the Mamba2 state as the reference's
    for i in range(STEPS):
        tok = toks[:, i:i + 1]
        want, jstate = jdecode(jparams, jnp.asarray(tok), jstate, jcfg)
        with torch.no_grad():
            got, state = tr.decode_step(params, torch.from_numpy(tok), state, cfg)
        assert got.dtype == torch.bfloat16
        _hold(got, want, cfg.num_layers)
