"""Port ↔ reference parity: the mixture-of-experts MLP
(``repro_torch.models.moe`` against ``repro/models/moe.py``).

The first tests mirror ``tests/test_moe.py`` and the padded-experts row
of ``tests/test_perf_levers.py`` on the port's own ``init_moe``. The
parity tests carry the reference's ``init_moe`` weights across and feed
both the same numpy input, through both dispatches, over: T not a
multiple of the group (zero pad rows), capacity overflow, shared
experts, padded experts, a block of exactly tied rows (zero tokens among
real ones, which route uniformly) and router columns duplicated (every
row tied between two experts).

Bounds: the routing decisions (expert_idx, pos, keep) exactly equal; y
within 1e-5·(1 + max|y|) (fp32; the combine's sum of k terms and the
expert products sum in another order); aux within 1e-6. A routing
mismatch reports the reference's top-k margin, the smallest gap among a
token's k + 1 largest probabilities over its largest, so that a near
tie is told apart from a fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JModelConfig
from repro.models import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.models import ModelConfig, MoEConfig, apply_moe, init_moe
from repro_torch.models import moe

torch.set_num_threads(2)

Y_RTOL = 1e-5
AUX_TOL = 1e-6


def _cfgs(num_experts=4, top_k=2, shared=0, cf=1.25, padded=0, d_model=32):
    """The same configuration built by both packages (reference
    ``tests/test_moe.py::_cfg``)."""
    kw = dict(name="moe-test", arch_type="moe", num_layers=1, d_model=d_model, num_heads=4,
              num_kv_heads=4, d_ff=0, vocab_size=16, mlp_pattern=("E",))
    mk = dict(num_experts=num_experts, top_k=top_k, expert_ffn=16, num_shared_experts=shared,
              shared_ffn=16 * max(shared, 1), capacity_factor=cf, padded_experts=padded)
    return JModelConfig(**kw, moe=JMoEConfig(**mk)), ModelConfig(**kw, moe=MoEConfig(**mk))


def _params(cfg, seed=0):
    return init_moe(cfg, torch.Generator().manual_seed(seed))


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


# ----------------------------------------------------------------------
# mirrors of tests/test_moe.py
# ----------------------------------------------------------------------

def test_output_shape_and_finite():
    _, cfg = _cfgs()
    x = _x((2, 16, 32))
    y, aux = apply_moe(_params(cfg), x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) >= 0.0


def test_aux_loss_minimized_by_uniform_routing():
    """Uniform router logits: the Switch term at its bound, times the weight."""
    _, cfg = _cfgs(num_experts=8, top_k=2)
    params = _params(cfg)
    params["router"].zero_()
    _, aux = apply_moe(params, _x((4, 64, 32)), cfg)
    assert float(aux) == pytest.approx(cfg.moe.router_aux_weight, rel=0.05)


def test_capacity_overflow_drops_tokens():
    """A tiny capacity factor drops most choices: the routed output shrinks."""
    _, cfg_small = _cfgs(cf=0.05)
    _, cfg_big = _cfgs(cf=8.0)
    params = _params(cfg_small)
    x = _x((2, 64, 32))
    y_small, _ = apply_moe(params, x, cfg_small)
    y_big, _ = apply_moe(params, x, cfg_big)
    assert float(y_small.abs().mean()) < float(y_big.abs().mean())


def test_shared_experts_always_active():
    """With the routed experts zeroed the shared path still answers."""
    _, cfg = _cfgs(shared=2)
    params = _params(cfg)
    params["w_out"].zero_()
    y, _ = apply_moe(params, _x((2, 8, 32)), cfg)
    assert float(y.abs().mean()) > 1e-3


def test_group_size_does_not_change_small_batch():
    """All tokens within capacity: the group size changes nothing."""
    _, cfg = _cfgs(cf=8.0)
    params = _params(cfg)
    x = _x((2, 32, 32))
    y1, _ = apply_moe(params, x, cfg, group_size=64)
    y2, _ = apply_moe(params, x, cfg, group_size=32)
    torch.testing.assert_close(y1, y2, rtol=2e-5, atol=2e-5)


def test_capacity_formula():
    mc = MoEConfig(num_experts=8, top_k=2, expert_ffn=4, capacity_factor=1.0)
    assert moe._capacity(64, mc) == jmoe._capacity(64, mc) == 16
    mc2 = MoEConfig(num_experts=8, top_k=2, expert_ffn=4, capacity_factor=1.25)
    assert moe._capacity(64, mc2) == jmoe._capacity(64, mc2) == 20
    for g, X, k, cf in ((4, 64, 6, 1.25), (512, 64, 6, 1.25), (512, 40, 8, 1.25),
                        (1, 16, 2, 1.25), (7, 3, 2, 0.05)):
        mc = MoEConfig(num_experts=X, top_k=k, expert_ffn=4, capacity_factor=cf)
        assert moe._capacity(g, mc) == jmoe._capacity(g, mc)


@pytest.mark.parametrize("X,k,cf", [(8, 3, 1.25), (4, 2, 0.5), (16, 2, 2.0)])
def test_gather_dispatch_matches_einsum(X, k, cf):
    """The gather/scatter dispatch against the one-hot products, overflow
    included: the same aux bit for bit, y within the fp32 bound."""
    _, cfg = _cfgs(num_experts=X, top_k=k, cf=cf)
    params = _params(cfg)
    x = _x((2, 100, 32), seed=X)
    y1, a1 = apply_moe(params, x, cfg, group_size=64, dispatch="einsum")
    y2, a2 = apply_moe(params, x, cfg, group_size=64, dispatch="gather")
    torch.testing.assert_close(y1, y2, rtol=2e-5, atol=2e-5)
    assert float(a1) == float(a2)


def test_expert_padding_preserves_outputs():
    """Padded experts are never routed to (``tests/test_perf_levers.py``):
    the unpadded model on the same real experts gives the same output."""
    _, cfg = _cfgs(num_experts=5, top_k=2)
    _, cfg_pad = _cfgs(num_experts=5, top_k=2, padded=8)
    params_pad = _params(cfg_pad)
    params = {k: params_pad[k][:, :5] if k == "router" else params_pad[k][:5]
              for k in ("router", "w_in", "w_gate", "w_out")}
    x = _x((2, 64, 32))
    y0, a0 = apply_moe(params, x, cfg)
    rec = []
    y1, a1 = apply_moe(params_pad, x, cfg_pad, routing=rec)
    torch.testing.assert_close(y0, y1, rtol=2e-5, atol=2e-5)
    assert float(a0) == pytest.approx(float(a1), rel=1e-5)
    assert int(rec[0]["expert_idx"].max()) < 5


def test_unknown_dispatch_raises():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="dispatch"):
        apply_moe(_params(cfg), _x((1, 4, 32)), cfg, dispatch="scatter")


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------

#: (name, config kw, input shape, group size, what it covers)
CASES = {
    "pad_rows": (dict(), (1, 37, 32), 16),  # T = 37: 11 zero rows pad the last group
    "overflow": (dict(num_experts=8, top_k=3, cf=0.5), (2, 50, 32), 64),
    "shared": (dict(shared=2), (2, 32, 32), 64),
    "padded_experts": (dict(num_experts=5, padded=8), (2, 40, 32), 32),
    "tied_rows": (dict(num_experts=8, top_k=3, cf=1.0), (1, 96, 32), 48),
    "tied_experts": (dict(num_experts=6, top_k=2), (2, 24, 32), 16),
    "deepseek_like": (dict(num_experts=16, top_k=6, shared=2, d_model=64), (1, 70, 64), 32),
}


def _reference_routing(jparams, x, jcfg, g):
    """The reference's routing of x's groups, as the reference pads and
    splits them (``apply_moe``, :161)."""
    E = x.shape[-1]
    xt = jnp.asarray(x.reshape(-1, E))
    T = xt.shape[0]
    pad = (-T) % g
    if pad:
        xt = jnp.pad(xt, ((0, pad), (0, 0)))
    xG = xt.reshape(-1, g, E)
    C = jmoe._capacity(g, jcfg.moe)

    def one(xg):
        gate, idx, _, pos, keep, aux = jmoe._route_common(xg, jparams, jcfg, C)
        logits = xg.astype(jnp.float32) @ jparams["router"]
        logits = logits.at[:, jcfg.moe.num_experts:].set(-1e9)  # padded experts
        probs = jax.nn.softmax(logits, axis=-1)
        return idx, pos, keep, probs

    idx, pos, keep, probs = jax.vmap(one)(xG)
    return np.asarray(idx), np.asarray(pos), np.asarray(keep), np.asarray(probs)


def _margins(probs, k):
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    return np.min(top[..., :-1] - top[..., 1:], axis=-1) / top[..., 0]


def _case(name, seed=0):
    kw, shape, g = CASES[name]
    jcfg, cfg = _cfgs(**kw)
    jparams = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if name == "tied_rows":
        x[0, 10:30] = 0.0  # twenty zero tokens among real ones: uniform probabilities
    if name == "tied_experts":  # experts 1 and 3 score alike for every token
        jparams = dict(jparams, router=jparams["router"].at[:, 3].set(jparams["router"][:, 1]))
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jparams)
    return jcfg, cfg, jparams, params, x, g


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_matches_reference(name, dispatch):
    jcfg, cfg, jparams, params, x, g = _case(name)
    want_y, want_aux = jmoe.apply_moe(jparams, jnp.asarray(x), jcfg, group_size=g,
                                      dispatch=dispatch)
    rec = []
    y, aux = apply_moe(params, torch.from_numpy(x), cfg, group_size=g, dispatch=dispatch,
                       routing=rec)

    idx, pos, keep, probs = _reference_routing(jparams, x, jcfg, g)
    got = rec[0]
    assert got["tokens"] == x.shape[0] * x.shape[1]
    assert got["capacity"] == jmoe._capacity(g, jcfg.moe)
    bad = np.argwhere((got["expert_idx"].numpy() != idx).any(-1))
    if len(bad):
        margins = _margins(probs, jcfg.moe.top_k)
        detail = "; ".join(f"group {n} token {t}: port {got['expert_idx'][n, t].tolist()} "
                           f"reference {idx[n, t].tolist()} (reference top-k margin "
                           f"{margins[n, t]:.2e})" for n, t in bad[:8])
        pytest.fail(f"{len(bad)} routing decisions differ: {detail}")
    np.testing.assert_array_equal(got["pos"].numpy(), pos)
    np.testing.assert_array_equal(got["keep"].numpy(), keep)
    np.testing.assert_allclose(got["margin"].numpy(), _margins(probs, jcfg.moe.top_k),
                               rtol=1e-4, atol=1e-6)
    if name == "overflow":
        assert not keep.all()
    if name in ("tied_rows", "pad_rows"):  # uniform rows take experts 0..k-1 in order
        k = jcfg.moe.top_k
        assert (idx.reshape(-1, k) == np.arange(k)).all(-1).sum() >= 11

    want_y = np.asarray(want_y)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0,
                               atol=Y_RTOL * (1 + np.abs(want_y).max()))
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


def test_ties_take_the_lower_expert_first():
    """The stable sort against ``lax.top_k`` on rows with exact ties,
    within and across the top-k boundary."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.2, 0.2], [0.2, 0.2, 0.4, 0.2]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1])
    got = torch.sort(torch.from_numpy(probs), dim=-1, descending=True, stable=True)[1][:, :2]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [[0, 1], [1, 2], [0, 1], [2, 0]])
