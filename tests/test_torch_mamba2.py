"""Port ↔ reference parity: the Mamba2 mixer layer
(``repro_torch.models.mamba2``).

The reference's ``init_mamba`` draws the parameters; the port takes the
same values (numpy leaves) and both layers see the same numpy inputs.
Bound: rtol = atol = 2e-4, the reference's own bound of its decode
against its forward (``tests/test_kernels_ssd.py:76``): fp32 throughout,
products and sums in another order (the SSD chunks, the matmuls' blocking,
XLA's fused multiply-adds). The convolution helpers and softplus compute
the same fp32 operations in the same order and are held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import MambaConfig as JMambaConfig
from repro.models import ModelConfig as JModelConfig
from repro.models import mamba2 as jm
from repro_torch.models import MambaConfig, ModelConfig
from repro_torch.models import mamba2 as tm
from repro_torch.models.kvcache import MambaState

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)

#: the reference's forward, compiled once per shape (eager, it dispatches
#: op by op)
jforward = jax.jit(jm.mamba_forward, static_argnames=("cfg", "use_pallas"))

LAYERS = {
    # the reference test's layer: d_model 32, 4 heads of 16
    "ref_test": dict(d_model=32, mamba=dict(d_state=16, head_dim=16)),
    # two groups: heads 0-3 read group 0, heads 4-7 group 1
    "two_groups": dict(d_model=64, mamba=dict(d_state=16, head_dim=16, n_groups=2)),
    # mamba2-2.7b scaled down (d_model 256, d_state 32, head_dim 32: 16 heads)
    "mamba2_small": dict(d_model=256, mamba=dict(d_state=32, head_dim=32)),
}


def _cfgs(name):
    spec = LAYERS[name]
    common = dict(name="m", arch_type="ssm", num_layers=1, d_model=spec["d_model"],
                  num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=16,
                  mixer_pattern=("M",), mlp_pattern=("N",))
    return (JModelConfig(**common, mamba=JMambaConfig(**spec["mamba"])),
            ModelConfig(**common, mamba=MambaConfig(**spec["mamba"])))


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _setup(name, seed=0, B=2, S=10):
    jcfg, tcfg = _cfgs(name)
    jparams = jm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, _to_port(jparams), x


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_path"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_forward_matches_reference(name, use_kernel):
    jcfg, tcfg, jparams, params, x = _setup(name, S=37)
    want = jforward(jparams, jnp.asarray(x), jcfg)
    got = tm.mamba_forward(params, torch.from_numpy(x), tcfg, use_kernel=use_kernel)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches_reference_pallas_kernel():
    """Against the reference's forward through its Pallas kernel
    (interpret mode on the CPU)."""
    jcfg, tcfg, jparams, params, x = _setup("two_groups", seed=1, S=24)
    want = jforward(jparams, jnp.asarray(x), jcfg, use_pallas=True)
    got = tm.mamba_forward(params, torch.from_numpy(x), tcfg, use_kernel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", list(LAYERS))
def test_decode_matches_reference(name):
    """Token by token from the zero state: outputs and both states."""
    jcfg, tcfg, jparams, params, x = _setup(name, seed=2, S=6)
    jstate = jm.init_mamba_decode_state(jcfg, 2)
    state = tm.init_mamba_decode_state(tcfg, 2, device="cpu")
    assert tuple(state.conv.shape) == jstate.conv.shape
    assert tuple(state.ssm.shape) == jstate.ssm.shape and state.ssm.dtype == torch.float32
    for i in range(x.shape[1]):
        want, jstate = jm.mamba_decode(jparams, jnp.asarray(x[:, i:i + 1]), jcfg, jstate)
        got, state = tm.mamba_decode(params, torch.from_numpy(x[:, i:i + 1]), tcfg, state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(state.conv.numpy(), np.asarray(jstate.conv), **TOL)
    np.testing.assert_allclose(state.ssm.numpy(), np.asarray(jstate.ssm), **TOL)


@pytest.mark.parametrize("name", list(LAYERS))
def test_decode_matches_forward(name):
    """Within the port: the recurrent decode reproduces the chunked
    forward (the reference's test_mamba_decode_matches_forward)."""
    _, tcfg, _, params, x = _setup(name, seed=3)
    xt = torch.from_numpy(x)
    y_full = tm.mamba_forward(params, xt, tcfg, use_kernel=True)
    state = tm.init_mamba_decode_state(tcfg, 2, device="cpu")
    ys = []
    for i in range(x.shape[1]):
        y, state = tm.mamba_decode(params, xt[:, i:i + 1], tcfg, state)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_full.numpy(), **TOL)


@pytest.mark.parametrize("name", list(LAYERS))
def test_init_matches_reference_layout(name):
    jcfg, tcfg = _cfgs(name)
    jparams = jm.init_mamba(jax.random.PRNGKey(0), jcfg)
    params = tm.init_mamba(tcfg, torch.Generator().manual_seed(0))
    flat = lambda t, p="": ({p: t} if not isinstance(t, dict) else
                            {k: v for kk, vv in t.items() for k, v in flat(vv, f"{p}/{kk}").items()})
    jf, tf = flat(jparams), flat(params)
    assert set(jf) == set(tf)
    for k in jf:
        assert tuple(tf[k].shape) == jf[k].shape, k
        assert str(tf[k].dtype).split(".")[1] == str(jf[k].dtype), k
    for k in ("/A_log", "/D", "/norm/scale"):  # deterministic leaves
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), rtol=1e-6)
    dt0 = torch.nn.functional.softplus(tf["/dt_bias"])
    assert bool(((dt0 > 0.99e-3) & (dt0 < 1.01e-1)).all())


def test_conv_helpers_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jm._causal_conv(jnp.asarray(x), jnp.asarray(w))), rtol=1e-6, atol=1e-6)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    new = rng.standard_normal((2, 12)).astype(np.float32)
    s_t, y_t = tm._conv_step(torch.from_numpy(state), torch.from_numpy(new), torch.from_numpy(w))
    s_j, y_j = jm._conv_step(jnp.asarray(state), jnp.asarray(new), jnp.asarray(w))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)


def test_softplus_matches_jax_past_torch_threshold():
    """dt = softplus(·) as jax.nn.softplus, also above F.softplus's
    threshold of 20, where torch's version returns its input."""
    v = np.concatenate([np.linspace(-30, 30, 601), [19.9, 20.0, 20.1, 25.0]]).astype(np.float32)
    got = tm._softplus(torch.from_numpy(v)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_decode_state_dtypes():
    _, tcfg = _cfgs("ref_test")
    st = tm.init_mamba_decode_state(tcfg.replace(dtype="bfloat16"), 3, device="cpu")
    assert isinstance(st, MambaState)
    assert st.conv.dtype == torch.bfloat16 and st.ssm.dtype == torch.float32
    assert tuple(st.conv.shape) == (3, 3, 64 + 2 * 16) and tuple(st.ssm.shape) == (3, 4, 16, 16)
