"""Port ↔ reference parity: the precision policy (DESIGN.md §8).

A mirror of every test of ``tests/test_precision.py`` against the port's
``PrecisionPolicy`` (the policy object, the dtype at every seam, the fp32
preset bitwise the default, the bf16 smoke), and:

* ``as_dict()`` and ``name`` equal to the reference's for every preset
  and for per-seam overrides (``"custom"`` included);
* the precision gate of ``tests/test_solver_conformance.py:156`` on the
  port's own RNG: under ``bf16`` and ``bf16_full`` the adaptive solve of
  the closed-form VP and VE Gaussians (512 × 8) has W2 ≤ 2 × the fp32
  run's W2 + the Monte-Carlo floor 3·s/√(B·D), and mean NFE ≤ 1.25 ×;
* the accept decisions under ``bf16`` and ``bf16_full`` equal to the
  reference's, stepped one iteration at a time from identical carries on
  the reference's replayed noise (whole solves do not survive bf16, so
  the comparison restarts from the reference's carry every iteration):
  accepted, rejected, nfe and done exactly; x within 2^-8 of max|x| (the
  score is rounded to bf16 in both, at other places: XLA keeps fused bf16
  arithmetic at higher precision, torch rounds each operator, so a score
  element may differ by one bf16 ulp, which the step carries into x).

Bounds stated where used: the bf16 DiT forward against the reference's
bf16 forward on the same weights rtol = atol = 5e-2 (the bf16 bound of
``tests/test_torch_dit.py``: bf16 products rounded at other places),
against the port's fp32 forward the reference smoke's rtol 0.1, atol 0.05.
"""

import dataclasses
import importlib
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as jan
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.models import dit as jdit
from repro_torch.core import analytic as tan
from repro_torch.core.precision import PrecisionPolicy, resolve_policy
from repro_torch.core.sampling import sample, solve_in_chunks
from repro_torch.core.sde import VPSDE
from repro_torch.core.solvers import adaptive as tad
from repro_torch.models import dit as tdit
from repro_torch.models.layers import to_tensor

from test_torch_adaptive import SDES, ReferenceNoise, _prior
from test_torch_dit import JCFG, TCFG, reference_params

jad = importlib.import_module("repro.core.solvers.adaptive")

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
BATCH, DIM = 512, 8
PRESETS = ("fp32", "bf16", "bf16_full")


def _score(sde):
    return tan.gaussian_score(sde, MU, S0)


# ---------------------------------------------------------------------------
# the policy object
# ---------------------------------------------------------------------------


def test_presets():
    assert PrecisionPolicy("fp32").compute == torch.float32
    p = PrecisionPolicy("bf16")
    assert (p.compute, p.param, p.state) == (torch.bfloat16, torch.float32, torch.float32)
    pf = PrecisionPolicy("bf16_full")
    assert (pf.compute, pf.param, pf.state) == (torch.bfloat16,) * 3
    assert pf.name == "bf16_full" and not pf.is_fp32
    with pytest.raises(ValueError):
        PrecisionPolicy("fp8")


def test_control_dtype_is_pinned_fp32():
    """There is no knob that downcasts the control path."""
    for preset in PRESETS:
        assert PrecisionPolicy(preset).control == torch.float32
    p = PrecisionPolicy("bf16", state_dtype="bfloat16")
    assert p.state == torch.bfloat16 and p.control == torch.float32
    assert "control_dtype" not in inspect.signature(PrecisionPolicy.__init__).parameters
    with pytest.raises(TypeError):
        PrecisionPolicy("bf16", control_dtype="bfloat16")


def test_resolve_policy_forms():
    p = PrecisionPolicy("bf16")
    assert resolve_policy(None).is_fp32
    assert resolve_policy("bf16") == p
    assert resolve_policy(p) is p
    with pytest.raises(TypeError):
        resolve_policy(16)


def test_policy_is_frozen_and_hashable():
    """The reference's policy is a static pytree; the port's is a frozen
    dataclass: hashable, equal by dtypes, usable as a cache key."""
    p = PrecisionPolicy("bf16_full")
    assert hash(p) == hash(PrecisionPolicy("bf16_full"))
    assert {p: 1}[PrecisionPolicy("bf16", param_dtype="bfloat16", state_dtype="bfloat16")] == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.compute = torch.float32
    assert p.to_compute(torch.ones(2)).dtype == torch.bfloat16


def test_overrides_take_dtypes_and_names():
    a = PrecisionPolicy("bf16", state_dtype="bfloat16")
    b = PrecisionPolicy("bf16", state_dtype=torch.bfloat16)
    assert a == b and a.state == torch.bfloat16
    assert PrecisionPolicy("fp32", compute_dtype="bfloat16").name == "bf16"
    with pytest.raises(ValueError):
        PrecisionPolicy("fp32", compute_dtype="bfloat17")


def test_building_a_policy_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    PrecisionPolicy("bf16", state_dtype="bfloat16")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_cast_params_touches_only_floating_leaves():
    p = PrecisionPolicy("bf16_full")
    tree = {"w": torch.ones(2, 2), "steps": torch.zeros(3, dtype=torch.int32),
            "nested": {"b": torch.ones(3, dtype=torch.bfloat16)}}
    cast = p.cast_params(tree)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["steps"] is tree["steps"]  # integer leaves pass untouched
    assert cast["nested"]["b"] is tree["nested"]["b"]  # already bf16: no copy
    assert tree["w"].dtype == torch.float32  # a tree is not cast in place
    same = PrecisionPolicy("bf16").cast_params(tree)
    assert same["w"] is tree["w"]  # bf16 stores fp32 masters: no copy
    assert p.params_for_compute(tree)["w"].dtype == torch.bfloat16
    # a module is cast in place, its weights not duplicated
    model = tdit.init_dit(dataclasses.replace(TCFG, num_layers=1), torch.Generator())
    assert p.cast_params(model) is model
    assert {q.dtype for q in model.parameters()} == {torch.bfloat16}
    view = PrecisionPolicy("bf16", param_dtype="bfloat16").params_for_compute(model)
    assert all(view[n] is q for n, q in model.named_parameters())


def test_wrap_score_fn_dtypes():
    p = PrecisionPolicy("bf16")
    seen = {}

    def raw(x, t):
        seen["x_dtype"] = x.dtype
        return x * 2.0

    out = p.wrap_score_fn(raw)(torch.ones(4, 2), torch.ones(4))
    assert seen["x_dtype"] == torch.bfloat16  # entry cast → compute
    assert out.dtype == torch.float32  # exit cast → state
    assert p.to_control(torch.ones(2, dtype=torch.bfloat16)).dtype == torch.float32


@pytest.mark.parametrize("kw", [{}, {"state_dtype": "bfloat16"}, {"param_dtype": "bfloat16"},
                                {"compute_dtype": "float32"}, {"state_dtype": "float32"}],
                         ids=["preset", "state", "param", "compute", "state32"])
@pytest.mark.parametrize("preset", PRESETS)
def test_as_dict_and_name_match_reference(preset, kw):
    """The record's keys and values, and the derived name (a preset's
    where the dtypes are one, else "custom"), as the reference's."""
    got, want = PrecisionPolicy(preset, **kw), JPolicy(preset, **kw)
    assert got.as_dict() == want.as_dict()
    assert (got.name, got.is_fp32) == (want.name, want.is_fp32)
    assert (got.compute_dtype, got.param_dtype, got.state_dtype, got.control_dtype) == (
        want.compute_dtype, want.param_dtype, want.state_dtype, want.control_dtype)


# ---------------------------------------------------------------------------
# solver seams
# ---------------------------------------------------------------------------


def test_carry_state_dtype_follows_policy_control_stays_fp32():
    sde = VPSDE()
    x0 = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    for preset, sdt in (("fp32", torch.float32), ("bf16", torch.float32),
                        ("bf16_full", torch.bfloat16)):
        c = tad.init_carry(sde, x0, None, config=tad.AdaptiveConfig(precision=preset))
        assert c.x.dtype == sdt and c.x_prev.dtype == sdt, preset
        assert c.t.dtype == torch.float32 and c.h.dtype == torch.float32, preset


def test_fp32_policy_bit_identical_to_default():
    """PrecisionPolicy('fp32') as the config default, a preset name or an
    object is bitwise the unpoliced solver, chunked and monolithic."""
    sde = VPSDE()
    forms = [dict(), dict(precision="fp32"), dict(precision=PrecisionPolicy("fp32"))]
    results = [sample(sde, _score(sde), (8, 16), seed=0, device="cpu", eps_rel=0.05, **kw)
               for kw in forms]
    for other in results[1:]:
        assert torch.equal(results[0].x, other.x) and torch.equal(results[0].nfe, other.nfe)
    chunked = solve_in_chunks(sde, _score(sde), (8, 16), max_sync_iters=7, seed=0,
                              device="cpu", eps_rel=0.05, precision=PrecisionPolicy("fp32"))
    assert torch.equal(results[0].x, chunked.x)


def test_bf16_chunking_still_bitwise_vs_monolithic():
    """Chunk boundaries add no rounding under the bf16 state."""
    sde = VPSDE()
    kw = dict(seed=0, device="cpu", eps_rel=0.05, precision="bf16_full")
    mono = sample(sde, _score(sde), (8, 16), **kw)
    chunked = solve_in_chunks(sde, _score(sde), (8, 16), max_sync_iters=7, **kw)
    for field in ("x", "nfe", "accepted", "rejected"):
        assert torch.equal(getattr(mono, field), getattr(chunked, field)), field


# ---------------------------------------------------------------------------
# model seams + the bf16 smoke
# ---------------------------------------------------------------------------


def test_bf16_policy_smoke():
    """A DiT forward under bf16 against the reference's bf16 forward on
    the same weights, and a whole adaptive solve: finite, x delivered in
    fp32 (Tweedie), the score in the state dtype."""
    tree = reference_params()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    t = np.full((4,), 0.5, np.float32)
    jpol = JPolicy("bf16")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jdit.dit_forward(jpol.cast_params(jparams), jnp.asarray(x), jnp.asarray(t), JCFG,
                            policy=jpol)
    policy = PrecisionPolicy("bf16")
    model = tdit.params_from_jax(tree, TCFG)
    with torch.no_grad():
        out32 = model(torch.from_numpy(x), torch.from_numpy(t))
        outbf = model(torch.from_numpy(x), torch.from_numpy(t), policy=policy)
    assert outbf.dtype == torch.bfloat16
    np.testing.assert_allclose(outbf.float().numpy(), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(outbf.float().numpy(), out32.numpy(), rtol=0.1, atol=0.05)

    sde = VPSDE()
    score = tdit.make_score_fn(model, sde, policy=policy)
    assert {q.dtype for q in model.parameters()} == {torch.float32}  # bf16 keeps fp32 masters
    assert score(torch.from_numpy(x), torch.from_numpy(t)).dtype == policy.state
    res = sample(sde, score, (4, 16, 16, 3), seed=0, device="cpu", eps_rel=0.05,
                 precision="bf16")
    assert bool(torch.isfinite(res.x).all())
    assert res.x.dtype == torch.float32
    assert int(res.iterations) > 0


def test_make_score_fn_stores_weights_at_the_param_dtype():
    """``make_score_fn`` stores the weights through ``cast_params``: in
    bf16 under bf16_full, in place (the same parameter objects)."""
    model = tdit.init_dit(dataclasses.replace(TCFG, num_layers=1), torch.Generator())
    ids = [id(q) for q in model.parameters()]
    tdit.make_score_fn(model, VPSDE(), policy=PrecisionPolicy("bf16_full"))
    assert {q.dtype for q in model.parameters()} == {torch.bfloat16}
    assert [id(q) for q in model.parameters()] == ids


def test_score_fn_policy_casts_are_idempotent_with_solver_wrap():
    """make_score_fn(policy=...) and the solver's own wrap compose:
    casting twice changes nothing."""
    sde = VPSDE()
    policy = PrecisionPolicy("bf16_full")
    score = policy.wrap_score_fn(_score(sde))
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    t = torch.full((4,), 0.5)
    assert torch.equal(score(x, t), policy.wrap_score_fn(score)(x, t))


# ---------------------------------------------------------------------------
# the precision gate and the reference's decisions
# ---------------------------------------------------------------------------

_FP32 = {}


def _solve(sde_name, precision):
    sde = SDES[sde_name][1]
    return sample(sde, _score(sde), (BATCH, DIM), seed=0, device="cpu", denoise=False,
                  eps_rel=0.05, use_fused_kernel=True, precision=precision)


def _moments(x):
    xf = x.double()
    return xf.mean().item(), xf.std(unbiased=False).item()


@pytest.mark.parametrize("sde_name", sorted(SDES))
@pytest.mark.parametrize("preset", ["bf16", "bf16_full"])
def test_adaptive_precision_conformance(preset, sde_name):
    """The reference's precision gate on the port's own RNG: W2 ≤ 2 × fp32's
    W2 + the Monte-Carlo floor, mean NFE ≤ 1.25 × fp32's."""
    if sde_name not in _FP32:
        _FP32[sde_name] = _solve(sde_name, "fp32")
    res32, resbf = _FP32[sde_name], _solve(sde_name, preset)
    sde = SDES[sde_name][1]
    mu_a, s_a = tan.gaussian_marginal_moments(sde, MU, S0)
    w2_32 = tan.gaussian_w2(*_moments(res32.x), mu_a, s_a)
    w2_bf = tan.gaussian_w2(*_moments(resbf.x), mu_a, s_a)
    floor = 3.0 * s_a / math.sqrt(BATCH * DIM)
    assert bool(torch.isfinite(resbf.x).all())
    assert w2_bf <= 2.0 * w2_32 + floor, (preset, w2_bf, w2_32)
    assert float(resbf.mean_nfe) <= 1.25 * float(res32.mean_nfe), (
        preset, float(resbf.mean_nfe), float(res32.mean_nfe))


def _to_port(c):
    f = lambda a: to_tensor(np.asarray(a))  # bf16 leaves through ml_dtypes
    return tad.SolverCarry(x=f(c.x), x_prev=f(c.x_prev), t=f(c.t), h=f(c.h), nfe=f(c.nfe),
                           accepted=f(c.accepted), rejected=f(c.rejected), done=f(c.done),
                           iterations=f(c.iterations))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("sde_name", sorted(SDES))
@pytest.mark.parametrize("preset", ["bf16", "bf16_full"])
def test_bf16_accept_decisions_step_by_step(preset, sde_name, fused):
    """Along the reference's bf16 trajectory, one port iteration from the
    same carry with the same z takes the same decisions per sample."""
    js, ts = SDES[sde_name]
    jscore, tscore = jan.gaussian_score(js), _score(ts)
    jcfg = jad.AdaptiveConfig(eps_rel=0.05, precision=preset)
    tcfg = tad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=fused, precision=preset)
    step = jax.jit(lambda c: jad.solve_chunk(js, jscore, c, max_sync_iters=1, config=jcfg))
    carry = jad.init_carry(js, jnp.asarray(_prior((8, 24))), jax.random.PRNGKey(9),
                           config=jcfg)
    state = PrecisionPolicy(preset).state
    compared = 0
    while not bool(carry.done.all()):
        nxt = step(carry)
        body = tad._make_body(ts, tscore, tcfg, ts.abs_tolerance,
                              tad._step_math_fused if fused else tad._step_math_jnp,
                              ReferenceNoise(carry.key))
        got = body(_to_port(carry))
        for name in ("accepted", "rejected", "nfe", "done"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(nxt, name)), err_msg=name)
        want_x = np.asarray(nxt.x).astype(np.float32)
        assert got.x.dtype == state and got.t.dtype == torch.float32
        np.testing.assert_allclose(got.x.float().numpy(), want_x, rtol=0,
                                   atol=2.0 ** -8 * max(1.0, float(np.abs(want_x).max())))
        carry, compared = nxt, compared + 1
    assert int(carry.rejected.sum()) > 0 and compared > 20
