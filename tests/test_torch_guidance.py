"""Port ↔ reference parity: the conditioning seam
(``repro_torch.core.guidance`` and the solver's ``cond`` plumbing).

Mirrors ``tests/test_guidance.py`` for the adaptive solver: disabled
conditioning is bitwise the unconditional path, classifier-free
guidance is one doubled forward, inpainting projects after accept and
pins exactly at delivery, and payloads ride the carry through chunks.
Solves are compared with the reference on its own noise (``ReferenceNoise``
replays z and then the projection draw, in the order the reference
splits its key): per-sample nfe/accepted/rejected and iterations exactly
equal, x within the bounds of ``tests/test_torch_adaptive.py``. The
hooks alone are the same fp32 arithmetic: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as jan
from repro.core import guidance as jgd
from repro.core import sde as jsde
from repro_torch.core import analytic as tan
from repro_torch.core import guidance as tgd
from repro_torch.core import sde as tsde
from repro_torch.core.sampling import sample, solve_in_chunks
from repro_torch.core.solvers import adaptive as tad

from test_torch_adaptive import ReferenceNoise, _assert_same_solve, _prior, jad

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
BATCH, DIM = 64, 8
CLASS_MUS = np.linspace(-1.0, 1.0, 10).astype(np.float32)
KW = dict(seed=0, device="cpu", eps_rel=0.05)


def _uncond(sde, **kw):
    return sample(sde, tan.gaussian_score(sde, MU, S0), (BATCH, DIM), **KW, **kw)


def test_default_config_has_no_conditioner():
    assert tad.AdaptiveConfig().conditioner is None
    assert tad.AdaptiveConfig() == tad.AdaptiveConfig(conditioner=None)


def test_cfg_scale_zero_bitwise_equals_unconditional():
    """Scale 0 evaluates the single null-labelled forward and draws no
    projection noise: samples, per-sample NFE and iterations are bitwise
    the unconditional solve."""
    sde = tsde.VPSDE()
    res_u = _uncond(sde)
    conditioner, cond = tgd.class_conditional(torch.arange(BATCH) % 10, 0.0)
    res_c = sample(sde, tan.class_gaussian_score(sde, CLASS_MUS, S0, MU), (BATCH, DIM),
                   **KW, conditioner=conditioner, cond=cond)
    assert torch.equal(res_u.x, res_c.x) and torch.equal(res_u.nfe, res_c.nfe)
    assert int(res_u.iterations) == int(res_c.iterations)


def test_inpaint_mask_none_bitwise_equals_unconditional():
    sde = tsde.VPSDE()
    assert tgd.inpaint(None, None) == (None, None)
    conditioner, cond = tgd.inpaint(None, None)
    res_c = sample(sde, tan.gaussian_score(sde, MU, S0), (BATCH, DIM), **KW,
                   conditioner=conditioner, cond=cond)
    res_u = _uncond(sde)
    assert torch.equal(res_u.x, res_c.x) and torch.equal(res_u.nfe, res_c.nfe)


def test_cfg_single_doubled_forward_layout():
    """One forward over 2B rows, [x; x] with labels [y; null]."""
    calls = []

    def counting_score(x, t, y):
        calls.append((x.shape[0], y.clone()))
        return torch.zeros_like(x)

    cond = {"label": torch.arange(4, dtype=torch.int32)}
    guided = tgd.ClassifierFree(scale=1.5).wrap_score(counting_score, cond)
    guided(torch.ones(4, DIM), torch.full((4,), 0.5))
    assert len(calls) == 1
    b2, y2 = calls[0]
    assert b2 == 8
    assert y2[:4].tolist() == [0, 1, 2, 3] and (y2[4:] < 0).all()


def test_cfg_neutral_cond_and_structs_match_reference():
    """Idle payloads mean *unconditional* (the null label, a zero mask),
    and ``cond_struct`` names the reference's leaves, shapes and dtypes."""
    neutral = tgd.ClassifierFree(scale=1.5).neutral_cond(4, (DIM,))
    assert (neutral["label"] < 0).all()
    zeros = tgd.Inpaint().neutral_cond(4, (3, DIM))
    assert set(zeros) == {"mask", "observed"} and not zeros["mask"].any()
    for jc, tc in ((jgd.ClassifierFree(1.5), tgd.ClassifierFree(1.5)),
                   (jgd.Inpaint(), tgd.Inpaint())):
        want = jc.cond_struct(4, (3, DIM))
        got = tc.cond_struct(4, (3, DIM))
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    assert tgd.Conditioner().cond_struct(4, (DIM,)) is None
    assert tgd.Conditioner().neutral_cond(4, (DIM,)) is None


def test_class_gaussian_oracles_match_reference():
    js, ts = jsde.VPSDE(), tsde.VPSDE()
    x = _prior((6, DIM), seed=2)
    t = np.linspace(0.05, 1.0, 6).astype(np.float32)
    y = np.array([0, 3, -1, 9, 12, -5], np.int32)
    for yy in (y, None):
        want = jan.class_gaussian_score(js, CLASS_MUS, S0, MU)(
            jnp.asarray(x), jnp.asarray(t), None if yy is None else jnp.asarray(yy))
        got = tan.class_gaussian_score(ts, CLASS_MUS, S0, MU)(
            torch.from_numpy(x), torch.from_numpy(t),
            None if yy is None else torch.from_numpy(yy))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        want_n = jan.class_gaussian_noise_pred(js, CLASS_MUS, S0, MU)(
            None, jnp.asarray(x), jnp.asarray(t), None if yy is None else jnp.asarray(yy))
        got_n = tan.class_gaussian_noise_pred(ts, CLASS_MUS, S0, MU)(
            torch.from_numpy(x), torch.from_numpy(t),
            None if yy is None else torch.from_numpy(yy))
        np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-6, atol=1e-6)
    # the null branch is bitwise the unconditional score
    null = tan.class_gaussian_score(ts, CLASS_MUS, S0, MU)(
        torch.from_numpy(x), torch.from_numpy(t), torch.full((6,), -1, dtype=torch.int32))
    plain = tan.gaussian_score(ts, MU, S0)(torch.from_numpy(x), torch.from_numpy(t))
    assert torch.equal(null, plain)


def test_projection_hooks_match_reference():
    js, ts = jsde.VPSDE(), tsde.VPSDE()
    rng = np.random.default_rng(3)
    x, obs, z = (rng.standard_normal((4, 5, 3)).astype(np.float32) for _ in range(3))
    mask = (rng.random((4, 5, 3)) < 0.4).astype(np.float32)
    t = np.array([0.9, 0.5, 0.01, 0.2], np.float32)
    jcond = {"mask": jnp.asarray(mask), "observed": jnp.asarray(obs)}
    tcond = {"mask": torch.from_numpy(mask), "observed": torch.from_numpy(obs)}
    want = jgd.Inpaint().project(js, jnp.asarray(x), jnp.asarray(t), jcond, jnp.asarray(z))
    got = tgd.Inpaint().project(ts, torch.from_numpy(x), torch.from_numpy(t), tcond,
                                torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    pinned = tgd.Inpaint().finalize_project(torch.from_numpy(x), tcond)
    np.testing.assert_array_equal(pinned.numpy(),
                                  np.asarray(jgd.Inpaint().finalize_project(jnp.asarray(x), jcond)))
    np.testing.assert_array_equal(pinned.numpy()[mask == 1], obs[mask == 1])


def _reference_solve(js, jscore, x0, key, jcfg, jcond):
    return jad.adaptive(js, jscore, jnp.asarray(x0), key, config=jcfg, cond=jcond)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("kind", ["cfg", "inpaint"])
def test_conditioned_solve_matches_reference(kind, fused):
    """Whole conditioned solves on the reference's noise take the
    reference's decisions; the projection's own draw comes after z."""
    js, ts = jsde.VPSDE(), tsde.VPSDE()
    x0 = _prior((16, DIM), seed=4)
    key = jax.random.PRNGKey(5)
    if kind == "cfg":
        labels = np.arange(16, dtype=np.int32) % 10
        jc, jcond = jgd.class_conditional(jnp.asarray(labels), 1.5)
        tc, tcond = tgd.class_conditional(torch.from_numpy(labels), 1.5)
        jscore = jan.class_gaussian_score(js, CLASS_MUS, S0, MU)
        tscore = tan.class_gaussian_score(ts, CLASS_MUS, S0, MU)
    else:
        rng = np.random.default_rng(6)
        obs = (MU + S0 * rng.standard_normal((16, DIM))).astype(np.float32)
        mask = np.zeros((16, DIM), np.float32)
        mask[:, : DIM // 2] = 1.0
        jc, jcond = jgd.inpaint(jnp.asarray(mask), jnp.asarray(obs))
        tc, tcond = tgd.inpaint(torch.from_numpy(mask), torch.from_numpy(obs))
        jscore, tscore = jan.gaussian_score(js, MU, S0), tan.gaussian_score(ts, MU, S0)
    want = _reference_solve(js, jscore, x0, key,
                            jad.AdaptiveConfig(eps_rel=0.05, conditioner=jc), jcond)
    got = tad.adaptive(ts, tscore, torch.from_numpy(x0), noise_fn=ReferenceNoise(key),
                       device="cpu", cond=tcond,
                       config=tad.AdaptiveConfig(eps_rel=0.05, conditioner=tc,
                                                 use_fused_kernel=fused))
    _assert_same_solve(got, want)
    if kind == "inpaint":
        np.testing.assert_array_equal(got.x.numpy()[:, : DIM // 2], obs[:, : DIM // 2])


def test_inpaint_exact_observed_and_free_marginals_and_nfe():
    """Observed coordinates are pinned exactly at delivery; the free
    coordinates stay on the analytic marginal (W2 < 0.08, the adaptive
    solver's conformance gate); the NFE overhead is at most 1.1×."""
    sde = tsde.VPSDE()
    res_u = _uncond(sde, denoise=False)
    rng = np.random.default_rng(7)
    observed = torch.from_numpy((MU + S0 * rng.standard_normal((BATCH, DIM))).astype(np.float32))
    mask = torch.zeros(BATCH, DIM)
    mask[:, : DIM // 2] = 1.0
    conditioner, cond = tgd.inpaint(mask, observed)
    res = sample(sde, tan.gaussian_score(sde, MU, S0), (BATCH, DIM), **KW, denoise=False,
                 conditioner=conditioner, cond=cond)
    assert torch.equal(res.x[:, : DIM // 2], observed[:, : DIM // 2])
    mu_a, s_a = tan.gaussian_marginal_moments(sde, MU, S0)
    free = res.x[:, DIM // 2:].double()
    w2 = tan.gaussian_w2(free.mean().item(), free.std(unbiased=False).item(), mu_a, s_a)
    assert w2 < 0.08, w2
    assert float(res.mean_nfe) <= 1.1 * float(res_u.mean_nfe)


def test_cond_batch_mismatch_raises():
    with pytest.raises(ValueError):
        tgd.cond_batch({"a": torch.zeros(4, 2), "b": torch.zeros(5, 2)})
    assert tgd.cond_batch({}) is None
    sde = tsde.VPSDE()
    conditioner, cond = tgd.inpaint(torch.zeros(4, DIM), torch.zeros(4, DIM))
    with pytest.raises(ValueError, match="batch"):
        sample(sde, tan.gaussian_score(sde, MU, S0), (BATCH, DIM), **KW,
               conditioner=conditioner, cond=cond)


def test_chunked_solve_bitwise_with_conditioner():
    """The payload rides the carry, so chunk boundaries cannot perturb a
    conditioned trajectory."""
    sde = tsde.VPSDE()
    mask = torch.zeros(BATCH, DIM)
    mask[:, ::2] = 1.0
    conditioner, cond = tgd.inpaint(mask, torch.full((BATCH, DIM), 0.25))
    kw = dict(seed=0, device="cpu", eps_rel=0.05, conditioner=conditioner, cond=cond)
    score = tan.gaussian_score(sde, MU, S0)
    mono = sample(sde, score, (BATCH, DIM), **kw)
    for horizon in (7, 1):
        chunked = solve_in_chunks(sde, score, (BATCH, DIM), max_sync_iters=horizon, **kw)
        assert torch.equal(mono.x, chunked.x) and torch.equal(mono.nfe, chunked.nfe)
    assert (mono.x[:, ::2] == 0.25).all()


def test_payload_moves_to_the_state_device_as_fp32():
    sde = tsde.VPSDE()
    cond = {"label": torch.arange(3, dtype=torch.int32),
            "mask": torch.ones(3, 2, dtype=torch.float64)}
    carry = tad.init_carry(sde, torch.zeros(3, 2), None, cond=cond)
    assert carry.cond["mask"].dtype == torch.float32
    assert carry.cond["label"].dtype == torch.int32
    stepped = tad._make_body(sde, tan.gaussian_score(sde), tad.AdaptiveConfig(),
                             0.01, tad._step_math_jnp, noise_fn=torch.zeros_like)(carry)
    assert stepped.cond is carry.cond
