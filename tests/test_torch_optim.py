"""Port ↔ reference parity: AdamW, the EMA and the schedules
(``repro_torch.optim``), and the port's mirrors of the reference's
optimiser tests (``tests/test_substrates.py``).

20 ``AdamW.update`` steps on the same gradients, with weight decay,
clipping active and a warmup-cosine schedule, keep the parameters within
1e-6 relative of the reference's. ``global_norm``, the three schedules
and ``ema_*`` agree within 1 ulp (the reference's XLA code may fuse a
multiply-add that torch rounds twice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

torch.set_num_threads(2)

SHAPES = {"a": (8, 5), "b": (5,), "c": (3, 4, 2)}


def _grads(rng, scale):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def test_adamw_steps_match_reference():
    rng = np.random.default_rng(0)
    p0 = _grads(rng, 1.0)
    kw = dict(weight_decay=0.1, clip_norm=1.0)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-2, 4, 20), **kw)
    to = topt.AdamW(lr=topt.warmup_cosine(1e-2, 4, 20), **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    update = jax.jit(jo.update)
    clipped = 0
    for _ in range(20):
        g = _grads(rng, 3.0)  # global norm ≈ 20 > clip: clipping active
        clipped += float(jopt.global_norm(g)) > 1.0
        jp, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    assert clipped == 20 and ts.step == int(js.step) == 20
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-6,
                                   atol=1e-9)


def test_update_is_in_place_on_a_parameter_list():
    """An nn.Module's parameters are updated where they live."""
    lin = torch.nn.Linear(3, 2)
    params = list(lin.parameters())
    before = [p.detach().clone() for p in params]
    opt = topt.AdamW(lr=0.1, weight_decay=0.0)
    state = opt.init(params)
    out, state = opt.update([torch.ones_like(p) for p in params], state, params)
    assert all(a is b for a, b in zip(out, params)) and state.step == 1
    assert all(not torch.equal(a, b) for a, b in zip(before, lin.parameters()))
    assert all(m.dtype == torch.float32 for m in state.mu)


def test_global_norm_within_one_ulp():
    g = _grads(np.random.default_rng(1), 2.0)
    want = np.float32(jopt.global_norm(g))
    got = topt.global_norm({k: torch.from_numpy(v) for k, v in g.items()}).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("warmup_cosine", (1e-3, 10, 100)),
    ("warmup_linear", (1e-3, 10, 100))])
def test_schedules_within_one_ulp(name, args):
    jfn, tfn = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = np.float32(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(step).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        assert torch.equal(tfn(torch.tensor(step)), tfn(step))


def test_ema_within_one_ulp():
    rng = np.random.default_rng(2)
    p = _grads(rng, 1.0)
    je = jopt.ema_init({k: jnp.asarray(v) for k, v in p.items()})
    te = topt.ema_init({k: torch.from_numpy(v) for k, v in p.items()})
    for k in SHAPES:
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    upd = jax.jit(lambda e, q: jopt.ema_update(e, q, 0.995))
    for _ in range(5):  # each update from the reference's EMA: within 1 ulp
        q = _grads(rng, 1.0)
        te = topt.ema_update({k: torch.from_numpy(np.array(v)) for k, v in je.items()},
                             {k: torch.from_numpy(v) for k, v in q.items()}, 0.995)
        je = upd(je, {k: jnp.asarray(v) for k, v in q.items()})
        for k in SHAPES:
            np.testing.assert_array_max_ulp(te[k].numpy(), np.asarray(je[k]), maxulp=1)
    like = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    cast = topt.ema_params(te, like)
    assert all(cast[k].dtype == torch.bfloat16 for k in SHAPES)
    assert torch.equal(cast["a"], te["a"].to(torch.bfloat16))


# mirrors of tests/test_substrates.py


def test_adamw_minimizes_quadratic():
    target = torch.randn(16, generator=torch.Generator().manual_seed(0))
    params = {"w": torch.zeros(16, requires_grad=True)}
    opt = topt.AdamW(lr=0.1, weight_decay=0.0)
    state = opt.init(params)
    for _ in range(200):
        loss = torch.sum((params["w"] - target) ** 2)
        (g,) = torch.autograd.grad(loss, [params["w"]])
        params, state = opt.update({"w": g}, state, params)
    np.testing.assert_allclose(params["w"].detach().numpy(), target.numpy(), atol=0.05)


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = topt.AdamW(lr=1.0, clip_norm=1e-3, weight_decay=0.0)
    state = opt.init(params)
    huge = {"w": torch.full((4,), 1e9)}
    p2, state = opt.update(huge, state, params)
    # the moments were fed the clipped gradient: its norm is the clip
    first_moment = state.mu["w"] / (1 - opt.b1)
    assert float(topt.global_norm({"w": first_moment})) <= 1e-3 * 1.01
    assert bool(torch.isfinite(p2["w"]).all())


def test_warmup_cosine_shape():
    sched = topt.warmup_cosine(1.0, 10, 100)
    assert float(sched(0)) == pytest.approx(0.0)
    assert float(sched(10)) == pytest.approx(1.0, rel=1e-3)
    assert float(sched(100)) == pytest.approx(0.1, rel=1e-2)
    vals = [float(sched(s)) for s in range(10, 100, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_ema_converges_to_constant():
    ema = topt.ema_init({"w": torch.zeros(4)})
    target = {"w": torch.ones(4)}
    for _ in range(2000):
        ema = topt.ema_update(ema, target, decay=0.99)
    np.testing.assert_allclose(ema["w"].numpy(), 1.0, atol=1e-5)


def test_update_in_chunks_gives_the_same_bits(monkeypatch):
    """A leaf larger than ``CHUNK`` is updated a chunk at a time (the
    moments in place): the same parameters and moments as in one pass
    (elementwise arithmetic either way; no clipping, whose norm sums the
    chunks in another grouping); a non-contiguous leaf takes one pass.
    The chunked global norm within 1e-6 relative of the one-pass norm."""
    from repro_torch.optim import adamw

    shapes = {"big": (7, 11), "small": (3,), "t": (6, 5)}

    def run():
        params = {k: torch.randn(s, generator=torch.Generator().manual_seed(1))
                  for k, s in shapes.items()}
        params["t"] = params["t"].T  # non-contiguous
        opt = topt.AdamW(lr=topt.warmup_cosine(1e-2, 2, 10), clip_norm=None)
        state = opt.init(params)
        for step in range(3):
            grads = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(step))
                     for k, p in params.items()}
            params, state = opt.update(grads, state, params)
        return params, state, topt.global_norm(params)

    want = run()
    monkeypatch.setattr(adamw, "CHUNK", 10)
    got = run()
    for a, b in ((got[0], want[0]), (got[1].mu, want[1].mu), (got[1].nu, want[1].nu)):
        assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert abs(float(got[2]) - float(want[2])) <= 1e-6 * float(want[2])
