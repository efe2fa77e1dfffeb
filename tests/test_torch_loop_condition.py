"""The WHILE-node driver's per-unit condition (P2, ``kernels.graph_loop``)
against the reference's nested loop conditions, on the CPU.

The reference keeps every loop on the device: ``solve_chunk``'s
``lax.while_loop`` checks ``any(t > t_eps + 1e-12) ∧ iterations − start <
max_sync_iters ∧ iterations < max_iters`` after every iteration
(``repro/core/solvers/adaptive.py:640-646``) and ``solve_horizons``' outer
loop ``running ∧ ¬event ∧ n < max_horizons`` after every chunk
(``:709-716``). The port's driver runs one unit (an iteration, an RK45
attempt, an Algorithm-2 step) and P2 after each; on the CPU the plain
driver (``graph_loop.ref.solve_horizons``) runs the same loop. So:

(a) ``ref.horizon_cond`` (and the wrapper on CPU tensors) is a direct
    transcription of the two conditions, drawn by hypothesis over
    done/occupied patterns (idle slots included), units run, horizon
    length, horizons, iterations and budgets;
(b) a graphed Algorithm-1 solve (the one-shot rule's second ``sample``)
    calls its score exactly 2·iterations + 1 times for adaptive,
    momentum, Heun, CFG and inpainting, bitwise the host-driven chain
    (the first call), which runs whole groups of ``SYNC_EVERY``;
(c) the graphed RK45 stops at the reference's attempt count (6 calls an
    attempt + 2) and Algorithm 2 at its own step count;
(d) the device-resident plain serve at sync horizon 4 delivers, admits
    and counts horizons as the previous driver (one ``solve_chunk`` of
    the horizon a unit) did, and its score calls stop at the last live
    iteration.

Tolerances: bitwise where the port is compared with itself; the RK45's
attempt count exactly the reference's (x is held to the reference in
``test_torch_baselines.py``).
"""

import importlib

import jax.numpy as jnp
import jax.random
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import analytic as jan
from repro.core import sde as jsde
from repro.core.solvers.adaptive import events_pending as jevents
from repro_torch.core import ForwardAdaptiveConfig, adaptive_forward
from repro_torch.core import analytic as tan
from repro_torch.core import sde as tsde
from repro_torch.core.guidance import class_conditional, inpaint
from repro_torch.core.sampling import sample
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers import get_solver
from repro_torch.core.streams import SlotStreams
from repro_torch.kernels.graph_loop import ops as loop_ops
from repro_torch.kernels.graph_loop import ref as loop_ref
from repro_torch.launch.sample import make_sample_step
from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

jsolvers = importlib.import_module("repro.core.solvers")

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
T_EPS = tsde.VPSDE().t_eps
THRESHOLD = T_EPS + 1e-12


@pytest.fixture(autouse=True)
def _empty_cache():
    ad.clear_graph_cache()
    yield
    ad.clear_graph_cache()


# --------------------------------------------------------------------------
# (a) P2 is the reference's two conditions
# --------------------------------------------------------------------------

class _Carry:  # the field the reference's events_pending reads
    def __init__(self, done):
        self.done = jnp.asarray(done)


def reference_next(t, occupied, iterations, start, n, *, sync_horizon, max_iters,
                   max_horizons, wait_all, entering):
    """Where the reference's nested loops go next from a carry with times
    ``t``: (another body iteration runs, the outer loop's n, iterations −
    start of the chunk it runs in). ``entering``: ``solve_horizons`` is
    about to evaluate its condition for the first time; else a body
    iteration of the chunk that began at ``start`` just ran."""
    done = t <= THRESHOLD  # the carry's done leaf

    def chunk_cond(start):  # adaptive.py:640-646
        return bool(np.any(t > THRESHOLD) & (iterations - start < sync_horizon)
                    & (iterations < max_iters))

    def horizons_cond(n):  # adaptive.py:709-716
        running = np.any(occupied & ~done)
        no_event = not bool(jevents(_Carry(done), jnp.asarray(occupied), wait_all=wait_all))
        return bool(running & no_event & (n < max_horizons))

    if not entering:
        if chunk_cond(start):
            return True, n, iterations - start
        n += 1  # the chunk's while_loop is over: the outer body returns n + 1
    while horizons_cond(n):
        if chunk_cond(iterations):  # a new solve_chunk starts at the carry's count
            return True, n, 0
        n += 1  # an empty chunk
    return False, n, 0


@st.composite
def p2_cases(draw):
    b = draw(st.integers(1, 6))
    # t per row: converged (t_eps), running (T) or an idle slot (t = 0)
    t = np.array(draw(st.lists(st.sampled_from([T_EPS, 1.0, 0.0]), min_size=b, max_size=b)),
                 np.float32)
    occupied = np.array(draw(st.lists(st.booleans(), min_size=b, max_size=b)))
    occupied &= t != 0.0  # an idle slot is never occupied
    horizon = draw(st.integers(1, 5))
    max_horizons = draw(st.integers(1, 5))
    entering = draw(st.booleans())
    units = 0 if entering else draw(st.integers(1, horizon))  # run in this chunk
    iterations = draw(st.integers(units, 14))
    n = 0 if entering else draw(st.integers(0, max_horizons - 1))
    return dict(t=t, occupied=occupied, horizon=horizon, max_horizons=max_horizons,
                entering=entering, units=units, iterations=iterations, n=n,
                max_iters=draw(st.integers(0, 14)), wait_all=draw(st.booleans()),
                total=0 if entering else draw(st.integers(units - 1, 40)))


@settings(max_examples=300, deadline=None)
@given(p2_cases())
def test_horizon_cond_is_the_reference_conditions(case):
    c = case
    go_want, n_want, u_want = reference_next(
        c["t"], c["occupied"], c["iterations"], c["iterations"] - c["units"], c["n"],
        sync_horizon=c["horizon"], max_iters=c["max_iters"], max_horizons=c["max_horizons"],
        wait_all=c["wait_all"], entering=c["entering"])
    done = torch.from_numpy(c["t"] <= THRESHOLD)
    occ = torch.from_numpy(c["occupied"])
    event = bool(jevents(_Carry(done.numpy()), jnp.asarray(c["occupied"]),
                         wait_all=c["wait_all"]))
    its = torch.tensor(c["iterations"], dtype=torch.int32)
    kw = dict(wait_all=c["wait_all"], horizon=c["horizon"], max_iters=c["max_iters"],
              max_horizons=c["max_horizons"], first=c["entering"])
    # the state P2 left after the units before: u counts them less the one just run
    before = [0, c["n"], c["units"] - 1, c["total"]] if not c["entering"] else [7, 9, 9, 9]
    plain = torch.tensor(before, dtype=torch.int32)
    go = loop_ref.horizon_cond(occ, done, its, plain, **kw)
    wrapped = torch.tensor(before, dtype=torch.int32)
    loop_ops.horizon_cond(occ, done, its, wrapped, **kw)
    units_want = 0 if c["entering"] else c["total"] + 1
    assert go == go_want
    assert plain.tolist() == [int(event), n_want, u_want, units_want]
    assert torch.equal(wrapped, plain)


def test_horizon_cond_refuses_a_short_state():
    o = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="4 int32"):
        loop_ops.horizon_cond(o, ~o, torch.zeros((), dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32), wait_all=False, horizon=1,
                              max_iters=1, max_horizons=1, first=True)


# --------------------------------------------------------------------------
# (b) a graphed Algorithm-1 solve runs exactly the reference's iterations
# --------------------------------------------------------------------------

def _counted(fn, calls):
    def score(*a):
        calls.append(a[0].shape[0])
        return fn(*a)

    return score


def _family(kind, sde, calls):
    """(score, sample keywords) of one Algorithm-1 family on the closed-form
    Gaussian score, B = 6, D = 5."""
    inner = tan.gaussian_score(sde, MU, S0)
    base = ad.AdaptiveConfig(eps_rel=0.05)
    if kind == "cfg":
        labels = np.arange(6) % 3
        conditioner, cond = class_conditional(labels, 1.5)

        def labelled(x, t, y):
            return inner(x, t) + 0.05 * (y.to(torch.float32) + 1.0)[:, None]

        return _counted(labelled, calls), dict(
            config=ad.AdaptiveConfig(eps_rel=0.05, conditioner=conditioner), cond=cond)
    if kind == "inpaint":
        mask = (np.arange(30).reshape(6, 5) % 2).astype(np.float32)
        conditioner, cond = inpaint(mask, np.full((6, 5), 0.2, np.float32))
        return _counted(inner, calls), dict(
            config=ad.AdaptiveConfig(eps_rel=0.05, conditioner=conditioner), cond=cond)
    return _counted(inner, calls), dict(method=kind, config=base)


@pytest.mark.parametrize("kind", ["adaptive", "momentum", "heun", "cfg", "inpaint"])
def test_graphed_solve_calls_the_score_two_an_iteration(kind):
    sde = tsde.VPSDE()
    calls = []
    score, kw = _family(kind, sde, calls)
    runs = []
    for _ in range(2):  # the key's first solve host-driven, the second graphed
        del calls[:]
        res = sample(sde, score, (6, 5), seed=4, device="cpu", **kw)
        runs.append((res, len(calls)))
    (host, host_calls), (graphed, graphed_calls) = runs
    assert len(ad._drivers) == 1
    its = int(graphed.iterations)
    assert its > ad.SYNC_EVERY
    assert graphed_calls == 2 * its + 1
    # the host-driven chain runs whole groups of SYNC_EVERY
    assert host_calls == 2 * ad.SYNC_EVERY * -(-its // ad.SYNC_EVERY) + 1
    for f in ("x", "nfe", "accepted", "rejected", "iterations"):
        assert torch.equal(getattr(graphed, f), getattr(host, f)), f
    if kind == "inpaint":
        m = kw["cond"]["mask"] > 0
        assert torch.equal(graphed.x[m], kw["cond"]["observed"][m])


# --------------------------------------------------------------------------
# (c) the RK45 and Algorithm 2
# --------------------------------------------------------------------------

def test_graphed_rk45_stops_at_the_reference_attempts():
    js, ts = jsde.VPSDE(), tsde.VPSDE()
    x0 = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    # Table 1's tolerances: more attempts than a host-driven group holds
    want = jsolvers.probability_flow_rk45(js, jan.gaussian_score(js), jnp.asarray(x0),
                                          jax.random.PRNGKey(3), rtol=1e-5, atol=1e-5)
    attempts = int(want.iterations)
    calls = []
    score = _counted(tan.gaussian_score(ts), calls)
    runs = []
    for _ in range(2):  # host-driven, then graphed (the one-shot rule)
        del calls[:]
        res = get_solver("ode")(ts, score, torch.from_numpy(x0), device="cpu", rtol=1e-5,
                                atol=1e-5)
        runs.append((res, len(calls)))
    (host, host_calls), (graphed, graphed_calls) = runs
    assert len(ad._drivers) == 1
    assert int(graphed.iterations) == attempts > ad.SYNC_EVERY
    np.testing.assert_array_equal(graphed.nfe.numpy(), np.asarray(want.nfe))
    assert graphed_calls == 6 * attempts + 2  # the FSAL seed and the denoise
    assert host_calls == 6 * ad.SYNC_EVERY * -(-attempts // ad.SYNC_EVERY) + 2
    for f in ("x", "nfe", "iterations"):
        assert torch.equal(getattr(graphed, f), getattr(host, f)), f


def test_graphed_algorithm2_stops_at_its_steps():
    calls = []
    drift = _counted(lambda x, t: 0.05 * x, calls)
    diffusion = lambda x, t: 0.2 * x
    streams = SlotStreams.of(list(range(64)), 0, device="cpu")
    cfg = ForwardAdaptiveConfig(eps_abs=1e-3, eps_rel=0.02, h_init=0.1)
    runs = []
    for _ in range(3):  # host-driven, captured (the plain driver's build), replayed
        del calls[:]
        res = adaptive_forward(drift, diffusion, torch.ones(64, 2), 0.0, 1.0, streams,
                               config=cfg, device="cpu")
        runs.append((res, len(calls)))
    host, host_calls = runs[0]
    steps = int(host.iterations)
    assert steps > ad.SYNC_EVERY and steps % ad.SYNC_EVERY
    assert host_calls == 2 * ad.SYNC_EVERY * -(-steps // ad.SYNC_EVERY)
    for res, n in runs[1:]:
        assert n == 2 * steps  # two drift evaluations a step
        for f in ("x", "nfe", "accepted", "rejected", "iterations"):
            assert torch.equal(getattr(res, f), getattr(host, f)), f


# --------------------------------------------------------------------------
# (d) the device-resident plain serve
# --------------------------------------------------------------------------

def _server(sde, cfg, calls, *, whole_chunks, compaction):
    fwd = tan.gaussian_noise_pred(sde, MU, S0)
    step = make_sample_step(sde, cfg, forward_fn=lambda p, x, t: calls.append(1) or fwd(x, t))
    if whole_chunks:
        # the driver before the per-unit condition: one solve_chunk of the
        # sync horizon a unit, one unit a horizon
        step.horizon_unit = lambda params, h, device, sharding=None, flags=None: (
            (lambda c: step(params, c, max_sync_iters=h)), 1)
    return DiffusionBatcher(sde, step, None, (4,), slots=4, cfg=cfg, sync_horizon=4,
                            compaction=compaction, device_resident=True, device="cpu")


@pytest.mark.parametrize("compaction", [True, False], ids=["compaction", "monolithic"])
def test_device_resident_serve_stops_at_the_last_live_iteration(compaction):
    sde = tsde.VPSDE()
    cfg = ad.AdaptiveConfig(eps_rel=0.05)
    runs = {}
    for whole in (True, False):
        calls = []
        b = _server(sde, cfg, calls, whole_chunks=whole, compaction=compaction)
        for u in range(10):
            b.submit(ImageRequest(uid=u, seed=100 + u))
        done = b.run_to_completion()
        runs[whole] = (b, done, len(calls))
    (old, old_done, old_calls), (new, new_done, new_calls) = runs[True], runs[False]
    assert list(new_done) == list(old_done) and len(new_done) == 10  # delivery order
    for u in old_done:
        assert np.array_equal(new_done[u].result, old_done[u].result), u
        for f in ("nfe", "accepted", "rejected", "resident_iters"):
            assert getattr(new_done[u], f) == getattr(old_done[u], f), (u, f)
    for f in ("event_visits", "admission_visits", "device_horizons", "horizon_windows",
              "refills_per_device", "total_iterations", "host_transfers"):
        assert getattr(new, f) == getattr(old, f), f
    # a unit an iteration with a sample active; the previous driver ran
    # every horizon's four iterations
    assert new.device_units == new.total_iterations
    assert new_calls == 2 * new.total_iterations
    assert old_calls == 2 * 4 * old.device_horizons > new_calls
    # the carry's done leaf is the reference's predicate on every row,
    # the retired (idle) slots included
    c = new._carry
    assert torch.equal(c.done, c.t <= THRESHOLD)
