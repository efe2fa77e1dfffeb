"""The device-resident serve loop (DESIGN.md §12) of the port's
``DiffusionBatcher``, on the CPU, where its driver is the plain loop
(``kernels.graph_loop.ref``); mirrors ``tests/test_device_serving.py``.

  * **bit-identity** with the host-driven loop, compaction on and off and
    with per-request inpainting payloads: samples, per-request NFE,
    iterations and waste are equal, since each slot's ``SlotStreams`` row
    makes a trajectory independent of where and when the host decides.
  * **O(events) host traffic**: the serve loop's device→host reads
    (``host_transfers``, every one through ``_d2h``) are ≥ 5× fewer than
    the host-driven loop's at sync horizon 2 and fewer at 8, and barely
    move as the horizon shrinks 8× while the host-driven count explodes.
  * **the counterpart of donation**: the driver writes the carry's
    buffers in place (``x.data_ptr()`` is the same before and after a
    step), which on the card is what lets a captured graph read them.
  * **parity with the reference's device-resident server** on its
    replayed per-request draws (``request_streams``): delivery order,
    per-request nfe, accepted and rejected, ``total_iterations`` and
    ``host_transfers`` exactly; x within rtol 1e-4 and an absolute 1e-5
    of the largest |x| (``_assert_same_serve``).
  * ``events_pending`` and ``solve_horizons`` against the reference's,
    and P2's plain version on hand-built masks.

The card's driver (the WHILE-node graph) is held to the same gates in
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 6c.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdaptiveConfig as JCfg
from repro.core.solvers.adaptive import events_pending as jevents
from repro.core.solvers.adaptive import init_carry as jinit_carry
from repro.core.solvers.adaptive import solve_horizons as jsolve_horizons
from repro.serving.diffusion_server import DiffusionBatcher as JBatcher
from repro.serving.diffusion_server import ImageRequest as JRequest
from repro_torch.core import analytic as tan
from repro_torch.core.guidance import Inpaint
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.core.solvers.base import SlotStreams
from repro_torch.kernels.graph_loop import ops as loop_ops
from repro_torch.kernels.graph_loop import ref as loop_ref
from repro_torch.launch.sample import make_sample_step
from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

from test_torch_diffusion_server import (
    D, MU, S0, FakeClock, ReferenceStreams, _assert_same_serve, _reference_step, _port_step,
)

torch.set_num_threads(2)

SLOTS = 4
N_REQ = 12


@pytest.fixture(scope="module")
def parts():
    cfg = AdaptiveConfig(eps_rel=0.05)
    sde, step = _port_step(cfg)
    return sde, cfg, step


def _run(parts, *, n_req=N_REQ, cond_for=None, cfg=None, step=None, **kw):
    sde, cfg0, step0 = parts
    b = DiffusionBatcher(sde, step or step0, None, (D,), slots=SLOTS, cfg=cfg or cfg0,
                         device="cpu", **kw)
    for uid in range(n_req):
        b.submit(ImageRequest(uid=uid, seed=uid, cond=cond_for(uid) if cond_for else None))
    done = b.run_to_completion()
    assert len(done) == n_req
    return b, np.stack([done[u].result for u in range(n_req)]), done


# --------------------------------------------------------------------------
# bit-identity with the host-driven loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compaction", [True, False], ids=["compaction", "monolithic"])
def test_device_resident_bitwise_matches_host_driven(parts, compaction):
    kw = dict(sync_horizon=4, compaction=compaction)
    b_host, x_host, done_h = _run(parts, **kw)
    b_dev, x_dev, done_d = _run(parts, device_resident=True, **kw)
    np.testing.assert_array_equal(x_host, x_dev)
    assert list(done_h) == list(done_d)  # delivery order
    assert b_host.total_iterations == b_dev.total_iterations
    for u in range(N_REQ):
        for name in ("nfe", "accepted", "rejected", "resident_iters"):
            assert getattr(done_h[u], name) == getattr(done_d[u], name), (u, name)
    assert b_host.wasted_nfe_fraction == b_dev.wasted_nfe_fraction
    assert b_host.passenger_nfe_fraction == b_dev.passenger_nfe_fraction
    assert b_dev.graph_captures == 0  # the plain driver captures nothing


def test_device_resident_conditioned_bitwise(parts):
    """Per-request inpainting payloads survive the in-place event update:
    each delivery honours its own observation exactly."""
    sde = parts[0]
    ccfg = AdaptiveConfig(eps_rel=0.05, conditioner=Inpaint())
    fwd = tan.gaussian_noise_pred(sde, MU, S0)
    step = make_sample_step(sde, ccfg, forward_fn=lambda p, x, t: fwd(x, t))

    def cond_for(uid):
        mask = (np.arange(D) % 2 == uid % 2).astype(np.float32)
        return {"mask": mask, "observed": np.full(D, 0.1 + 0.05 * uid, np.float32)}

    _, x_host, _ = _run(parts, cond_for=cond_for, cfg=ccfg, step=step, sync_horizon=4)
    b, x_dev, _ = _run(parts, cond_for=cond_for, cfg=ccfg, step=step, sync_horizon=4,
                       device_resident=True)
    np.testing.assert_array_equal(x_host, x_dev)
    for uid in range(N_REQ):
        c = cond_for(uid)
        obs = c["mask"] == 1.0
        np.testing.assert_array_equal(x_dev[uid][obs], c["observed"][obs])
    # a projecting conditioner draws twice an iteration: the counters
    # moved two a live iteration past the last admission's 1
    assert (b._carry.generator.counter % 2 == 1).all()


# --------------------------------------------------------------------------
# host traffic: O(events), not O(horizons)
# --------------------------------------------------------------------------

def test_host_transfer_reduction_at_small_horizons(parts):
    for horizon in (2, 8):
        b_host, _, _ = _run(parts, sync_horizon=horizon)
        b_dev, _, _ = _run(parts, sync_horizon=horizon, device_resident=True)
        if horizon == 2:
            assert b_host.host_transfers >= 5 * b_dev.host_transfers, \
                (horizon, b_host.host_transfers, b_dev.host_transfers)
        else:
            assert b_host.host_transfers > b_dev.host_transfers
        # each read is a window's flag or one of an event's two pulls
        assert b_dev.host_transfers <= b_dev.horizon_windows + 2 * N_REQ + 1


def test_device_resident_transfers_scale_with_events_not_horizons():
    """The reference's workload (12 requests of D 32 on 4 slots) on the
    reference's own draws, replayed through ``request_streams``: shrinking
    the horizon 8× multiplies the host-driven reads and barely moves the
    device-resident ones, whose count the deliveries set. On these draws
    the counts are the reference's own (``test_parity_with_reference_
    device_resident``); the ratio is a property of when the draws make
    the samples converge, so the test holds the port to the reference's
    draws rather than to another workload."""
    js, _ = _reference_step(JCfg(eps_rel=0.05))
    ts, step = _port_step(AdaptiveConfig(eps_rel=0.05))

    def reads(horizon, dr):
        b = DiffusionBatcher(ts, step, None, (D,), slots=SLOTS, cfg=AdaptiveConfig(eps_rel=0.05),
                             sync_horizon=horizon, device_resident=dr, device="cpu",
                             request_streams=ReferenceStreams(js))
        for uid in range(N_REQ):
            b.submit(ImageRequest(uid=uid, seed=uid))
        assert len(b.run_to_completion()) == N_REQ
        return b.host_transfers

    assert reads(1, False) >= 3 * reads(8, False)
    assert reads(1, True) <= 2 * reads(8, True)


# --------------------------------------------------------------------------
# the carry stays where it is
# --------------------------------------------------------------------------

def test_driver_keeps_carry_buffers(parts):
    """The counterpart of the reference's donation: a window and an event
    update write the carry's buffers in place, so the hot loop keeps one
    resident copy of the state (and a captured graph its addresses)."""
    sde, cfg, step = parts
    b = DiffusionBatcher(sde, step, None, (D,), slots=SLOTS, cfg=cfg, sync_horizon=4,
                         device_resident=True, device="cpu")
    for uid in range(SLOTS + 2):
        b.submit(ImageRequest(uid=uid, seed=uid))
    ptrs = [t.data_ptr() for t in ad._tensor_leaves(b._carry)]
    for _ in range(100):
        if b.step() == 0:
            break
        assert [t.data_ptr() for t in ad._tensor_leaves(b._carry)] == ptrs
    b.run_to_completion()
    assert len(b.finished) == SLOTS + 2


# --------------------------------------------------------------------------
# parity with the reference's device-resident server
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(sync_horizon=4),
    dict(sync_horizon=2, compaction=False),
    dict(sync_horizon=4, tolerance_classes=True),
], ids=["h4", "h2-nocompact", "h4-mixed"])
def test_parity_with_reference_device_resident(kw):
    js, jstep = _reference_step(JCfg(eps_rel=0.05))
    ts, tstep = _port_step(AdaptiveConfig(eps_rel=0.05))
    tiers = (["draft", "high_fidelity", None, "standard"] * 3)[:10] \
        if kw.get("tolerance_classes") else [None] * 10
    jb = JBatcher(js, jstep, None, (D,), slots=SLOTS, cfg=JCfg(eps_rel=0.05),
                  clock=FakeClock(), device_resident=True, **kw)
    tb = DiffusionBatcher(ts, tstep, None, (D,), slots=SLOTS, cfg=AdaptiveConfig(eps_rel=0.05),
                          clock=FakeClock(), device_resident=True, device="cpu",
                          request_streams=ReferenceStreams(js), **kw)
    for u, t in enumerate(tiers):
        jb.submit(JRequest(uid=u, seed=2000 + u, tier=t))
        tb.submit(ImageRequest(uid=u, seed=2000 + u, tier=t))
    jdone, tdone = jb.run_to_completion(), tb.run_to_completion()
    assert len(tdone) == len(tiers)
    _assert_same_serve(jb, jdone, tb, tdone)
    assert tb.horizon_windows == jb.horizon_windows


# --------------------------------------------------------------------------
# events_pending, solve_horizons and P2's plain version
# --------------------------------------------------------------------------

MASKS = [  # (occupied, done)
    ([1, 1, 0, 1], [0, 0, 1, 0]),
    ([1, 1, 0, 1], [1, 0, 1, 0]),
    ([1, 1, 0, 1], [1, 1, 1, 1]),
    ([0, 0, 0, 0], [1, 1, 1, 1]),
    ([1, 0, 0, 0], [0, 1, 1, 1]),
]


@pytest.mark.parametrize("wait_all", [False, True], ids=["compaction", "wait_all"])
@pytest.mark.parametrize("occ,done", MASKS, ids=str)
def test_events_pending_and_horizon_cond_match_reference(occ, done, wait_all):
    o, d = torch.tensor(occ, dtype=torch.bool), torch.tensor(done, dtype=torch.bool)

    class _C:  # the field the reference's events_pending reads
        pass

    jc = _C()
    jc.done = jnp.asarray(done, bool)
    want = bool(jevents(jc, jnp.asarray(occ, bool), wait_all=wait_all))
    assert bool(ad.events_pending(d, o, wait_all=wait_all)) == want
    # one unit a horizon (a mesh's or a grid's driver): P2 after a unit
    # ends the horizon and decides on solve_horizons' condition alone
    state = torch.zeros(4, dtype=torch.int32)
    its = torch.zeros((), dtype=torch.int32)
    running = any(a and not b for a, b in zip(occ, done))
    kw = dict(wait_all=wait_all, horizon=1, max_iters=100, max_horizons=2)
    for first, n in ((True, 0), (False, 1), (False, 2)):
        before = state.clone()
        loop_ops.horizon_cond(o, d, its, state, first=first, **kw)
        assert state.tolist() == [int(want), n, 0, n]
        go = loop_ref.horizon_cond(o, d, its, before, first=first, **kw)
        assert go == (running and not want and n < 2)


@pytest.mark.parametrize("wait_all", [False, True], ids=["compaction", "wait_all"])
def test_solve_horizons_matches_reference(wait_all):
    """One call of the multi-horizon driver on four requests at different
    tolerances (so they converge at different iterations), on the
    reference's per-slot draws: the same carry decisions and event flag as
    the reference's ``solve_horizons``; then the same call equals chained
    ``solve_chunk`` horizons, bit for bit, in the port's own streams."""
    js, _ = _reference_step(JCfg(eps_rel=0.05))
    ts, _ = _port_step(AdaptiveConfig(eps_rel=0.05))
    from repro.core import analytic as jan

    jfwd = jan.gaussian_noise_pred(js, MU, S0)
    tfwd = tan.gaussian_noise_pred(ts, MU, S0)

    def jscore(x, t):
        _, std = js.marginal(t)
        return -jfwd(None, x, t) / std[:, None]

    def tscore(x, t):
        _, std = ts.marginal(t)
        return -tfwd(x, t).to(torch.float32) / std[:, None]

    B, H, n_h = 4, 3, 40
    rtol = np.array([0.5, 0.2, 0.05, 0.01], np.float32)
    atol = np.full(B, ts.abs_tolerance, np.float32)
    keys = [jax.random.split(jax.random.PRNGKey(s)) for s in range(B)]
    x0 = np.stack([np.array(js.prior_sample(k[0], (D,))) for k in keys])
    occupied = np.array([1, 1, 1, 0], bool)
    jc = jinit_carry(js, jnp.asarray(x0), jnp.stack([k[1] for k in keys]),
                        config=JCfg(eps_rel=0.05), atol=atol, rtol=rtol)
    jc, jev = jsolve_horizons(js, jscore, jc, jnp.asarray(occupied), sync_horizon=H,
                                 max_horizons=n_h, config=JCfg(eps_rel=0.05),
                                 wait_all=wait_all)
    streams = ReferenceStreams(js)
    sources = [streams(ImageRequest(uid=s, seed=s), (D,), "cpu")[1] for s in range(B)]
    tc = ad.init_carry(ts, torch.from_numpy(x0), sources, config=AdaptiveConfig(eps_rel=0.05),
                       atol=atol, rtol=rtol)
    tc, tev = ad.solve_horizons(ts, tscore, tc, torch.from_numpy(occupied), sync_horizon=H,
                                max_horizons=n_h, config=AdaptiveConfig(eps_rel=0.05),
                                wait_all=wait_all)
    assert bool(tev) == bool(jev)
    for name in ("nfe", "accepted", "rejected", "done", "iterations"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tc.x.numpy(), np.asarray(jc.x), rtol=1e-4, atol=1e-5)

    # the driver is chained solve_chunk horizons, in the port's own streams
    st = SlotStreams.of(list(range(B)), 0, "cpu")
    xs = ts.prior_sample((B, D), st)
    cfg = AdaptiveConfig(eps_rel=0.05)
    # solve_horizons writes the carry in place, x_init included (the
    # reference donates it), so each run starts from its own copy
    mk = lambda: ad.init_carry(ts, xs.clone(), SlotStreams.of(list(range(B)), 1, "cpu"), config=cfg,
                               atol=atol, rtol=rtol)
    occ = torch.from_numpy(occupied)
    a, ev = ad.solve_horizons(ts, tscore, mk(), occ, sync_horizon=H, max_horizons=n_h,
                              config=cfg, wait_all=wait_all)
    b = mk()
    while not bool(ad.events_pending(b.done, occ, wait_all=wait_all)) \
            and bool((occ & ~b.done).any()):
        b = ad.solve_chunk(ts, tscore, b, max_sync_iters=H, config=cfg)
    for x, y in zip(ad._tensor_leaves(a), ad._tensor_leaves(b)):
        assert torch.equal(x, y)
    assert bool(ev)
