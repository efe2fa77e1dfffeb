"""Port ↔ reference parity: the continuous-batching diffusion server
(``repro_torch.serving.diffusion_server``), its tolerance tiers and its
launcher (``repro_torch.launch.serve.serve_diffusion``).

Three groups:

  * **parity**: the reference's ``DiffusionBatcher`` and the port's serve
    the same requests. JAX's threefry and torch's generators never give
    the same numbers, so the port is handed the reference's own
    per-request streams through its ``request_streams`` seam:
    ``ReferenceStreams`` draws each request's prior from
    ``split(PRNGKey(seed))[0]`` and replays the key threading of the
    reference's per-slot ``_draw_noise`` (one ``split`` a draw, z from the
    second key) from ``split(PRNGKey(seed))[1]``, as the reference's
    ``_sync`` admits. With equal noise the two servers must take the same
    decisions: per request ``nfe``, ``accepted`` and ``rejected`` exactly
    equal, the same delivery order, the same iterations, host transfers,
    ``wasted_nfe_fraction`` and (a shared fake clock) ``class_stats``.
    Samples agree within rtol 1e-4 and an absolute 1e-5 of the largest
    |x| (the step math is the same fp32 arithmetic with reductions in
    another order, compounded over a trajectory, as in
    ``test_torch_adaptive.py``).
  * **mirrors** of ``tests/test_diffusion_server.py`` (all six) and of
    ``tests/test_tolerance_tiers.py`` (four: the retrace test has no
    eager counterpart, since the port compiles nothing to retrace; the
    device-resident rows are in ``test_torch_device_serving.py``), in
    the port's own RNG (``SlotStreams``): bitwise scheduling invariance,
    solo ≡ served.
  * **launcher**: ``serve_diffusion`` on the CPU returns the reference's
    record keys, ``--tier mixed`` gives per-class stats, the
    device-resident mode runs and a mesh that does not divide the slots
    raises.

The closed-form Gaussian score stands in for the net (as in the
reference's tests) except in one parity case through a small livened DiT.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdaptiveConfig as JCfg
from repro.core import VPSDE as JVPSDE
from repro.core import analytic as jan
from repro.core.guidance import ClassifierFree as JCF
from repro.core.guidance import Inpaint as JInpaint
from repro.launch.sample import make_sample_step as jmake_step
from repro.models import dit as jdit
from repro.serving.diffusion_server import DiffusionBatcher as JBatcher
from repro.serving.diffusion_server import ImageRequest as JRequest
from repro_torch.configs.diffusion import TOLERANCE_CLASSES, ToleranceClass
from repro_torch.core import analytic as tan
from repro_torch.core.guidance import ClassifierFree, Inpaint
from repro_torch.core.sde import VPSDE
from repro_torch.core.solvers.adaptive import AdaptiveConfig, adaptive
from repro_torch.core.solvers.base import SlotStreams
from repro_torch.launch import serve as tserve
from repro_torch.launch.sample import make_sample_step
from repro_torch.models import dit as tdit
from repro_torch.parallel import Mesh
from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

from test_torch_dit import liven

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
D = 32
CLASS_MUS = (-1.0, 0.5, 2.0)
#: one wave mixing every preset with tier-less (default-class) requests
WAVE = ["draft", "high_fidelity", None, "standard", "draft", None,
        "high_fidelity", "draft", "standard", None]
#: the keys of the reference's ``serve_diffusion`` record
#: (``repro/launch/serve.py``)
REF_RECORD_KEYS = {
    "devices", "slots", "slots_per_device", "sync_horizon", "compaction",
    "precision", "conditioner", "completed", "samples_per_sec", "mean_nfe",
    "total_iterations", "wasted_nfe_fraction", "refills_per_device",
    "device_resident", "host_transfers", "host_transfers_per_request", "tier",
    "deadline_ms", "class_stats", "telemetry", "metrics_out", "trace_out",
}
#: an untyped stand-in for the reference's net config: the analytic
#: forward ignores it
JNET = jdit.DiTConfig(image_size=4, patch=4, d_model=8, num_layers=1,
                      num_heads=1, d_ff=8)


@functools.partial(jax.jit, static_argnums=1)
def _split_normal(key, shape):
    pairs = jax.random.split(key)
    return pairs[0], jax.random.normal(pairs[1], shape, jnp.float32)


class ReferenceSource:
    """One slot's noise source replaying the reference's per-slot key."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape):
        self.key, z = _split_normal(self.key, shape)
        return torch.from_numpy(np.array(z))


class ReferenceStreams:
    """``request_streams`` handing each request the reference's prior
    and per-slot noise stream for its seed."""

    def __init__(self, jsde):
        self.jsde = jsde

    def __call__(self, req, shape, device):
        k_prior, k_noise = jax.random.split(jax.random.PRNGKey(req.seed))
        prior = np.array(self.jsde.prior_sample(k_prior, shape))
        return torch.from_numpy(prior).to(device), ReferenceSource(k_noise)


class FakeClock:
    """1 s a read, the same sequence in both packages."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _fwd(ts):
    f = tan.gaussian_noise_pred(ts, MU, S0)
    return lambda p, x, t: f(x, t)


def _port_step(cfg, forward_fn=None):
    ts = VPSDE()
    return ts, make_sample_step(ts, cfg, forward_fn=forward_fn or _fwd(ts))


def _reference_step(cfg, forward_fn=None):
    js = JVPSDE()
    return js, jmake_step(JNET, js, cfg,
                          forward_fn=forward_fn or jan.gaussian_noise_pred(js, MU, S0))


def _drain(b, reqs):
    for r in reqs:
        b.submit(r)
    return b.run_to_completion()


def _assert_same_serve(jb, jdone, tb, tdone):
    assert list(tdone) == list(jdone)  # delivery order
    for u in jdone:
        for name in ("nfe", "accepted", "rejected", "resident_iters", "deadline_missed"):
            assert getattr(tdone[u], name) == getattr(jdone[u], name), (u, name)
    for name in ("total_iterations", "useful_nfe", "resident_nfe", "host_transfers",
                 "wasted_nfe_fraction", "passenger_nfe_fraction", "class_stats",
                 "refills_per_device"):
        assert getattr(tb, name) == getattr(jb, name), name
    want = np.stack([np.asarray(jdone[u].result) for u in jdone])
    got = np.stack([tdone[u].result for u in jdone])
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


# --------------------------------------------------------------------------
# parity with the reference on its replayed draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(sync_horizon=4),
    dict(sync_horizon=1),
    dict(sync_horizon=8, compaction=False),
], ids=["h4", "h1", "h8-nocompact"])
@pytest.mark.parametrize("tiered", [False, True], ids=["untiered", "mixed"])
def test_parity_with_reference(kw, tiered):
    js, jstep = _reference_step(JCfg(eps_rel=0.05))
    ts, tstep = _port_step(AdaptiveConfig(eps_rel=0.05))
    from repro.serving.scheduler import EdfPriorityAdmission as JEdf
    from repro_torch.serving.scheduler import EdfPriorityAdmission

    common = dict(slots=4, tolerance_classes=True if tiered else None, **kw)
    jb = JBatcher(js, jstep, None, (D,), cfg=JCfg(eps_rel=0.05), clock=FakeClock(),
                  admission=JEdf(aging_s=5.0) if tiered else None, **common)
    tb = DiffusionBatcher(ts, tstep, None, (D,), cfg=AdaptiveConfig(eps_rel=0.05),
                          clock=FakeClock(),
                          admission=EdfPriorityAdmission(aging_s=5.0) if tiered else None,
                          device="cpu", request_streams=ReferenceStreams(js), **common)
    tiers = WAVE if tiered else [None] * len(WAVE)
    deadline = lambda u: (30.0 * 1000.0 if u % 2 else None) if tiered else None
    jdone = _drain(jb, [JRequest(uid=u, seed=1000 + u, tier=t, deadline_ms=deadline(u))
                        for u, t in enumerate(tiers)])
    tdone = _drain(tb, [ImageRequest(uid=u, seed=1000 + u, tier=t, deadline_ms=deadline(u))
                        for u, t in enumerate(tiers)])
    assert len(tdone) == len(WAVE)
    _assert_same_serve(jb, jdone, tb, tdone)


@pytest.mark.parametrize("kind", ["inpaint", "cfg"])
def test_parity_conditioned_payloads_travel_with_slots(kind):
    """Per-request inpainting and CFG payloads, admitted and permuted with
    their slots in both packages; delivery applies the exact
    ``finalize_project``, so observed coordinates equal each request's own
    observation bit for bit."""
    js, ts = JVPSDE(), VPSDE()
    if kind == "inpaint":
        jcfg, tcfg = JCfg(eps_rel=0.05, conditioner=JInpaint()), AdaptiveConfig(
            eps_rel=0.05, conditioner=Inpaint())
        jfwd, tfwd = None, None

        def cond(uid):
            mask = (np.arange(D) % 2 == uid % 2).astype(np.float32)
            return {"mask": mask, "observed": np.full(D, 0.1 + 0.05 * uid, np.float32)}
    else:
        jcfg, tcfg = (JCfg(eps_rel=0.05, conditioner=JCF(scale=1.5)),
                      AdaptiveConfig(eps_rel=0.05, conditioner=ClassifierFree(scale=1.5)))
        jfwd = jan.class_gaussian_noise_pred(js, CLASS_MUS, S0, MU)
        f = tan.class_gaussian_noise_pred(ts, CLASS_MUS, S0, MU)
        tfwd = lambda p, x, t, y=None: f(x, t, y)
        # uid 9 rides the neutral payload (the null label, never class 0)
        cond = lambda uid: None if uid == 9 else {"label": uid % len(CLASS_MUS)}
    jstep = jmake_step(JNET, js, jcfg, forward_fn=jfwd or jan.gaussian_noise_pred(js, MU, S0))
    tstep = make_sample_step(ts, tcfg, forward_fn=tfwd or _fwd(ts))
    jb = JBatcher(js, jstep, None, (D,), slots=4, cfg=jcfg, sync_horizon=4,
                  clock=FakeClock())
    tb = DiffusionBatcher(ts, tstep, None, (D,), slots=4, cfg=tcfg, sync_horizon=4,
                          clock=FakeClock(), device="cpu",
                          request_streams=ReferenceStreams(js))
    jdone = _drain(jb, [JRequest(uid=u, seed=u, cond=cond(u)) for u in range(10)])
    tdone = _drain(tb, [ImageRequest(uid=u, seed=u, cond=cond(u)) for u in range(10)])
    _assert_same_serve(jb, jdone, tb, tdone)
    if kind == "inpaint":
        for u in range(10):
            c = cond(u)
            obs = c["mask"] == 1.0
            np.testing.assert_array_equal(tdone[u].result[obs], c["observed"][obs])


def test_parity_small_dit():
    """The small livened DiT (image 8) as the score network, weights
    carried across with ``params_from_jax``, through the port's flash
    wrapper and fused step (their plain versions on the CPU)."""
    jcfg_net = jdit.DiTConfig(image_size=8, patch=4, d_model=32, num_layers=2,
                              num_heads=2, d_ff=64)
    tcfg_net = tdit.DiTConfig(image_size=8, patch=4, d_model=32, num_layers=2,
                              num_heads=2, d_ff=64, use_flash=True)
    tree = liven(jax.tree_util.tree_map(np.asarray,
                                        jdit.init_dit(jcfg_net, jax.random.PRNGKey(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = tdit.params_from_jax(tree, tcfg_net)
    js, ts = JVPSDE(), VPSDE()
    jstep = jmake_step(jcfg_net, js, JCfg(eps_rel=0.05))
    tstep = make_sample_step(ts, AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True))
    shape = (8, 8, 3)
    jb = JBatcher(js, jstep, jparams, shape, slots=4, cfg=JCfg(eps_rel=0.05),
                  sync_horizon=4, tolerance_classes=True, clock=FakeClock())
    tb = DiffusionBatcher(ts, tstep, model, shape, slots=4,
                          cfg=AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True),
                          sync_horizon=4, tolerance_classes=True, clock=FakeClock(),
                          device="cpu", request_streams=ReferenceStreams(js))
    tiers = ["draft", "standard", "draft", None, "standard", "draft"]
    jdone = _drain(jb, [JRequest(uid=u, seed=u, tier=t) for u, t in enumerate(tiers)])
    tdone = _drain(tb, [ImageRequest(uid=u, seed=u, tier=t) for u, t in enumerate(tiers)])
    _assert_same_serve(jb, jdone, tb, tdone)


# --------------------------------------------------------------------------
# mirrors of tests/test_diffusion_server.py, in the port's own RNG
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parts():
    cfg = AdaptiveConfig(eps_rel=0.05)
    sde, step = _port_step(cfg)
    return sde, cfg, step


def _batcher(parts, **kw):
    sde, cfg, step = parts
    kw.setdefault("slots", 4)
    kw.setdefault("cfg", cfg)
    return DiffusionBatcher(sde, step, None, (D,), device="cpu", **kw)


def _serve(parts, n_req, seed0=0, **kw):
    b = _batcher(parts, **kw)
    return b, _drain(b, [ImageRequest(uid=u, seed=seed0 + u) for u in range(n_req)])


def test_all_requests_complete_and_distribute(parts):
    b, done = _serve(parts, 12)
    assert len(done) == 12
    xs = np.stack([done[u].result for u in range(12)])
    assert np.isfinite(xs).all()
    # pooled moments approach the data distribution (pre-denoise state)
    assert abs(xs.mean() - MU) < 0.12
    assert abs(xs.std() - S0) < 0.12
    assert min(done[u].nfe for u in range(12)) > 10
    assert all(done[u].nfe % 2 == 0 for u in range(12))


def test_refill_uses_fewer_steps_than_lockstep(parts):
    n_req, slots = 16, 4
    b, done = _serve(parts, n_req, seed0=100, slots=slots)
    per_req = [done[u].nfe // 2 for u in range(n_req)]
    lockstep = sum(max(per_req[i:i + slots]) for i in range(0, n_req, slots))
    assert b.total_iterations <= lockstep


def test_horizon_and_compaction_scheduling_invariance(parts):
    """Per-request samples are bit-identical across sync horizons and with
    compaction on or off: per-slot sources decouple every trajectory from
    slot placement and sync timing."""
    def run(**kw):
        b, done = _serve(parts, 10, **kw)
        return b, np.stack([done[u].result for u in range(10)])

    _, x_h1 = run(sync_horizon=1)
    b_h8, x_h8 = run(sync_horizon=8)
    b_off, x_off = run(sync_horizon=8, compaction=False)
    np.testing.assert_array_equal(x_h1, x_h8)
    np.testing.assert_array_equal(x_h8, x_off)
    assert b_off.total_iterations >= b_h8.total_iterations
    assert b_off.wasted_nfe_fraction >= b_h8.wasted_nfe_fraction


def test_compaction_packs_survivors_contiguously(parts):
    b = _batcher(parts, sync_horizon=4)
    for uid in range(6):
        b.submit(ImageRequest(uid=uid, seed=uid))
    seen = set()
    while b.queue or any(r is not None for r in b._slot_req):
        if b.step() == 0 and not b.queue:
            break
        flags = [r is not None for r in b._slot_req]
        k = sum(flags)
        seen.add(k)
        assert flags == [True] * k + [False] * (4 - k), flags
    b._sync()
    assert len(b.finished) == 6
    assert max(seen) == 4


def test_condition_payloads_travel_with_slots(parts):
    sde = parts[0]
    ccfg = AdaptiveConfig(eps_rel=0.05, conditioner=Inpaint())
    step = make_sample_step(sde, ccfg, forward_fn=_fwd(sde))

    def req_cond(uid):
        mask = (np.arange(D) % 2 == uid % 2).astype(np.float32)
        return {"mask": mask, "observed": np.full(D, 0.1 + 0.05 * uid, np.float32)}

    def run(**kw):
        b = DiffusionBatcher(sde, step, None, (D,), slots=4, cfg=ccfg, device="cpu", **kw)
        done = _drain(b, [ImageRequest(uid=u, seed=u, cond=req_cond(u)) for u in range(10)])
        return np.stack([done[u].result for u in range(10)])

    x_h1 = run(sync_horizon=1)
    np.testing.assert_array_equal(x_h1, run(sync_horizon=8))
    np.testing.assert_array_equal(x_h1, run(sync_horizon=8, compaction=False))
    for uid in range(10):
        c = req_cond(uid)
        obs = c["mask"] == 1.0
        np.testing.assert_array_equal(x_h1[uid][obs], c["observed"][obs])


def test_wasted_nfe_accounting(parts):
    b, done = _serve(parts, 8, sync_horizon=4)
    issued = 2 * 4 * b.total_iterations
    useful = sum(done[u].nfe for u in range(8))
    assert useful == b.useful_nfe
    assert 0.0 <= b.wasted_nfe_fraction < 1.0
    assert b.wasted_nfe_fraction == pytest.approx(1.0 - useful / issued)


# --------------------------------------------------------------------------
# mirrors of tests/test_tolerance_tiers.py (the retrace test has no eager
# counterpart; the device-resident cases wait for ROADMAP A7)
# --------------------------------------------------------------------------

def _request_eps(sde, cfg, tier):
    atol = float(sde.abs_tolerance if cfg.eps_abs is None else cfg.eps_abs)
    if tier is None:
        return atol, float(cfg.eps_rel)
    t = TOLERANCE_CLASSES[tier]
    return (atol if t.eps_abs is None else float(t.eps_abs)), float(t.eps_rel)


def _solo(sde, cfg, seed, atol, rtol):
    """Solo batch-1 ``adaptive()`` at the request's tolerance, on the
    server's stream discipline (the request's ``SlotStreams`` row: the
    prior at counter 0, the noise from counter 1)."""
    x0 = sde.prior_sample((1, D), SlotStreams.of([seed], 0, "cpu"))
    fwd = tan.gaussian_noise_pred(sde, MU, S0)

    def score(x, t):
        _, std = sde.marginal(t)
        return -fwd(x, t).to(torch.float32) / std.reshape(-1, 1)

    res = adaptive(sde, score, x0, SlotStreams.of([seed], 1, "cpu"), config=cfg, denoise=False,
                   atol=atol, rtol=rtol, device="cpu")
    return res.x[0].numpy(), int(res.nfe[0])


def _serve_wave(parts, **kw):
    b = _batcher(parts, tolerance_classes=True, **kw)
    done = _drain(b, [ImageRequest(uid=u, seed=1000 + u, tier=t) for u, t in enumerate(WAVE)])
    assert len(done) == len(WAVE)
    return b, done


@pytest.mark.parametrize("kw", [
    dict(sync_horizon=1), dict(sync_horizon=8), dict(sync_horizon=8, compaction=False),
    dict(sync_horizon=4, device_resident=True),
], ids=["h1", "h8", "h8-nocompact", "device-resident"])
def test_mixed_wave_bit_identical_to_solo_at_own_tolerance(parts, kw):
    sde, cfg, _ = parts
    _, done = _serve_wave(parts, **kw)
    for uid, tier in enumerate(WAVE):
        x_ref, nfe_ref = _solo(sde, cfg, 1000 + uid, *_request_eps(sde, cfg, tier))
        np.testing.assert_array_equal(done[uid].result, x_ref,
                                      err_msg=f"uid={uid} tier={tier} kw={kw}")
        assert done[uid].nfe == nfe_ref, (uid, tier)


def test_mixed_wave_nfe_ordering_and_class_stats(parts):
    b, done = _serve_wave(parts, sync_horizon=4)
    by_tier = {}
    for uid, tier in enumerate(WAVE):
        by_tier.setdefault(tier or "default", []).append(done[uid].nfe)
    mean = {k: sum(v) / len(v) for k, v in by_tier.items()}
    assert mean["draft"] <= 0.5 * mean["high_fidelity"], mean
    assert mean["draft"] <= mean["standard"] <= mean["high_fidelity"], mean
    for name, nfes in by_tier.items():
        assert b.class_stats[name]["delivered"] == len(nfes)
        assert b.class_stats[name]["mean_nfe"] == pytest.approx(sum(nfes) / len(nfes))


def test_tiered_default_class_bitwise_matches_untiered_server(parts):
    def run(tiered):
        b, done = _serve(parts, 8, sync_horizon=4,
                         tolerance_classes=True if tiered else None)
        return {u: (done[u].nfe, done[u].result) for u in done}

    base, tier = run(False), run(True)
    assert base.keys() == tier.keys()
    for u in base:
        assert base[u][0] == tier[u][0], u
        np.testing.assert_array_equal(base[u][1], tier[u][1], err_msg=f"uid={u}")


def test_custom_tolerance_class_and_bad_tier_rejected(parts):
    sde, cfg, _ = parts
    custom = ToleranceClass("bulk", eps_rel=0.3, priority=2)
    b = _batcher(parts, slots=2, tolerance_classes={"bulk": custom})
    b.submit(ImageRequest(uid=0, seed=0, tier="bulk"))
    with pytest.raises(KeyError):
        b.submit(ImageRequest(uid=1, seed=1, tier="draft"))
    done = b.run_to_completion()
    x_ref, nfe_ref = _solo(sde, cfg, 0, float(sde.abs_tolerance), 0.3)
    np.testing.assert_array_equal(done[0].result, x_ref)
    assert done[0].nfe == nfe_ref
    with pytest.raises(ValueError):
        _batcher(parts, slots=2).submit(ImageRequest(uid=0, seed=0, tier="draft"))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_serve_diffusion_record_and_mixed_tiers(tmp_path, capsys):
    rec = tserve.serve_diffusion(slots=4, requests=6, tier="mixed", telemetry=64,
                                 trace_out=str(tmp_path / "trace.json"),
                                 metrics_out=str(tmp_path / "m.json"), device="cpu")
    assert REF_RECORD_KEYS <= set(rec)
    assert rec["completed"] == 6 and rec["device"] == "cpu"
    assert set(rec["class_stats"]) == {"draft", "standard", "high_fidelity"}
    assert sum(s["delivered"] for s in rec["class_stats"].values()) == 6
    assert rec["precision"]["policy"] == "fp32"
    assert rec["solver_syncs"] > 0 and rec["host_transfers"] > 0
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["telemetry"]["iterations"] == rec["total_iterations"]
    assert (tmp_path / "m.prom").read_text().startswith("# TYPE")
    # the reference's report renders the port's record
    from repro.analysis.telemetry import telemetry_markdown as jmd
    from repro_torch.analysis.telemetry import telemetry_markdown
    assert telemetry_markdown(trace) == jmd(trace)


def test_serve_cli_conditioned_modes():
    for argv in (["--inpaint"], ["--cfg-scale", "1.5"]):
        rec = tserve.main(["--diffusion", "--device", "cpu", "--slots", "2",
                           "--requests", "3", *argv])
        assert rec["completed"] == 3


def test_device_resident_and_mesh_raise_naming_roadmap(parts):
    """The device-resident mode runs (the plain driver on the CPU); a mesh
    whose data axes do not divide the slots raises ``ValueError``,
    device-resident or not (mesh serving itself runs in
    ``test_torch_sharded_serving.py``)."""
    rec = tserve.serve_diffusion(slots=2, requests=1, device_resident=True, device="cpu")
    assert rec["completed"] == 1 and rec["device_resident"]
    assert rec["horizon_windows"] >= 1
    assert _batcher(parts, device_resident=True).device_resident
    mesh = Mesh(("data", "model"), (3, 2), (1, 0))  # no process group: raises first
    for dr in (False, True):
        with pytest.raises(ValueError, match="must divide across 3 devices"):
            _batcher(parts, mesh=mesh, device_resident=dr)


def test_server_without_a_card_raises(parts, monkeypatch):
    """The server's default device is ``cuda``; with no card it raises
    (through ``resolve_device``) instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sde, cfg, step = parts
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionBatcher(sde, step, None, (D,), slots=2, cfg=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_diffusion(slots=2, requests=1)
