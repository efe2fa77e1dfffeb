"""Port ↔ reference parity: the observability layer
(``repro_torch.observability``, ``repro_torch.analysis.telemetry``) and
the telemetry leaf of the port's Algorithm-1 carry.

Mirrors the rows of ``tests/test_observability.py`` that the port's
slice holds: telemetry off ≡ on bitwise (the adaptive, momentum and
Heun families at sync horizons 1 and 8 and device-resident), the ring
against a host-replayed oracle, its
wraparound and chunk-boundary invariance, request ids through
compaction, the mixed-wave trace reconciliation and report (host-driven
and device-resident), the registry, the tracer, and the quality gauges.

Against the reference: its ring and the port's, on the reference's
replayed per-slot draws, hold the same accept bits record for record,
and t, h within rtol 1e-5, atol 1e-6, err within rtol 1e-4 (the
step-size control's power and the error's sum round differently in the
two frameworks); the registries export the same text; the quality gauges and the
markdown report agree exactly (numpy both sides).
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import telemetry as janalysis
from repro.core import AdaptiveConfig as JCfg
from repro.core import VPSDE as JVPSDE
from repro.core import analytic as jan
from repro.observability import MetricsRegistry as JRegistry
from repro.observability import dynamics_consistency as jdyn
from repro.observability import proxy_fid as jfid
from repro.observability import telemetry_history as jhistory
from repro.planning.envs import OUEnv, PointMassEnv
from repro_torch.analysis.telemetry import (
    active_records, nfe_percentiles, step_size_vs_t, telemetry_markdown,
)
from repro_torch.core import analytic as tan
from repro_torch.core.sde import VPSDE
from repro_torch.core.solvers.adaptive import AdaptiveConfig, init_carry, solve_chunk
from repro_torch.launch.sample import make_sample_step
from repro_torch.observability import (
    NULL_TRACER, MetricsRegistry, StageTracer, dynamics_consistency,
    profiler_annotation, proxy_fid, telemetry_history,
)
from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

from test_torch_diffusion_server import ReferenceSource

# the package re-exports the function ``adaptive`` under the module's name
jad_mod = importlib.import_module("repro.core.solvers.adaptive")

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
D = 32
N_REQ = 6
WAVE = ["draft", "high_fidelity", None, "standard", "draft", None,
        "high_fidelity", "draft", "standard", None]
MODES = {"h1": dict(sync_horizon=1), "h8": dict(sync_horizon=8),
         "device-resident": dict(sync_horizon=4, device_resident=True)}


def _active_threshold(t_eps) -> float:
    """The device's activity test runs in fp32: idle slots sit at
    fp32(t_eps), so a host replica compares with the fp32 threshold."""
    return float(np.float32(float(t_eps) + 1e-12))


@pytest.fixture(scope="module")
def parts():
    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05)
    fwd = tan.gaussian_noise_pred(sde, MU, S0)
    return sde, cfg, make_sample_step(sde, cfg, forward_fn=lambda p, x, t: fwd(x, t))


#: the zoo's families routed through the Algorithm-1 body (DESIGN.md §11),
#: the reference's ``FAMILIES`` rows besides the adaptive one
ZOO_FAMILIES = {"momentum": dict(momentum=0.3), "heun": dict(probability_flow=True)}


@pytest.fixture(scope="module")
def zoo_parts():
    sde = VPSDE()
    fwd = tan.gaussian_noise_pred(sde, MU, S0)
    out = {}
    for name, over in ZOO_FAMILIES.items():
        cfg = dataclasses.replace(AdaptiveConfig(eps_rel=0.05), **over)
        out[name] = (sde, cfg, make_sample_step(sde, cfg, forward_fn=lambda p, x, t: fwd(x, t)))
    return out


def _serve(parts, n_req=N_REQ, tiers=None, **kw):
    sde, cfg, step = parts
    b = DiffusionBatcher(sde, step, None, (D,), slots=4, cfg=cfg, device="cpu", **kw)
    for uid in range(n_req):
        tier = tiers[uid % len(tiers)] if tiers else None
        b.submit(ImageRequest(uid=uid, seed=1000 + uid, tier=tier))
    done = b.run_to_completion()
    assert len(done) == n_req
    return b, done


# --------------------------------------------------------------------------
# telemetry off == on, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_telemetry_off_on_bitwise_identical(parts, mode):
    """Recording never feeds back: a telemetry-on drain is sample-, NFE-
    and accept/reject-identical to the off drain, adds no host transfer
    or solver sync, and its ring head equals the folded iteration count."""
    _off_on_identical(parts, mode)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", list(ZOO_FAMILIES))
def test_telemetry_off_on_bitwise_identical_zoo(zoo_parts, family, mode):
    """The same for the momentum and Heun families: their bodies record
    into the ring without feeding back either."""
    _off_on_identical(zoo_parts[family], mode, solver=family)


def _off_on_identical(parts, mode, **kw):
    b_off, off = _serve(parts, **MODES[mode], **kw)
    b_on, on = _serve(parts, telemetry=256, **MODES[mode], **kw)
    for uid in off:
        np.testing.assert_array_equal(off[uid].result, on[uid].result)
        for name in ("nfe", "accepted", "rejected"):
            assert getattr(off[uid], name) == getattr(on[uid], name), (uid, name)
    assert b_on.host_transfers == b_off.host_transfers
    assert b_on.solver_syncs == b_off.solver_syncs
    assert b_off._carry.telemetry is None
    head = int(b_on._carry.telemetry.head)
    assert head == b_on.total_iterations == b_off.total_iterations


# --------------------------------------------------------------------------
# the ring against a host-replayed oracle and against the reference's ring
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle_runs():
    """One batch-4 solve four ways, on the reference's per-slot draws:
    telemetry-off one iteration per host visit (the oracle), telemetry-on
    in one chunk, a capacity-8 ring (it wraps), and chained one-iteration
    chunks; plus the reference's own telemetry-on solve."""
    js, ts = JVPSDE(), VPSDE()
    B = 4
    kp, kn = jax.random.split(jax.random.PRNGKey(7))
    x0 = np.array(js.prior_sample(kp, (B, D)))
    nk = jax.random.split(kn, B)
    cfg = AdaptiveConfig(eps_rel=0.05)
    score = tan.gaussian_score(ts, MU, S0)
    sources = lambda: [ReferenceSource(nk[i]) for i in range(B)]
    carry = lambda cap: init_carry(ts, torch.from_numpy(x0), sources(), config=cfg,
                                   telemetry=cap)
    step1 = lambda c: solve_chunk(ts, score, c, max_sync_iters=1, config=cfg)
    solve_all = lambda c: solve_chunk(ts, score, c, max_sync_iters=4096, config=cfg)
    eps = _active_threshold(ts.t_eps)

    c = carry(0)
    ts_, hs, dacc = [], [], []
    for _ in range(10_000):
        t_prev, h_prev = c.t.numpy().copy(), c.h.numpy().copy()
        active = t_prev > eps
        if not active.any():
            break
        acc_prev = c.accepted.numpy().copy()
        c = step1(c)
        ts_.append(t_prev)
        hs.append(np.where(active, h_prev, 0.0).astype(np.float32))
        dacc.append((c.accepted.numpy() - acc_prev).astype(bool))
    oracle = {"t": np.stack(ts_, axis=1), "h": np.stack(hs, axis=1),
              "accept": np.stack(dacc, axis=1), "x": c.x.numpy(),
              "accepted": c.accepted.numpy(), "rejected": c.rejected.numpy(),
              "n": len(ts_)}
    # the config's capacity, as AdaptiveConfig.telemetry_capacity gives it
    c_on = solve_all(init_carry(ts, torch.from_numpy(x0), sources(),
                                config=dataclasses.replace(cfg, telemetry_capacity=512)))
    assert bool(c_on.done.all())
    c_small = solve_all(carry(8))
    c_ch = carry(512)
    while not bool(c_ch.done.all()):
        c_ch = step1(c_ch)

    jcfg = JCfg(eps_rel=0.05)
    jscore = jan.gaussian_score(js, MU, S0)
    jc = jax.jit(lambda c: jad_mod.solve_chunk(js, jscore, c, max_sync_iters=4096,
                                               config=jcfg))(
        jad_mod.init_carry(js, jnp.asarray(x0), nk, config=jcfg, telemetry=512))
    return ts, oracle, c_on, c_small, c_ch, jc


def test_ring_matches_host_replay_oracle(oracle_runs):
    sde, oracle, c_on, _, _, _ = oracle_runs
    hist = telemetry_history(c_on.telemetry)
    n = oracle["n"]
    assert hist["iterations"] == hist["records"] == n
    np.testing.assert_array_equal(hist["t"], oracle["t"])
    np.testing.assert_array_equal(hist["h"], oracle["h"])
    np.testing.assert_array_equal(hist["accept"], oracle["accept"])
    active = oracle["t"] > _active_threshold(sde.t_eps)
    np.testing.assert_array_equal(hist["accept"], (hist["err"] <= 1.0) & active)
    assert hist["accept"].sum(axis=1).tolist() == oracle["accepted"].tolist()
    np.testing.assert_array_equal((active & ~hist["accept"]).sum(axis=1),
                                  oracle["rejected"])
    np.testing.assert_array_equal(c_on.x.numpy(), oracle["x"])


def test_ring_matches_the_reference_ring(oracle_runs):
    """The port's ring and the reference's, on the same draws: the same
    record count and accept bits; t and h within rtol 1e-5 and an
    absolute 1e-6 (t is a running sum of steps on [t_eps, T = 1], so its
    error is absolute: 1e-6 of T); err within rtol 1e-4, the bound of the
    states in ``test_torch_adaptive.py`` (err is the norm of x'' − x', a
    difference of nearly equal states, so it keeps fewer digits)."""
    _, _, c_on, _, _, jc = oracle_runs
    got = telemetry_history(c_on.telemetry)
    want = jhistory(jax.device_get(jc.telemetry))
    assert got["iterations"] == want["iterations"] and got["records"] == want["records"]
    np.testing.assert_array_equal(got["accept"], want["accept"])
    for k in ("t", "h"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["err"], want["err"], rtol=1e-4, atol=1e-6)


def test_ring_wraparound_keeps_most_recent_records(oracle_runs):
    _, oracle, c_on, c_small, _, _ = oracle_runs
    full = telemetry_history(c_on.telemetry)
    small = telemetry_history(c_small.telemetry)
    assert oracle["n"] > 8
    assert small["iterations"] == oracle["n"] and small["records"] == 8
    for k in ("t", "h", "err", "accept"):
        np.testing.assert_array_equal(small[k], full[k][:, -8:], err_msg=k)
    np.testing.assert_array_equal(c_small.x.numpy(), oracle["x"])


def test_ring_is_chunk_boundary_invariant(oracle_runs):
    _, _, c_on, _, c_ch, _ = oracle_runs
    full = telemetry_history(c_on.telemetry)
    chunked = telemetry_history(c_ch.telemetry)
    assert chunked["iterations"] == full["iterations"]
    for k in ("t", "h", "err", "accept"):
        np.testing.assert_array_equal(chunked[k], full[k], err_msg=k)


# --------------------------------------------------------------------------
# stage tracing and the reconciliation of a trace record
# --------------------------------------------------------------------------

def test_request_id_propagation_through_compaction(parts):
    tracer = StageTracer()
    b, done = _serve(parts, n_req=10, tracer=tracer, sync_horizon=4)
    admit_slot, deliver_slot, deliver_nfe = {}, {}, {}
    for sp in tracer.spans:
        if sp["name"] == "serve/admission":
            admit_slot.update(zip(sp["attrs"]["uids"], sp["attrs"]["slots"]))
        elif sp["name"] == "serve/delivery":
            for uid, slot, nfe in zip(sp["attrs"]["uids"], sp["attrs"]["slots"],
                                      sp["attrs"]["nfe"]):
                deliver_slot[uid], deliver_nfe[uid] = slot, nfe
    assert set(admit_slot) == set(deliver_slot) == set(range(10))
    for uid, req in done.items():
        assert deliver_nfe[uid] == req.nfe
    assert any(admit_slot[u] != deliver_slot[u] for u in admit_slot), \
        "no request ever crossed slots: compaction untested"
    hist = tracer.stage_histograms()
    for stage in ("serve/admission", "serve/solve", "serve/delivery"):
        assert hist[stage]["count"] > 0 and hist[stage]["total_s"] >= 0.0


def test_mixed_wave_trace_reconciles_and_renders(parts):
    """A mixed 10-request wave with telemetry and tracing on: ring sums ==
    Σ per-request books == registry counters == the per-tier stats, nfe
    == 2·(accepted + rejected), head == total_iterations; the record is
    JSON end to end and renders to the same report as the reference's
    renderer gives it."""
    sde, cfg, step = parts
    b = DiffusionBatcher(sde, step, None, (D,), slots=4, cfg=cfg, sync_horizon=4,
                         tolerance_classes=True, telemetry=4096, tracer=StageTracer(),
                         device="cpu")
    for uid, tier in enumerate(WAVE):
        b.submit(ImageRequest(uid=uid, seed=1000 + uid, tier=tier))
    assert len(b.run_to_completion()) == len(WAVE)
    rec = json.loads(json.dumps(b.trace_record()))
    reqs = rec["requests"]
    assert [r["uid"] for r in reqs] == list(range(len(WAVE)))
    m = b.metrics
    for r in reqs:
        assert r["nfe"] == 2 * (r["accepted"] + r["rejected"]), r
    tel = rec["telemetry"]
    t = np.asarray(tel["t"])
    acc = np.asarray(tel["accept"]).astype(bool)
    active = t > _active_threshold(tel["t_eps"])
    assert tel["records"] == tel["iterations"] == b.total_iterations \
        == int(m.value("serve_iterations_total"))
    assert int(acc.sum()) == int((acc & active).sum()) == sum(r["accepted"] for r in reqs) \
        == int(m.value("serve_accepted_total"))
    assert int((active & ~acc).sum()) == sum(r["rejected"] for r in reqs) \
        == int(m.value("serve_rejected_total"))
    assert int(m.value("serve_nfe_useful_total")) == sum(r["nfe"] for r in reqs)
    for tier in {r["tier"] for r in reqs}:
        rs = [r for r in reqs if r["tier"] == tier]
        assert b.class_stats[tier]["delivered"] == len(rs) \
            == int(m.value("serve_delivered_total", tier=tier))
        assert int(m.value("serve_tier_nfe_total", tier=tier)) == sum(r["nfe"] for r in rs)
    assert int(m.total("serve_delivered_total")) == len(reqs)
    assert int(m.value("serve_solver_syncs_total")) == b.solver_syncs > 0
    g = rec["metrics"]["gauges"]
    assert g["serve_wasted_nfe_fraction"] == pytest.approx(b.wasted_nfe_fraction)
    a, r = int(m.value("serve_accepted_total")), int(m.value("serve_rejected_total"))
    assert g["serve_acceptance_rate"] == pytest.approx(a / (a + r))
    assert {"serve/admission", "serve/solve", "serve/delivery"} <= {
        s["name"] for s in rec["trace"]["spans"]}

    live = active_records(tel)
    assert live["t"].size == int(active.sum())
    np.testing.assert_array_equal(live["accept"], live["err"] <= 1.0)
    assert step_size_vs_t(tel)
    assert nfe_percentiles(reqs)[0]["nfe"] <= nfe_percentiles(reqs)[-1]["nfe"]
    md = telemetry_markdown(rec)
    for needle in ("# Serve-loop telemetry report", "## Per-stage latency",
                   "## Per-request NFE CDF", "## Step size and accept rate vs t",
                   "## Per-tier delivery", "draft"):
        assert needle in md, needle
    assert md == janalysis.telemetry_markdown(rec)


def test_device_resident_trace_reconciles(parts):
    """The same reconciliation on the device-resident path, whose
    iteration counter folds at another seam (the multi-horizon driver's
    events): ring head == total_iterations, ring sums == the requests'
    books == the registry's."""
    b, done = _serve(parts, n_req=len(WAVE), tiers=WAVE, sync_horizon=4,
                     device_resident=True, tolerance_classes=True, telemetry=4096,
                     tracer=StageTracer())
    rec = json.loads(json.dumps(b.trace_record()))
    reqs, tel, m = rec["requests"], rec["telemetry"], b.metrics
    acc = np.asarray(tel["accept"]).astype(bool)
    active = np.asarray(tel["t"]) > _active_threshold(tel["t_eps"])
    assert tel["records"] == tel["iterations"] == b.total_iterations \
        == int(m.value("serve_iterations_total"))
    assert int(acc.sum()) == sum(r["accepted"] for r in reqs) \
        == int(m.value("serve_accepted_total"))
    assert int((active & ~acc).sum()) == sum(r["rejected"] for r in reqs)
    assert sum(r["nfe"] for r in reqs) == sum(r.nfe for r in done.values()) \
        == int(m.value("serve_nfe_useful_total"))
    assert rec["metrics"]["gauges"]["serve_horizon_windows"] == b.horizon_windows


# --------------------------------------------------------------------------
# registry, tracer, profiler annotation, quality gauges
# --------------------------------------------------------------------------

def _fill(reg):
    reg.counter("reqs_total", tier="draft").inc(3)
    reg.counter("reqs_total", tier="hf").inc()
    reg.gauge("depth").set(2.5)
    h = reg.histogram("wait_seconds", bounds=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.histogram("lat_seconds", stage="solve").observe(0.02)
    return reg


def test_metrics_registry_export_roundtrip():
    reg = _fill(MetricsRegistry())
    assert reg.counter("reqs_total", tier="draft") is reg.counter("reqs_total", tier="draft")
    with pytest.raises(ValueError):
        reg.counter("reqs_total", tier="draft").inc(-1)
    assert reg.value("reqs_total", tier="draft") == 3
    assert reg.total("reqs_total") == 4
    with pytest.raises(KeyError):
        reg.value("reqs_total")
    j = json.loads(json.dumps(reg.to_json()))
    assert j["counters"]['reqs_total{tier="draft"}'] == 3
    assert j["gauges"]["depth"] == 2.5
    assert j["histograms"]["wait_seconds"]["buckets"] == [1, 1, 1]
    prom = reg.to_prometheus()
    for line in ("# TYPE reqs_total counter", 'reqs_total{tier="draft"} 3',
                 "# TYPE wait_seconds histogram", 'wait_seconds_bucket{le="0.1"} 1',
                 'wait_seconds_bucket{le="1.0"} 2', 'wait_seconds_bucket{le="+Inf"} 3',
                 "wait_seconds_count 3"):
        assert line in prom, line
    # the reference's registry, fed the same, exports the same
    ref = _fill(JRegistry())
    assert prom == ref.to_prometheus()
    assert reg.to_json() == ref.to_json()


def test_stage_tracer_null_tracer_and_profiler_annotation():
    ticks = (x * 0.5 for x in range(100))
    tr = StageTracer(clock=lambda: next(ticks))
    with tr.span("a", uid=1) as sp:
        sp["attrs"]["extra"] = 2
    with tr.span("b"):
        pass
    assert [s["name"] for s in tr.spans] == ["a", "b"]
    assert tr.spans[0]["duration_s"] == 0.5
    assert tr.spans[0]["attrs"] == {"uid": 1, "extra": 2}
    assert tr.stage_histograms()["a"]["mean_s"] == 0.5
    j = json.loads(json.dumps(tr.to_json()))
    assert len(j["spans"]) == 2 and j["bucket_bounds_s"][0] == 1e-4

    def no_clock():
        raise AssertionError("the null tracer read a clock")

    NULL_TRACER.clock = no_clock
    with NULL_TRACER.span("x", uid=9) as sp:
        sp["attrs"]["k"] = 1
    assert NULL_TRACER.spans == []
    assert NULL_TRACER.enabled is False and StageTracer.enabled is True

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler_annotation("serve/solve", step=3, device="cpu"):
            torch.ones(4).sum()
    assert any(e.name == "serve/solve#3" for e in prof.events())


def test_proxy_fid_gauge_properties():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 16))
    b = rng.standard_normal((256, 16))
    assert proxy_fid(a, a) == pytest.approx(0.0, abs=1e-9)
    near, far, wide = proxy_fid(a, b), proxy_fid(a, b + 1.0), proxy_fid(a, 3.0 * b)
    assert 0.0 <= near < far and near < wide
    assert proxy_fid(a, b, dim=8, seed=3) == jfid(a, b, dim=8, seed=3)
    assert (near, far, wide) == (jfid(a, b), jfid(a, b + 1.0), jfid(a, 3.0 * b))
    img = rng.standard_normal((64, 4, 4, 2))
    assert proxy_fid(img, img) == pytest.approx(0.0, abs=1e-9)
    with pytest.raises(ValueError):
        proxy_fid(a, rng.standard_normal((64, 8)))


def test_dynamics_consistency_matches_reference():
    """On rollouts of the reference's analytic environments: a true
    deterministic rollout scores ~0, a perturbed one high, an OU rollout
    at its σ√dt floor; each equal to the reference's gauge."""
    pm = PointMassEnv(dim=2)
    rng = np.random.default_rng(1)
    trajs = []
    for i in range(4):
        s = np.asarray(pm.reset(jax.random.PRNGKey(i)))
        rows = []
        for _ in range(6):
            a = 0.5 * rng.standard_normal(pm.act_dim)
            rows.append(np.concatenate([s, a]))
            s = np.asarray(pm.step(jnp.asarray(s), jnp.asarray(a))[0])
        trajs.append(np.stack(rows))
    trajs = np.stack(trajs)
    kw = dict(obs_dim=pm.obs_dim, act_dim=pm.act_dim)
    assert dynamics_consistency(pm, trajs, **kw) <= 1e-6
    bad = trajs.copy()
    bad[:, :, :pm.obs_dim] += 0.5 * rng.standard_normal(bad[:, :, :pm.obs_dim].shape)
    assert dynamics_consistency(pm, bad, **kw) > 0.1
    assert dynamics_consistency(pm, bad, **kw) == jdyn(pm, bad, **kw)

    ou = OUEnv(obs_dim=2)
    floor = ou.sigma * np.sqrt(ou.dt)
    trajs = []
    for i in range(8):
        key = jax.random.PRNGKey(100 + i)
        s = np.asarray(ou.reset(key))
        rows = []
        for _ in range(8):
            key, sk = jax.random.split(key)
            a = 0.3 * rng.standard_normal(ou.act_dim)
            rows.append(np.concatenate([s, a]))
            s = np.asarray(ou.step(jnp.asarray(s), jnp.asarray(a), sk)[0])
        trajs.append(np.stack(rows))
    kw = dict(obs_dim=ou.obs_dim, act_dim=ou.act_dim)
    dyn = dynamics_consistency(ou, np.stack(trajs), **kw)
    assert 0.5 * floor < dyn < 2.0 * floor
    assert dyn == jdyn(ou, np.stack(trajs), **kw)
    assert dynamics_consistency(ou, trajs[0], **kw) > 0.0
