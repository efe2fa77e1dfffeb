"""``sample()``'s per-row streams and the graphed solve's driver cache, on
the CPU.

``sample(seed=s)`` draws every method's prior from ``seed_streams(s, B)``
at counter 0 and the Algorithm-1 families' noise from the same streams,
so row i is a solo ``adaptive()`` on row i's stream; the families' solve
runs through the cached ``HorizonDriver`` (on the CPU its plain loop,
``kernels.graph_loop.ref``, one body iteration a unit under P2's
conditions), bitwise the host-driven ``solve_chunk`` chain on the same
streams. Under the one-shot
rule a key's first solve is that host-driven chain and records the key,
the second builds the driver, later ones reuse it. The card's WHILE node
and its one host read a solve are gated in ``chip_smoke.py``.
"""

import dataclasses
import gc
import types

import numpy as np
import pytest
import torch

from repro_torch.core import analytic as tan
from repro_torch.core import sde as tsde
from repro_torch.core.sampling import chunk_seeds, sample, seed_streams, solve_in_chunks
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers.heun import heun_config
from repro_torch.core.solvers.momentum import momentum_config
from repro_torch.core.streams import SlotStreams
from repro_torch.kernels.graph_loop import ref as loop_ref

torch.set_num_threads(2)

MU, S0 = 0.3, 0.5
FAMILIES = ("adaptive", "momentum", "heun")
METHODS = ("adaptive", "momentum", "heun", "em", "pc", "pc_hmc", "ddim", "ode")
FIELDS = ("x", "nfe", "accepted", "rejected", "iterations")


def _family_config(method, **kw):
    cfg = ad.AdaptiveConfig(**kw)
    return {"adaptive": cfg, "momentum": momentum_config(cfg),
            "heun": heun_config(cfg)}[method]


def _host_chain(sde, score, shape, seed, cfg, *, denoise=True, telemetry=None):
    """The host-driven chain on ``sample``'s streams: one ``solve_chunk``
    to the end, as ``adaptive()`` ran before the graphed solve."""
    st = seed_streams(seed, shape[0], "cpu")
    carry = ad.init_carry(sde, sde.prior_sample(shape, st), st.advanced(1), config=cfg,
                          telemetry=telemetry)
    carry = ad.solve_chunk(sde, score, carry, max_sync_iters=cfg.max_iters, config=cfg)
    return ad.finalize(sde, score, carry, denoise=denoise, precision=cfg.precision), carry


def _assert_same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(autouse=True)
def _empty_cache():
    ad.clear_graph_cache()
    yield
    ad.clear_graph_cache()


def test_seed_streams_follow_chunk_seeds():
    st = seed_streams(11, 5, "cpu")
    assert st.seed.tolist() == chunk_seeds(11, 5)
    assert st.counter.tolist() == [0] * 5
    assert all(0 <= s < 2 ** 63 for s in st.seed.tolist())
    assert len(set(st.seed.tolist())) == 5


@pytest.mark.parametrize("method", FAMILIES)
def test_row_of_sample_is_a_solo_adaptive_on_its_stream(method):
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    res = sample(ts, score, (5, 4), seed=7, method=method, device="cpu", eps_rel=0.05)
    seeds = chunk_seeds(7, 5)
    for i, s in enumerate(seeds):
        st = SlotStreams.of([s], 0, device="cpu")
        solo = ad.adaptive(ts, score, ts.prior_sample((1, 4), st), st.advanced(1),
                           config=_family_config(method, eps_rel=0.05), device="cpu")
        assert torch.equal(solo.x[0], res.x[i]), i
        for f in ("nfe", "accepted", "rejected"):
            assert torch.equal(getattr(solo, f)[0], getattr(res, f)[i]), (i, f)


@pytest.mark.parametrize("method", METHODS)
def test_one_seed_gives_every_method_the_same_prior(method):
    priors = {}

    class Recorded(tsde.VPSDE):
        def prior_sample(self, shape, generator):
            x = super().prior_sample(shape, generator)
            priors["x"] = x.clone()
            return x

    ts = Recorded()
    kw = {"ode": {}}.get(method, dict(n_steps=4) if method in ("em", "pc", "pc_hmc", "ddim")
                          else dict(eps_rel=0.3))
    sample(ts, tan.gaussian_score(ts, MU, S0), (3, 4), seed=5, method=method, device="cpu",
           **kw)
    want = tsde.VPSDE().prior_sample((3, 4), seed_streams(5, 3, "cpu"))
    assert torch.equal(priors["x"], want)


@pytest.mark.parametrize("method", FAMILIES)
@pytest.mark.parametrize("denoise", [True, False])
def test_sample_is_the_solve_chunk_chain(method, denoise):
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    res = sample(ts, score, (6, 5), seed=3, method=method, device="cpu", denoise=denoise,
                 eps_rel=0.05)
    want, _ = _host_chain(ts, score, (6, 5), 3, _family_config(method, eps_rel=0.05),
                          denoise=denoise)
    _assert_same(res, want)


def test_sample_runs_through_the_plain_driver(monkeypatch):
    """On the CPU the graphed solve is ``graph_loop.ref.solve_horizons``
    over one horizon of ``max_iters`` one-iteration units (the reference's
    one ``solve_chunk`` of ``max_iters``), every row occupied, waiting on
    all of them, stopping at the last iteration with a row active."""
    calls = []
    real = loop_ref.solve_horizons

    def spy(unit, carry, occupied, **kw):
        out = real(unit, carry, occupied, **kw)
        calls.append((bool(occupied.all()), kw["wait_all"], kw["horizon"], kw["max_iters"],
                      kw["max_horizons"], out[2], out[3]))
        return out

    monkeypatch.setattr(loop_ref, "solve_horizons", spy)
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    run = lambda: sample(ts, score, (4, 3), seed=1, device="cpu", eps_rel=0.05,
                         max_iters=500)
    first = run()  # the key's first solve: the host-driven chain
    assert calls == []
    res = run()
    its = int(res.iterations)
    assert calls == [(True, True, 500, 500, 1, 1, its)]
    assert its > ad.SYNC_EVERY
    _assert_same(first, res)


@pytest.mark.parametrize("max_iters", [5, 8, 13])
def test_sample_stops_at_max_iters_as_the_chain(max_iters):
    """The solve's budget is P2's: a cap inside a horizon stops the graphed
    solve where the chain stops, its score called 2·max_iters + 1 times."""
    ts = tsde.VPSDE()
    inner, calls = tan.gaussian_score(ts, MU, S0), []
    score = lambda x, t: calls.append(1) or inner(x, t)
    sample(ts, score, (4, 3), seed=2, device="cpu", eps_rel=0.05, max_iters=max_iters)
    del calls[:]
    res = sample(ts, score, (4, 3), seed=2, device="cpu", eps_rel=0.05, max_iters=max_iters)
    assert len(ad._drivers) == 1 and len(calls) == 2 * max_iters + 1
    want, carry = _host_chain(ts, score, (4, 3), 2,
                              ad.AdaptiveConfig(eps_rel=0.05, max_iters=max_iters))
    _assert_same(res, want)
    assert int(res.iterations) == max_iters and not bool(carry.done.all())


def test_telemetry_ring_is_the_chains():
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    cfg = ad.AdaptiveConfig(eps_rel=0.05, telemetry_capacity=64)
    st = seed_streams(4, 3, "cpu")
    carry = ad.init_carry(ts, ts.prior_sample((3, 2), st), st.advanced(1), config=cfg)
    ad.solve_graphed(ts, score, carry, config=cfg)  # the first: host-driven
    got = ad.solve_graphed(ts, score, carry, config=cfg)
    assert len(ad._drivers) == 1
    _, want = _host_chain(ts, score, (3, 2), 4, cfg)
    for f in dataclasses.fields(got.telemetry):
        assert torch.equal(getattr(got.telemetry, f.name), getattr(want.telemetry, f.name)), f
    assert int(got.telemetry.head) == int(got.iterations)


@pytest.mark.parametrize("horizon", [1, 5, ad.SYNC_EVERY, 12])
def test_solve_in_chunks_replays_one_chunk_a_sync(horizon):
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    want = sample(ts, score, (5, 3), seed=9, device="cpu", eps_rel=0.05)
    its = int(want.iterations)
    for run in range(2):  # the host-driven chain, then the driver's
        seen = []
        got = solve_in_chunks(ts, score, (5, 3), max_sync_iters=horizon, seed=9,
                              device="cpu", eps_rel=0.05,
                              on_sync=lambda c: seen.append(int(c.iterations)))
        _assert_same(got, want)
        assert seen == [min(horizon * (k + 1), its) for k in range(-(-its // horizon))]
        assert len(ad._drivers) == run
    key = next(iter(ad._drivers))
    assert (key.static[1], key.max_horizons) == (horizon, 1)


def test_cache_hit_reuses_the_driver_and_copies_the_new_carry():
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    sample(ts, score, (4, 3), seed=1, device="cpu", eps_rel=0.05)
    assert not ad._drivers  # the key's first solve ran host-driven
    a = sample(ts, score, (4, 3), seed=1, device="cpu", eps_rel=0.05)
    assert len(ad._drivers) == 1
    drv = next(iter(ad._drivers.values()))
    b = sample(ts, score, (4, 3), seed=2, device="cpu", eps_rel=0.05)
    assert len(ad._drivers) == 1 and next(iter(ad._drivers.values())) is drv
    assert drv.captures == 0  # the CPU captures nothing: its horizon is solve_chunk
    assert not torch.equal(a.x, b.x)
    want, _ = _host_chain(ts, score, (4, 3), 2, ad.AdaptiveConfig(eps_rel=0.05))
    _assert_same(b, want)
    # the result owns its tensors: the next solve leaves it alone
    kept = b.x.clone()
    sample(ts, score, (4, 3), seed=3, device="cpu", eps_rel=0.05)
    assert torch.equal(b.x, kept)


def test_cache_key_is_sde_score_config_horizon_and_carry_structure():
    ts, te = tsde.VPSDE(), tsde.VESDE(sigma_max=10.0)
    score = tan.gaussian_score(ts, MU, S0)

    def run(sde=ts, sc=score, shape=(4, 3), **kw):  # twice: the second builds the driver
        for _ in range(2):
            sample(sde, sc, shape, seed=0, device="cpu", **{"eps_rel": 0.3, **kw})

    run()
    run()  # the same key: no new driver
    run(eps_rel=0.2, eps_abs=0.01)  # the tolerances are per-solve values: the same key
    assert len(ad._drivers) == 1
    run(safety=0.8)  # config
    run(shape=(4, 5))  # state shape
    score_ve, other = tan.gaussian_score(te, MU, S0), tan.gaussian_score(ts, MU, S0)
    run(sde=te, sc=score_ve)  # sde and score
    run(sc=other)  # another score function (alive: the cache holds it weakly)
    run(telemetry_capacity=8)  # carry structure
    assert len(ad._drivers) == 6
    keys = list(ad._drivers)
    assert all(k.family == "adaptive" and k.static[0].eps_rel is None for k in keys)
    assert len({k.signature for k in keys}) == 3  # (4, 3), (4, 5), the ring


def test_cache_holds_eight_and_evicts_the_least_recently_used():
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    run = lambda th: sample(ts, score, (2, 3), seed=0, device="cpu", eps_rel=0.3, safety=th)
    thetas = [0.8 + 0.01 * i for i in range(ad.GRAPH_CACHE_SIZE)]
    for th in thetas:
        run(th)
        run(th)  # the key's second solve builds its driver
    first = next(iter(ad._drivers.values()))
    run(thetas[0])  # a hit moves it to the end
    assert list(ad._drivers.values())[-1] is first
    assert len(ad._drivers) == ad.GRAPH_CACHE_SIZE == 8
    run(0.95)
    assert len(ad._drivers) == 8  # a ninth key's first solve builds nothing
    run(0.95)  # its second evicts the least recently used: thetas[1]'s
    assert len(ad._drivers) == 8
    cfgs = [k.static[0].safety for k in ad._drivers]
    assert thetas[1] not in cfgs and thetas[0] in cfgs and 0.95 in cfgs


def test_dropping_the_score_function_drops_its_drivers():
    """The cache holds a score function weakly: once it is collected, its
    drivers (their graphs and pools on the card) go with it."""
    ts = tsde.VPSDE()
    score, kept = tan.gaussian_score(ts, MU, S0), tan.gaussian_score(ts, MU, S0)
    for sc in (score, kept, score):
        for _ in range(2):
            sample(ts, sc, (3, 2 if sc is kept else 4), seed=0, device="cpu", eps_rel=0.3)
    sample(ts, score, (3, 6), seed=0, device="cpu", eps_rel=0.3)  # recorded, no driver
    assert len(ad._drivers) == 2 and len(ad._seen) == 3
    del score, sc
    gc.collect()
    assert len(ad._drivers) == 1 and len(ad._seen) == 1
    sample(ts, kept, (3, 2), seed=1, device="cpu", eps_rel=0.3)
    assert len(ad._drivers) == 1  # the survivor's driver still hits


def test_bound_method_score_hits_while_its_object_lives():
    """A bound method is made anew at each attribute access: the cache
    refers to it through its object and function (``WeakMethod``)."""
    ts = tsde.VPSDE()

    class Net:
        def __init__(self):
            self.fn = tan.gaussian_score(ts, MU, S0)

        def score(self, x, t):
            return self.fn(x, t)

    net = Net()
    sample(ts, net.score, (3, 2), seed=4, device="cpu", eps_rel=0.3)
    a = sample(ts, net.score, (3, 2), seed=4, device="cpu", eps_rel=0.3)
    drv = next(iter(ad._drivers.values()))
    b = sample(ts, net.score, (3, 2), seed=4, device="cpu", eps_rel=0.3)
    assert len(ad._drivers) == 1 and next(iter(ad._drivers.values())) is drv
    _assert_same(a, b)
    del net
    gc.collect()
    assert not ad._drivers


def test_score_object_with_eq_is_keyed_by_identity():
    """A score object that defines ``__eq__`` (so no ``__hash__``) hits by
    identity; an equal twin is another key."""
    ts = tsde.VPSDE()

    @dataclasses.dataclass
    class Score:
        scale: float

        def __call__(self, x, t):
            return self.scale * tan.gaussian_score(ts, MU, S0)(x, t)

    a, twin = Score(1.0), Score(1.0)
    first = sample(ts, a, (3, 2), seed=1, device="cpu", eps_rel=0.3)
    again = sample(ts, a, (3, 2), seed=1, device="cpu", eps_rel=0.3)
    assert len(ad._drivers) == 1
    _assert_same(first, again)
    sample(ts, twin, (3, 2), seed=1, device="cpu", eps_rel=0.3)
    assert len(ad._drivers) == 1 and len(ad._seen) == 2  # the twin's first solve
    sample(ts, twin, (3, 2), seed=1, device="cpu", eps_rel=0.3)
    assert len(ad._drivers) == 2


def test_score_without_a_weak_reference_is_solved_uncached():
    ts = tsde.VPSDE()

    class Slotted:
        __slots__ = ("fn",)

        def __init__(self):
            self.fn = tan.gaussian_score(ts, MU, S0)

        def __call__(self, x, t):
            return self.fn(x, t)

    score = Slotted()
    res = sample(ts, score, (4, 3), seed=2, device="cpu", eps_rel=0.05)
    res = sample(ts, score, (4, 3), seed=2, device="cpu", eps_rel=0.05)
    assert not ad._drivers and not ad._seen  # never recorded: always host-driven
    want, _ = _host_chain(ts, score, (4, 3), 2, ad.AdaptiveConfig(eps_rel=0.05))
    _assert_same(res, want)


@pytest.mark.parametrize("source, noise_fn, sharding, want", [
    ("streams", None, None, True),
    ("streams", lambda x: x, None, False),
    ("streams", None, "mesh", False),
    ("streams", None, "nccl_mesh", True),
    ("streams", None, "cpu_mesh", True),
    ("generator", None, None, False),
    ("generator", None, "cpu_mesh", False),
    ("per_slot", None, None, False),
])
def test_graphable_is_the_one_rule(source, noise_fn, sharding, want, monkeypatch):
    """"mesh" is a gloo mesh on the card (its collectives cannot be
    captured: host-driven), "nccl_mesh" an NCCL one on the card,
    "cpu_mesh" a mesh on the CPU (the plain driver, any backend)."""
    gen = {"streams": seed_streams(0, 2, "cpu"), "generator": torch.Generator(),
           "per_slot": [torch.Generator(), torch.Generator()]}[source]
    if sharding is not None:
        backend = {"mesh": "gloo", "nccl_mesh": "nccl", "cpu_mesh": "gloo"}[sharding]
        device = torch.device("cpu" if sharding == "cpu_mesh" else "cuda")
        mesh = types.SimpleNamespace(device=device, group=lambda: backend)
        monkeypatch.setattr(ad.dist, "get_backend", lambda group: group)
        sharding = types.SimpleNamespace(mesh=mesh)
    assert ad.graphable(gen, noise_fn, sharding) is want


@pytest.mark.parametrize("method", FAMILIES)
def test_noise_fn_keeps_the_host_driven_loop(method):
    """A ``noise_fn`` (Python a graph cannot call) runs ``solve_chunk``'s
    chain: no driver is built."""
    ts = tsde.VPSDE()
    g = torch.Generator().manual_seed(0)
    res = sample(ts, tan.gaussian_score(ts, MU, S0), (3, 2), seed=0, method=method,
                 device="cpu", eps_rel=0.3,
                 noise_fn=lambda x: torch.randn(x.shape, generator=g))
    assert not ad._drivers and torch.isfinite(res.x).all()


def test_fixed_grid_noise_comes_from_a_generator_seeded_seed():
    """EM's noise: the seed's per-row streams from counter 1, after their
    prior at counter 0 (every method draws from the streams now; a
    ``torch.Generator`` reaches a solver only from a caller who passes
    one)."""
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    from repro_torch.core.solvers import get_solver

    got = sample(ts, score, (3, 4), seed=6, method="em", device="cpu", n_steps=5)
    st = seed_streams(6, 3, "cpu")
    x0 = ts.prior_sample((3, 4), st)
    want = get_solver("em")(ts, score, x0, st.advanced(1), device="cpu", n_steps=5)
    assert torch.equal(got.x, want.x)
    other = get_solver("em")(ts, score, x0, torch.Generator().manual_seed(6), device="cpu",
                             n_steps=5)
    assert not torch.equal(got.x, other.x)
    # sample() and the direct call share one key: the second built its driver
    assert len(ad._drivers) == len(ad._seen) == 1


def test_host_syncs_count_the_window_read():
    ts = tsde.VPSDE()
    score = tan.gaussian_score(ts, MU, S0)
    cfg = ad.AdaptiveConfig(eps_rel=0.05)
    st = seed_streams(0, 3, "cpu")
    carry = ad.init_carry(ts, ts.prior_sample((3, 2), st), st.advanced(1), config=cfg)
    before = ad.host_syncs
    first = ad.solve_graphed(ts, score, carry, config=cfg)  # host-driven: one read a group
    assert ad.host_syncs - before == -(-int(first.iterations) // ad.SYNC_EVERY) + 1
    before = ad.host_syncs
    out = ad.solve_graphed(ts, score, carry, config=cfg)
    # on the CPU the unit is one body iteration, which reads nothing: the
    # window's one read, as on the card
    assert ad.host_syncs - before == 1
    assert np.all(out.done.numpy())
