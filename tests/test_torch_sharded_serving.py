"""Data-parallel serving (``DiffusionBatcher(mesh=)``) and the baselines
under ``sample(mesh=)`` on the CPU.

Ranks are spawned processes in a gloo process group (one spawn at world
2, one at world 4, each rank with one thread; ``sharded_selftest.
spawn_ranks``). On every rank:

* The mesh server (2·world slots, 6·world requests, sync horizon 4)
  against the unsharded server at sync horizon 1: every request bitwise
  (x, nfe, accepted, rejected), host-driven and device-resident (the
  plain driver, its condition all-reduced over gloo after every
  horizon), untiered, and tiered under EDF with a telemetry ring and an
  inpainting condition (two draws an iteration). Each device refills past
  its first fill and the refills sum to the requests.
* Against the unsharded server at the same sync horizon (a fake clock
  of 1 s a read, read on rank 0 and broadcast): the same iterations, host
  reads and per-class books; device-resident, the same iterations as the
  host-driven mesh server with fewer reads. With compaction off the
  slots hold the same requests in both, and the gathered telemetry ring
  is the unsharded ring bitwise (a rank that idles through the end of a
  group catches its frozen rows up).
* em, pc, pc_hmc, ddim, ode, momentum and heun under ``sample(mesh=)``
  on the closed-form Gaussian score: the rank's rows bitwise the
  unsharded solve's, ``gather_result`` the whole batch.
* At world 4, parity with the reference's sharded ``DiffusionBatcher``
  on 4 forced host devices with an Auto-axes ``jax.sharding.Mesh`` (one
  subprocess): the port is fed the reference's priors and per-slot draws
  through ``request_streams``; per request nfe, accepted and rejected
  exactly equal, the iterations, host reads, per-device refills and
  per-class books too, and x within the bounds of
  ``tests/test_torch_adaptive.py`` (rtol 1e-4, atol 1e-5·max|x|),
  host-driven and device-resident.
"""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import analytic
from repro_torch.core import sde as tsde
from repro_torch.core.guidance import Inpaint
from repro_torch.core.sampling import gather_result, sample
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.launch.sample import make_sample_step
from repro_torch.launch.sharded_selftest import put_result, spawn_ranks
from repro_torch.parallel import init_mesh, sample_state_shardings
from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest
from repro_torch.serving.scheduler import EdfPriorityAdmission

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
TIERS = ("draft", "high_fidelity", None, "standard")
#: server cases: (tiered with telemetry and inpainting, device-resident)
CASES = {"plain": (False, False), "plain-resident": (False, True),
         "rich": (True, False), "rich-resident": (True, True)}
METHODS = {"em": dict(n_steps=30), "pc": dict(n_steps=30), "pc_hmc": dict(n_steps=30),
           "ddim": dict(n_steps=30), "ode": {}, "momentum": dict(eps_rel=0.05),
           "heun": dict(eps_rel=0.05)}
#: the reference comparison: 8 slots over 4 devices, 24 requests
REF_SLOTS, REF_REQUESTS, REF_DRAWS = 8, 24, 400


class FakeClock:
    """1 s a read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


class ReplayStreams:
    """``request_streams`` replaying each request's prior and per-slot draws
    computed by the reference (one (REF_DRAWS, D) array a request)."""

    def __init__(self, priors, zs):
        self.priors, self.zs = priors, zs

    def __call__(self, req, shape, device):
        draws = iter(self.zs[req.seed])
        return (torch.from_numpy(self.priors[req.seed]).to(device),
                lambda s: torch.from_numpy(next(draws)).reshape(s))


def _mask(uid: int):
    m = np.zeros(D, np.float32)
    m[uid % 4::4] = 1.0
    return {"mask": m, "observed": np.linspace(-0.5, 0.5, D, dtype=np.float32)}


def _server(*, tiered: bool, mesh=None, slots: int, horizon: int, resident: bool = False,
            compaction: bool = True, telemetry: int = 0, inpaint: bool = False, **kw):
    sde = tsde.VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05, conditioner=Inpaint() if inpaint else None)
    fwd = analytic.gaussian_noise_pred(sde)
    step = make_sample_step(sde, cfg, forward_fn=lambda p, x, t: fwd(x, t))
    return DiffusionBatcher(sde, step, None, (D,), slots=slots, cfg=cfg, mesh=mesh,
                            sync_horizon=horizon, device_resident=resident,
                            compaction=compaction, tolerance_classes=True if tiered else None,
                            admission=EdfPriorityAdmission(aging_s=5.0) if tiered else None,
                            telemetry=telemetry, clock=FakeClock(), device="cpu", **kw)


def _drain(b, n_req: int, *, tiered: bool, inpaint: bool) -> dict:
    for u in range(n_req):
        b.submit(ImageRequest(uid=u, seed=1000 + u, tier=TIERS[u % 4] if tiered else None,
                              cond=_mask(u) if inpaint else None))
    done = b.run_to_completion()
    return {u: (r.result, r.nfe, r.accepted, r.rejected) for u, r in done.items()}


def _books(b) -> dict:
    return {"iterations": b.total_iterations, "host_transfers": b.host_transfers,
            "class_stats": b.class_stats, "refills": list(b.refills_per_device),
            "slots_per_device": b.slots_per_device, "n_devices": b.n_devices,
            "wasted": b.wasted_nfe_fraction}


def _serve_cases(mesh, world: int) -> dict:
    slots, n_req = 2 * world, 6 * world
    out = {}
    for name, (rich, resident) in CASES.items():
        opts = dict(tiered=rich, telemetry=64 if rich else 0, inpaint=rich)
        drain = lambda b: _drain(b, n_req, tiered=rich, inpaint=rich)
        m = _server(mesh=mesh, slots=slots, horizon=4, resident=resident, **opts)
        got = drain(m)
        other = _server(slots=slots, horizon=1, **opts)  # another horizon
        same = _server(slots=slots, horizon=4, resident=resident, **opts)
        out[name] = {"mesh": got, "other_horizon": drain(other), "mesh_books": _books(m),
                     "same_books": (drain(same), _books(same))[1]}
    # compaction off: the slots hold the same requests, so the gathered ring
    # is the unsharded ring
    for resident in (False, True):
        opts = dict(tiered=True, telemetry=16, inpaint=True, compaction=False)
        m = _server(mesh=mesh, slots=slots, horizon=4, resident=resident, **opts)
        u = _server(slots=slots, horizon=4, resident=resident, **opts)
        results = [_drain(b, n_req, tiered=True, inpaint=True) for b in (m, u)]
        out[("ring", resident)] = {"results": results,
                                   "rings": [b.trace_record()["telemetry"] for b in (m, u)]}
    return out


def _baselines(mesh) -> dict:
    sde = tsde.VPSDE()
    score = analytic.gaussian_score(sde)
    out = {}
    for method, kw in METHODS.items():
        shape = (8, 16)
        want = sample(sde, score, shape, seed=5, method=method, device="cpu", **kw)
        got = sample(sde, score, shape, seed=5, method=method, device="cpu", mesh=mesh, **kw)
        rows = sample_state_shardings(mesh, shape[0], 2)[0].rows
        full = gather_result(got, mesh, shape[0])
        fields = ("x", "nfe", "accepted", "rejected")
        out[method] = {
            "local_rows": got.x.shape[0],
            "rows": all(torch.equal(getattr(got, f), getattr(want, f)[rows]) for f in fields),
            "gathered": all(torch.equal(getattr(full, f), getattr(want, f)) for f in fields),
            "iterations": int(got.iterations) == int(want.iterations),
            "finite": bool(torch.isfinite(want.x).all()),
        }
    return out


def _reference_parity(mesh, ref_inputs) -> dict:
    out = {}
    streams = ReplayStreams(ref_inputs["priors"], ref_inputs["zs"])
    for resident in (False, True):
        b = _server(tiered=True, mesh=mesh, slots=REF_SLOTS, horizon=4, resident=resident,
                    telemetry=16, request_streams=streams)
        done = _drain(b, REF_REQUESTS, tiered=True, inpaint=False)
        out[resident] = {"done": done, "books": _books(b)}
    return out


def _rank(rank, world, port, out_dir, ref_inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_mesh(world, 1, device="cpu")
        out = {"serve": _serve_cases(mesh, world), "baselines": _baselines(mesh)}
        if ref_inputs is not None:
            out["reference"] = _reference_parity(mesh, ref_inputs)
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import AdaptiveConfig, VPSDE
from repro.core.analytic import gaussian_noise_pred
from repro.launch.sample import make_sample_step
from repro.models.dit import DiTConfig
from repro.serving.diffusion_server import DiffusionBatcher, ImageRequest
from repro.serving.scheduler import EdfPriorityAdmission

slots, n_req, n_draws, d, tiers = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()), ("data",))
sde = VPSDE()
cfg = AdaptiveConfig(eps_rel=0.05)
net = DiTConfig(image_size=4, patch=4, d_model=8, num_layers=1, num_heads=1, d_ff=8)
step = make_sample_step(net, sde, cfg, forward_fn=gaussian_noise_pred(sde))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


out = {}
for resident in (False, True):
    b = DiffusionBatcher(sde, step, params=None, sample_shape=(d,), slots=slots, cfg=cfg,
                         mesh=mesh, sync_horizon=4, device_resident=resident,
                         tolerance_classes=True, admission=EdfPriorityAdmission(aging_s=5.0),
                         telemetry=16, clock=FakeClock())
    for u in range(n_req):
        b.submit(ImageRequest(uid=u, seed=1000 + u, tier=tiers[u % len(tiers)]))
    done = b.run_to_completion()
    assert len(b._carry.x.sharding.device_set) == 4
    tag = f"r{int(resident)}"
    for u in range(n_req):
        for f in ("result", "nfe", "accepted", "rejected"):
            out[f"{tag}/{u}/{f}"] = np.asarray(getattr(done[u], f))
    out[f"{tag}/books"] = np.array(json.dumps({
        "iterations": b.total_iterations, "host_transfers": b.host_transfers,
        "refills": list(b.refills_per_device), "class_stats": b.class_stats}))



def split_normal(k, _):
    pairs = jax.random.split(k)
    return pairs[0], jax.random.normal(pairs[1], (d,), jnp.float32)


draws = jax.jit(lambda k: jax.lax.scan(split_normal, k, None, length=n_draws)[1])
for u in range(n_req):
    k_prior, k = jax.random.split(jax.random.PRNGKey(1000 + u))
    out[f"prior/{u}"] = np.asarray(sde.prior_sample(k_prior, (d,)))
    out[f"z/{u}"] = np.asarray(draws(k))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded DiffusionBatcher on 4 forced devices, with
    the priors and per-slot draws of its requests, one subprocess."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    args = [REF_SLOTS, REF_REQUESTS, REF_DRAWS, D, list(TIERS)]
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(args), str(path)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def spawned(reference):
    ref_inputs = {"priors": {1000 + u: reference[f"prior/{u}"] for u in range(REF_REQUESTS)},
                  "zs": {1000 + u: reference[f"z/{u}"] for u in range(REF_REQUESTS)}}
    return {2: spawn_ranks(_rank, 2, None), 4: spawn_ranks(_rank, 4, ref_inputs)}


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for u in want:
        assert np.array_equal(got[u][0], want[u][0]), u
        assert got[u][1:] == want[u][1:], u


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_mesh_serve_is_unsharded_bitwise(spawned, world, case):
    """Every request bitwise the unsharded server's at another horizon, on
    every rank (every rank's ``finished`` holds every request)."""
    for r in spawned[world]:
        res = r["serve"][case]
        assert len(res["mesh"]) == 6 * world
        _same(res["mesh"], res["other_horizon"])
        assert all(np.isfinite(v[0]).all() for v in res["mesh"].values())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_refills_per_device(spawned, world, case):
    for r in spawned[world]:
        books = r["serve"][case]["mesh_books"]
        assert books["n_devices"] == world and books["slots_per_device"] == 2
        assert len(books["refills"]) == world
        assert all(n > books["slots_per_device"] for n in books["refills"]), books["refills"]
        assert sum(books["refills"]) == 6 * world


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_mesh_books_are_the_unsharded_servers(spawned, world, case):
    """At the same horizon: the same iterations, host reads and per-class
    books (the clock is rank 0's, read as often as unsharded), the same
    on every rank."""
    ranks = spawned[world]
    for r in ranks:
        mesh, same = r["serve"][case]["mesh_books"], r["serve"][case]["same_books"]
        for k in ("iterations", "host_transfers", "class_stats", "wasted"):
            assert mesh[k] == same[k], k
        assert mesh == ranks[0]["serve"][case]["mesh_books"]


@pytest.mark.parametrize("rich", [False, True], ids=["plain", "rich"])
@pytest.mark.parametrize("world", [2, 4])
def test_device_resident_reads_fewer_with_equal_iterations(spawned, world, rich):
    name = "rich" if rich else "plain"
    for r in spawned[world]:
        host = r["serve"][name]
        res = r["serve"][f"{name}-resident"]
        _same(res["mesh"], host["mesh"])
        assert res["mesh_books"]["iterations"] == host["mesh_books"]["iterations"]
        assert res["mesh_books"]["host_transfers"] < host["mesh_books"]["host_transfers"]


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("world", [2, 4])
def test_telemetry_ring_is_the_unsharded_ring(spawned, world, resident):
    for r in spawned[world]:
        res = r["serve"][("ring", resident)]
        _same(*res["results"])
        got, want = res["rings"]
        assert got["records"] == want["records"] > 0
        for k in ("t", "h", "err", "accept", "iterations", "records"):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("world", [2, 4])
def test_solver_under_a_mesh_is_unsharded_bitwise(spawned, world, method):
    """Every registered solver is data-parallel: the rank's rows bitwise,
    ``gather_result`` the whole batch."""
    for r in spawned[world]:
        res = r["baselines"][method]
        assert res["local_rows"] == 8 // world
        assert res["finite"] and res["rows"] and res["gathered"] and res["iterations"], res


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_matches_reference_sharded_batcher(spawned, reference, resident):
    tag = f"r{int(resident)}"
    want_books = json.loads(str(reference[f"{tag}/books"]))
    for r in spawned[4]:
        got = r["reference"][resident]
        for u in range(REF_REQUESTS):
            x, nfe, acc, rej = got["done"][u]
            assert (nfe, acc, rej) == tuple(int(reference[f"{tag}/{u}/{f}"]) for f in
                                            ("nfe", "accepted", "rejected")), u
            want_x = reference[f"{tag}/{u}/result"]
            np.testing.assert_allclose(x, want_x, rtol=1e-4,
                                       atol=1e-5 * max(1.0, float(np.abs(want_x).max())))
        books = got["books"]
        assert books["iterations"] == want_books["iterations"]
        assert books["host_transfers"] == want_books["host_transfers"]
        assert books["refills"] == want_books["refills"]
        assert json.loads(json.dumps(books["class_stats"])) == want_books["class_stats"]
