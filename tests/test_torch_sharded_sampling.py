"""Data-parallel adaptive sampling (``sample(mesh=)``) on the CPU.

Ranks are spawned processes in a gloo process group at world 2 and 4,
each with one thread. On every rank:

* ``sample(mesh=)`` and ``solve_in_chunks(mesh=)`` on the closed-form
  Gaussian score (VP and VE, plain and fused step math) against the
  port's unsharded ``sample`` in the same process: the rank's rows of x,
  nfe, accepted and rejected bitwise, iterations equal, and
  ``gather_result`` the whole unsharded batch bitwise. An indivisible
  batch (3) replicates and gives the same result.
* A small livened DiT (fused step, flash attention on their plain
  versions) at world 2, sharded against unsharded. This CPU gives each
  row of a dense product the same bits at any batch, so the result is
  bitwise; the test holds it to that and would show if it stopped being.
* With the reference's prior and noise injected (``adaptive(sharding=)``
  with a ``noise_fn`` replaying the reference's key threading, global
  draws cut to the rank's rows): decision for decision equal to the
  reference's ``sample(mesh=)`` on 4 forced host devices with an
  Auto-axes ``jax.sharding.Mesh`` (one subprocess): per-sample nfe,
  accepted and rejected exactly, iterations equal, x within the bounds
  of ``tests/test_torch_adaptive.py`` (rtol 1e-4, atol 1e-5·max|x|).

The fixed-grid baselines, the ODE and the zoo under a mesh are held in
``tests/test_torch_sharded_serving.py``.
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
from repro_torch.core.sampling import gather_result, sample, solve_in_chunks
from repro_torch.core.solvers import adaptive as tad
from repro_torch.launch.sharded_selftest import put_result, spawn_ranks
from repro_torch.models import dit as tdit
from repro_torch.parallel import init_mesh, sample_state_shardings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SDES = {"vp": lambda: tsde.VPSDE(), "ve": lambda: tsde.VESDE(sigma_max=10.0)}
SHAPE = (8, 16)
#: (sde, fused) of the reference comparison
REF_CASES = [("vp", False), ("vp", True), ("ve", True)]
DIT = tdit.DiTConfig(image_size=16, patch=4, d_model=64, num_layers=2, num_heads=4,
                     d_ff=128, use_flash=True)


def _same(got, want) -> bool:
    return all(torch.equal(getattr(got, f), getattr(want, f))
               for f in ("x", "nfe", "accepted", "rejected")) and \
        int(got.iterations) == int(want.iterations)


def _rows(res, rows):
    return type(res)(x=res.x[rows], nfe=res.nfe[rows], iterations=res.iterations,
                     accepted=res.accepted[rows], rejected=res.rejected[rows])


def _rank(rank, world, port, out_dir, ref_inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        mesh = init_mesh(world, 1, device="cpu")
        for name, make in SDES.items():
            sde = make()
            score = analytic.gaussian_score(sde)
            for fused in (False, True):
                kw = dict(seed=3, device="cpu", eps_rel=0.05, use_fused_kernel=fused)
                for batch in (SHAPE[0], 3):
                    shape = (batch, SHAPE[1])
                    want = sample(sde, score, shape, **kw)
                    got = sample(sde, score, shape, mesh=mesh, **kw)
                    rows = sample_state_shardings(mesh, batch, 2)[0].rows
                    chunked = solve_in_chunks(sde, score, shape, max_sync_iters=5,
                                              mesh=mesh, **kw)
                    out[(name, fused, batch)] = {
                        "rows": (rows.start, rows.stop),
                        "local_rows": got.x.shape[0],
                        "sharded": _same(got, _rows(want, rows)),
                        "gathered": _same(gather_result(got, mesh, batch), want),
                        "chunked": _same(chunked, got),
                        "rejected": int(want.rejected.sum())}
        if world == 2:
            sde = tsde.VPSDE()
            model = tdit.init_dit(DIT, torch.Generator().manual_seed(0))
            tdit.liven_zero_init(model, torch.Generator().manual_seed(1))
            score = tdit.make_score_fn(model, sde)
            kw = dict(seed=0, device="cpu", eps_rel=0.05, use_fused_kernel=True)
            shape = (4, DIT.image_size, DIT.image_size, DIT.channels)
            want = sample(sde, score, shape, **kw)
            got = gather_result(sample(sde, score, shape, mesh=mesh, **kw), mesh, 4)
            out["dit"] = {"bitwise": _same(got, want), "finite": bool(torch.isfinite(got.x).all()),
                          "nfe_equal": bool(torch.equal(got.nfe, want.nfe)),
                          "max_abs_diff": float((got.x - want.x).abs().max()),
                          "mean_abs": float(want.x.abs().mean())}
        if ref_inputs is not None:
            for name, fused in REF_CASES:
                inp = ref_inputs[(name, fused)]
                draws = iter(inp["z"])
                noise = lambda x: torch.from_numpy(next(draws)).reshape(x.shape)
                arr = sample_state_shardings(mesh, SHAPE[0], 2)[0]
                res = tad.adaptive(SDES[name](), analytic.gaussian_score(SDES[name]()),
                                   torch.from_numpy(inp["x0"]), sharding=arr,
                                   noise_fn=noise, device="cpu", eps_rel=0.05,
                                   use_fused_kernel=fused)
                full = gather_result(res, mesh, SHAPE[0])
                out[("ref", name, fused)] = {k: getattr(full, k).numpy() for k in
                                             ("x", "nfe", "accepted", "rejected", "iterations")}
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


_REFERENCE = r"""
import importlib, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import analytic as jan, sde as jsde
from repro.core.sampling import sample
jad = importlib.import_module("repro.core.solvers.adaptive")

shape, cases, seed = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()), ("data",))
sdes = {"vp": jsde.VPSDE(), "ve": jsde.VESDE(sigma_max=10.0)}
out = {}
for name, fused in cases:
    sde = sdes[name]
    cfg = jad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=fused)
    key = jax.random.PRNGKey(seed)
    res = jax.jit(lambda k: sample(sde, jan.gaussian_score(sde), tuple(shape), k,
                                   config=cfg, mesh=mesh))(key)
    assert len(res.x.sharding.device_set) == 4
    k_prior, k = jax.random.split(key)
    tag = f"{name}-{int(fused)}"
    out[tag + "/x0"] = np.asarray(sde.prior_sample(k_prior, tuple(shape)))
    zs = []
    for _ in range(int(res.iterations) + 8):  # the port's masked tail draws too
        k, sub = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(sub, tuple(shape), jnp.float32)))
    out[tag + "/z"] = np.stack(zs)
    for f in ("x", "nfe", "accepted", "rejected", "iterations"):
        out[f"{tag}/{f}"] = np.asarray(getattr(res, f))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sample(mesh=) on 4 forced devices, its prior and its
    noise stream, one subprocess."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE,
                           json.dumps([SHAPE, REF_CASES, 11]), str(path)],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def spawned(reference):
    ref_inputs = {(n, f): {"x0": reference[f"{n}-{int(f)}/x0"], "z": list(reference[f"{n}-{int(f)}/z"])}
                  for n, f in REF_CASES}
    return {2: spawn_ranks(_rank, 2, None), 4: spawn_ranks(_rank, 4, ref_inputs)}


@pytest.mark.parametrize("batch", [SHAPE[0], 3], ids=["divisible", "indivisible"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("name", sorted(SDES))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_is_unsharded_bitwise(spawned, world, name, fused, batch):
    ranks = spawned[world]
    for r in ranks:
        res = r[(name, fused, batch)]
        assert res["sharded"] and res["gathered"] and res["rejected"] > 0
        want_rows = batch // world if batch % world == 0 else batch
        assert res["local_rows"] == want_rows
    if batch % world == 0:  # every row has one owner
        starts = sorted(r[(name, fused, batch)]["rows"] for r in ranks)
        assert [s for s, _ in starts] == list(range(0, batch, batch // world))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("world", [2, 4])
def test_solve_in_chunks_is_sample(spawned, world, fused):
    for r in spawned[world]:
        for name in SDES:
            assert r[(name, fused, SHAPE[0])]["chunked"]


def test_livened_dit_at_world_2(spawned):
    for r in spawned[2]:
        res = r["dit"]
        assert res["finite"] and res["mean_abs"] > 1e-3
        assert res["nfe_equal"] and res["bitwise"], res


@pytest.mark.parametrize("name,fused", REF_CASES, ids=[f"{n}-{'fused' if f else 'plain'}"
                                                      for n, f in REF_CASES])
def test_matches_reference_sharded_sample(spawned, reference, name, fused):
    tag = f"{name}-{int(fused)}"
    for r in spawned[4]:
        got = r[("ref", name, fused)]
        for f in ("nfe", "accepted", "rejected"):
            np.testing.assert_array_equal(got[f], reference[f"{tag}/{f}"], err_msg=f)
        assert int(got["iterations"]) == int(reference[f"{tag}/iterations"])
        want_x = reference[f"{tag}/x"]
        np.testing.assert_allclose(got["x"], want_x, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(want_x).max())))
    assert int(reference[f"{tag}/rejected"].sum()) > 0
