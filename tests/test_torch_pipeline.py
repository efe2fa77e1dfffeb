"""The GPipe pipeline (``repro_torch/parallel/pipeline.py``) against the
reference's (``repro/parallel/pipeline.py``) and against the layer loop,
on the CPU.

* The mirror of ``tests/test_pipeline.py``: the same stacked-MLP body,
  ported, on numpy inputs. At one stage ``pipeline_forward`` is bitwise
  the layer loop run microbatch by microbatch, at M 1, 2 and 4, and
  within the reference's 1e-5 of the whole-batch loop and of the
  reference's ``pipeline_forward`` (on its host mesh, axis "data").
* Past the reference, which checks several stages only by compiling
  them: 2 and 4 stages over gloo, in one spawn of 4 ranks (one thread
  each) on the ("pod", "data", "model") meshes (2, 2, 1), two pipelines
  of 2 stages side by side, and (4, 1, 1). Every rank's output is
  bitwise the loop run microbatch by microbatch and within 1e-5 of the
  whole-batch loop. Each stage but the last books M handoffs, the last
  none, and every rank one broadcast.
* The pipelined DiT (``launch/sample.py::make_pipelined_dit_forward``) on
  the reference's ``init_dit`` leaves, livened and carried across by
  ``params_from_jax``: at one stage within the fp32 DiT tolerance
  (1e-4, ``tests/test_torch_dit.py``) of the reference's
  ``make_pipelined_dit_forward`` (on an Auto-axes (1, 1, 1) mesh) and
  bitwise the port's whole model run microbatch by microbatch
  (``sharded_selftest.microbatched_forward``, check 7's expected
  value); at 2 and 4 stages,
  each rank holding its stage's blocks, bitwise that one-stage run.
* The ``ValueError``s: layers that do not split into the stages (also a
  3-layer DiT over 2 stages, whose leaves the rules keep whole), a batch
  that does not split into the microbatches, a stage's DiT run whole.

The reference is imported inside the tests that run it, so that the
spawned ranks, which import this module, start without JAX.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.sample import _dit_param_shardings, make_pipelined_dit_forward
from repro_torch.launch.sharded_selftest import microbatched_forward, put_result, spawn_ranks
from repro_torch.models import dit as tdit
from repro_torch.parallel import Mesh, init_mesh
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.pipeline import pipeline_forward, stage_layers

torch.set_num_threads(2)

R, D, B = 8, 16, 8
MICROBATCHES = (1, 2, 4)
#: the spawn's meshes over ("pod", "data", "model"), by stage count
WORLD = 4
MESHES = {2: (2, 2, 1), 4: (4, 1, 1)}
DIT = dict(image_size=16, patch=4, d_model=32, num_layers=4, num_heads=4, d_ff=64)
TCFG = tdit.DiTConfig(**DIT)
DIT_M = 4
ONE_STAGE = Mesh(("pod", "data", "model"), (1, 1, 1), (0, 0, 0))


def _mlp():
    rng = np.random.default_rng(0)
    w = lambda: (0.3 * rng.standard_normal((R, D, D))).astype(np.float32)
    return {"w1": w(), "w2": w()}, rng.standard_normal((B, D)).astype(np.float32)


def _jbody(stage_params, x):
    """The reference test's body: a scan over the stage's blocks."""
    import jax

    def block(x, p):
        h = jax.nn.gelu(x @ p["w1"])
        return x + h @ p["w2"], None

    return jax.lax.scan(block, x, stage_params)[0]


def _stage(params, layers):
    """The body, ported: the blocks of ``layers`` in turn."""
    def stage(x):
        for r in layers:
            h = F.gelu(x @ params["w1"][r], approximate="tanh")
            x = x + h @ params["w2"][r]
        return x

    return stage


def _loop(params, x, M):
    """The layer loop over every block, microbatch by microbatch."""
    body = _stage(params, range(R))
    return torch.cat([body(xb) for xb in x.chunk(M)])


def _dit_tree():
    import jax

    from repro.models import dit as jdit

    tree = jax.tree_util.tree_map(np.asarray, jdit.init_dit(jdit.DiTConfig(**DIT),
                                                                jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    bump = lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32)
    for k in ("ada", "ada_b"):
        tree["layers"][k] = bump(tree["layers"][k])
    for k in ("final_ada", "final_ada_b", "patch_out"):
        tree[k] = bump(tree[k])
    return tree


def _dit_inputs():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
            np.linspace(0.1, 1.0, B).astype(np.float32))


@pytest.fixture(scope="module")
def mlp():
    params, x = _mlp()
    return params, x, {k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x)


@pytest.mark.parametrize("microbatches", MICROBATCHES)
def test_single_stage_equals_layer_loop(mlp, microbatches):
    import jax.numpy as jnp

    from repro.launch.mesh import make_host_mesh
    from repro.parallel.pipeline import pipeline_forward as jpipeline_forward

    jparams, jx, params, x = mlp
    got = pipeline_forward(_stage(params, stage_layers(R, ONE_STAGE)), x, mesh=ONE_STAGE,
                           num_microbatches=microbatches)
    assert torch.equal(got, _loop(params, x, microbatches))
    whole = _loop(params, x, 1).numpy()
    np.testing.assert_allclose(got.numpy(), whole, rtol=1e-5, atol=1e-5)
    with make_host_mesh():  # data axis of size 1: one pipeline stage
        want = jpipeline_forward(jparams, jnp.asarray(jx), _jbody, axis="data",
                                 num_microbatches=microbatches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_value_errors(mlp):
    _, _, params, x = mlp
    four = Mesh(("pod", "data", "model"), (4, 1, 1), (1, 0, 0))
    with pytest.raises(ValueError, match="do not split into 4 stages"):
        stage_layers(6, four)
    assert stage_layers(R, four) == range(2, 4)
    with pytest.raises(ValueError, match="does not split into 3 microbatches"):
        pipeline_forward(_stage(params, range(R)), x, mesh=ONE_STAGE, num_microbatches=3)
    stage_mesh = Mesh(("pod", "data", "model"), (2, 1, 1), (0, 0, 0))
    model = tdit.DiT(TCFG, shardings=_dit_param_shardings(TCFG, stage_mesh, pipeline_axis="pod"))
    assert model.layer_range == range(0, 2) and len(model.blocks) == 2
    xs, ts = (torch.from_numpy(a) for a in _dit_inputs())
    with pytest.raises(ValueError, match="pipeline stage"):
        model(xs, ts)
    three = tdit.DiTConfig(**{**DIT, "num_layers": 3})
    whole = tdit.DiT(three, shardings=_dit_param_shardings(three, stage_mesh,
                                                           pipeline_axis="pod"))
    assert whole.layer_range == range(3)  # 2 stages do not divide 3 layers
    with pytest.raises(ValueError, match="do not split into 2 stages"):
        make_pipelined_dit_forward(whole, mesh=stage_mesh)


def test_pipelined_dit_one_stage_matches_reference():
    import jax
    import jax.numpy as jnp

    from repro.launch import sample as jsample
    from repro.models import dit as jdit

    tree = _dit_tree()
    xs, ts = _dit_inputs()
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                              ("pod", "data", "model"))
    jfwd = jsample.make_pipelined_dit_forward(jdit.DiTConfig(**DIT), num_microbatches=DIT_M,
                                              axis="pod")
    with jmesh:
        want = np.asarray(jfwd(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(xs),
                               jnp.asarray(ts)))
    model = tdit.params_from_jax(tree, TCFG)
    fwd = make_pipelined_dit_forward(model, num_microbatches=DIT_M, mesh=ONE_STAGE)
    x, t = torch.from_numpy(xs), torch.from_numpy(ts)
    with torch.no_grad():
        got = fwd(model, x, t)
        assert torch.equal(got, microbatched_forward(model, x, t, DIT_M))
    assert np.abs(want).max() > 1e-2  # the livened net carries signal
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _rank(rank, world, port, out_dir, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        params = {k: torch.from_numpy(v) for k, v in payload["mlp"].items()}
        x = torch.from_numpy(payload["x"])
        full = tdit.params_from_jax(payload["tree"], TCFG)
        out = {}
        for stages, sizes in MESHES.items():
            mesh = init_mesh(sizes[1], sizes[2], device="cpu", pod=sizes[0])
            res = out[stages] = {"stage": mesh.coord("pod"), "mlp": {}}
            stage = _stage(params, stage_layers(R, mesh))
            for m in MICROBATCHES:
                coll.reset()
                y = pipeline_forward(stage, x, mesh=mesh, num_microbatches=m)
                res["mlp"][m] = {"y": y.numpy(), "books": coll.counts()}
            model = tdit.shard_dit(full, _dit_param_shardings(TCFG, mesh, pipeline_axis="pod"))
            fwd = make_pipelined_dit_forward(model, num_microbatches=DIT_M, mesh=mesh)
            with torch.no_grad():
                res["dit"] = fwd(model, *(torch.from_numpy(a)
                                          for a in payload["dit_inputs"])).numpy()
            res["layers"] = list(model.layer_range)
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def staged():
    params, x = _mlp()
    payload = {"mlp": params, "x": x, "tree": _dit_tree(), "dit_inputs": _dit_inputs()}
    ranks = spawn_ranks(_rank, WORLD, payload)
    return {stages: [r[stages] for r in ranks] for stages in MESHES}


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("microbatches", MICROBATCHES)
def test_stages_over_gloo_equal_the_layer_loop(staged, mlp, world, microbatches):
    _, _, params, x = mlp
    want = _loop(params, x, microbatches).numpy()
    whole = _loop(params, x, 1).numpy()
    for r in staged[world]:
        got = r["mlp"][microbatches]["y"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_handoffs_booked_per_boundary(staged, world):
    """M sends a boundary, booked by the sender; one broadcast a rank."""
    for r in staged[world]:
        for m in MICROBATCHES:
            books = r["mlp"][m]["books"]
            sent = books.get("stage_handoff", (0, 0))
            mb_bytes = (B // m) * D * 4
            want = (m, m * mb_bytes) if r["stage"] < world - 1 else (0, 0)
            assert sent == want
            assert books["stage_broadcast"] == (1, B * D * 4)
    assert sorted(r["stage"] for r in staged[world]) == sorted(
        list(range(world)) * (WORLD // world))


@pytest.mark.parametrize("world", sorted(MESHES))
def test_pipelined_dit_stages_bitwise_one_stage(staged, world):
    tree = _dit_tree()
    model = tdit.params_from_jax(tree, TCFG)
    x, t = (torch.from_numpy(a) for a in _dit_inputs())
    with torch.no_grad():
        want = make_pipelined_dit_forward(model, num_microbatches=DIT_M,
                                          mesh=ONE_STAGE)(model, x, t).numpy()
    per = TCFG.num_layers // world
    for r in staged[world]:
        assert r["layers"] == list(range(r["stage"] * per, (r["stage"] + 1) * per))
        np.testing.assert_array_equal(r["dit"], want)
