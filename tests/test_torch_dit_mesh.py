"""The DiT under a ``("data", "model")`` mesh on the CPU: the DiT's
tensor-parallel rules (``launch/sample.py::_dit_param_shardings``, port
of the reference's :68-101) and the tensor-parallel forward
(``models/dit.py``: ``shard_dit``, ``forward(mesh=)``).

* The rules against the reference's ``_dit_param_shardings`` on a
  ``jax.sharding.AbstractMesh``, spec for spec on every leaf, at model
  sizes 1, 2, 4 and 16, without and with a pipeline axis ("pod" of 2),
  for a config whose heads split at 2 and 4 but not at 16, one with 6
  heads (split at 2 only), a class-conditional one, and one of 3 layers
  (the pipeline axis does not divide its repeat axis: the reference
  keeps those leaves replicated over it).
* Every model is the reference's ``init_dit`` tree, its zero-init leaves
  livened from a seed, carried across by ``params_from_jax``.
* At one rank (a mesh without process groups: no collective runs)
  ``shard_dit`` is the model bit for bit and ``forward(mesh=)`` the
  unsharded forward bit for bit.
* Over gloo, in one spawn of 4 ranks (one thread each), on the meshes
  (1, 4) and (2, 2), each rank with its rows of the batch: the 4-head
  config (1 head a rank at 4, 2 at 2) and the 6-head config (heads whole
  at 4, 3 a rank at 2) within ``sharded_selftest.TP_TOL``·(1 + max|out|)
  of the unsharded port, and within the fp32 DiT tolerance (1e-4,
  ``tests/test_torch_dit.py``) of the reference's ``dit_forward`` on the
  same weights and inputs; every rank's leaf shapes equal to the rules'
  ``local_shape``, every leaf the rank's slice of the whole model bit
  for bit; the forward's collectives: two all-reduces a layer where the
  heads split, one where they do not, and one all-gather of the
  modulation a layer.

The reference is imported inside the tests that run it, so that the
spawned ranks, which import this module, start without JAX.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.sample import _dit_param_shardings
from repro_torch.launch.sharded_selftest import TP_TOL, put_result, spawn_ranks
from repro_torch.models import dit as tdit
from repro_torch.parallel import Mesh, init_mesh
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import batch_sharding, tree_map_with_path

torch.set_num_threads(2)

CFGS = {"four": dict(image_size=8, patch=2, d_model=32, num_layers=4, num_heads=4, d_ff=64),
        "six": dict(image_size=8, patch=2, d_model=48, num_layers=2, num_heads=6, d_ff=96),
        "labels": dict(image_size=8, patch=2, d_model=32, num_layers=2, num_heads=4, d_ff=64,
                       num_classes=10),
        "three": dict(image_size=8, patch=2, d_model=32, num_layers=3, num_heads=4, d_ff=64)}
TP_CASES = ("four", "six")
MODEL_SIZES = (1, 2, 4, 16)
WORLD = 4
MESHES = ((1, 4), (2, 2))
B = 8


def _tree(name):
    """The reference's ``init_dit`` leaves of ``name``, the zero-init ones
    livened from a seed."""
    import jax

    from repro.models import dit as jdit

    tree = jax.tree_util.tree_map(np.asarray, jdit.init_dit(jdit.DiTConfig(**CFGS[name]),
                                                                jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    bump = lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32)
    for k in ("ada", "ada_b"):
        tree["layers"][k] = bump(tree["layers"][k])
    for k in ("final_ada", "final_ada_b", "patch_out"):
        tree[k] = bump(tree[k])
    return tree


def _model(tree, name):
    return tdit.params_from_jax(tree, tdit.DiTConfig(**CFGS[name]))


def _inputs(name):
    cfg = CFGS[name]
    rng = np.random.default_rng(3)
    s = cfg["image_size"]
    return (torch.from_numpy(rng.standard_normal((B, s, s, 3)).astype(np.float32)),
            torch.from_numpy(np.linspace(0.1, 1.0, B).astype(np.float32)))


def _specs(tree):
    out = {}
    tree_map_with_path(lambda path, sh: out.__setitem__("/".join(path), sh.spec), tree)
    return out


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("msize", MODEL_SIZES)
@pytest.mark.parametrize("name", sorted(CFGS))
def test_rules_match_reference(name, msize, pipeline):
    import jax
    from jax.sharding import AbstractMesh

    from repro.launch import sample as jsample
    from repro.models import dit as jdit

    sizes = (2, 1, msize) if pipeline else (1, msize)
    names = ("pod", "data", "model") if pipeline else ("data", "model")
    params_abs = jax.eval_shape(lambda k: jdit.init_dit(jdit.DiTConfig(**CFGS[name]), k),
                                jax.random.PRNGKey(0))
    jtree = jsample._dit_param_shardings(params_abs, AbstractMesh(sizes, names),
                                         pipeline_axis="pod" if pipeline else None)
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    mesh = Mesh(names, sizes, (0,) * len(sizes))
    got = _specs(_dit_param_shardings(tdit.DiTConfig(**CFGS[name]), mesh,
                                      pipeline_axis="pod" if pipeline else None))
    assert got == want


def test_one_rank_is_the_unsharded_model():
    model = _model(_tree("four"), "four")
    mesh = Mesh(("data", "model"), (1, 1), (0, 0))
    shard = tdit.shard_dit(model, _dit_param_shardings(model, mesh))
    for (n, a), (m, b) in zip(model.named_parameters(), shard.named_parameters()):
        assert n == m and torch.equal(a, b)
    x, t = _inputs("four")
    with torch.no_grad():
        coll.reset()
        got = shard(x, t, mesh=mesh)
        assert coll.counts() == {}
        assert torch.equal(got, model(x, t))


def _leaves(model, shardings):
    """(leaf, its sharding, its whole shape, name, stacked) for every leaf
    of ``model``, the blocks' leaves stacked."""
    full = tdit.dit_param_shapes(model.cfg)
    out = [(getattr(model, name), sh, full[name], name, False)
           for name, sh in shardings.items() if name != "layers"]
    for name, path in tdit.LAYER_PATHS.items():
        sh, shape = shardings["layers"], full["layers"]
        for k in path:
            sh, shape = sh[k], shape[k]
        stacked = torch.stack([getattr(b, name) for b in model.blocks])
        out.append((stacked, sh, shape, name, True))
    return out


def _rank(rank, world, port, out_dir, trees):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        for data, model_size in MESHES:
            mesh = init_mesh(data, model_size, device="cpu")
            for name in TP_CASES:
                full = _model(trees[name], name)
                shardings = _dit_param_shardings(full, mesh)
                shard = tdit.shard_dit(full, shardings)
                x, t = _inputs(name)
                rows = batch_sharding(mesh, B, 4).rows
                with torch.no_grad():
                    coll.reset()
                    y = shard(x[rows], t[rows], mesh=mesh)
                shapes_ok = sliced = True
                for leaf, sh, shape, leaf_name, stacked in _leaves(shard, shardings):
                    shapes_ok &= tuple(leaf.shape) == sh.local_shape(shape)
                    whole = (torch.stack([getattr(b, leaf_name) for b in full.blocks])
                             if stacked else getattr(full, leaf_name))
                    sliced &= torch.equal(leaf, sh.local(whole))
                out[(data, model_size, name)] = {
                    "y": y.numpy(), "rows": (rows.start, rows.stop), "shapes_ok": shapes_ok,
                    "sliced": sliced, "heads": shard.blocks[0].wq.shape[1],
                    "ops": coll.op_counts()}
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def trees():
    return {name: _tree(name) for name in TP_CASES}


@pytest.fixture(scope="module")
def spawned(trees):
    return spawn_ranks(_rank, WORLD, trees)


CASES = [(d, m, n) for d, m in MESHES for n in TP_CASES]


@pytest.mark.parametrize("data,msize,name", CASES)
def test_tensor_parallel_forward_matches_unsharded(spawned, trees, data, msize, name):
    x, t = _inputs(name)
    with torch.no_grad():
        want = _model(trees[name], name)(x, t).numpy()
    bound = TP_TOL * (1 + np.abs(want).max())
    for r in spawned:
        res = r[(data, msize, name)]
        a, b = res["rows"]
        np.testing.assert_allclose(res["y"], want[a:b], rtol=0, atol=bound)


@pytest.mark.parametrize("data,msize,name", CASES)
def test_tensor_parallel_forward_matches_reference(spawned, trees, data, msize, name):
    import jax
    import jax.numpy as jnp

    from repro.models import dit as jdit

    x, t = _inputs(name)
    want = np.asarray(jdit.dit_forward(jax.tree_util.tree_map(jnp.asarray, trees[name]),
                                       jnp.asarray(x.numpy()), jnp.asarray(t.numpy()),
                                       jdit.DiTConfig(**CFGS[name])))
    assert np.abs(want).max() > 1e-2  # the livened net carries signal
    for r in spawned:
        res = r[(data, msize, name)]
        a, b = res["rows"]
        np.testing.assert_allclose(res["y"], want[a:b], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("data,msize,name", CASES)
def test_rank_leaves_are_its_slices(spawned, data, msize, name):
    heads = CFGS[name]["num_heads"]
    want_heads = heads // msize if heads % msize == 0 else heads
    for r in spawned:
        res = r[(data, msize, name)]
        assert res["shapes_ok"] and res["sliced"]
        assert res["heads"] == want_heads


@pytest.mark.parametrize("data,msize,name", CASES)
def test_forward_collectives(spawned, data, msize, name):
    cfg = tdit.DiTConfig(**CFGS[name])
    heads_split = cfg.num_heads % msize == 0
    rows = B // data
    act = rows * cfg.tokens * cfg.d_model * 4
    reduces = cfg.num_layers * (2 if heads_split else 1)
    for r in spawned:
        ops = r[(data, msize, name)]["ops"]
        assert ops["all-reduce"] == (reduces, reduces * act)
        assert ops["all-gather"] == (cfg.num_layers, cfg.num_layers * rows * 6 * cfg.d_model * 4)
        assert set(ops) == {"all-reduce", "all-gather"}
