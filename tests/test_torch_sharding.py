"""Port ↔ reference parity: which rows of each leaf a rank owns
(``repro_torch.parallel.sharding``).

The reference's shardings are ``NamedSharding``s of a JAX mesh; the
port's say which rows this rank holds. For every device of the
reference's mesh, the rows its ``devices_indices_map`` gives must be the
rows the port's rules give the rank at the same mesh coordinate, and
the specs must agree. Checked in process on a 1-device mesh, and on 2
and 4 forced host devices in one subprocess (the device count of a JAX
process is fixed when JAX starts). The meshes are built as
``jax.sharding.Mesh`` (Auto axes): ``jax.make_mesh`` builds Explicit
axes under jax 0.9.0, which the reference's mesh code does not take
(ROADMAP §C).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.solver_step.ops import feature_range
from repro_torch.parallel import (
    Mesh, batch_sharding, data_axes, replicated, sample_state_shardings,
    solver_carry_shardings,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (axis names, sizes) of the meshes checked on forced devices
MESHES = [(("data",), (2,)), (("data",), (4,)), (("data", "model"), (2, 2)),
          (("data", "model"), (1, 4)), (("data", "model"), (4, 1)),
          (("pod", "data", "model"), (2, 2, 1)), (("pod", "data", "model"), (2, 1, 2))]
BATCHES = [8, 6, 3, 1]
COND_NDIMS = {"y": 1, "mask": 3}

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.parallel import sharding as S

def rows(sh, shape):
    out = {}
    for pos in np.ndindex(sh.mesh.devices.shape):
        key = ",".join(map(str, pos))
        if not shape:  # a scalar leaf: whole on every device
            out[key] = None
            continue
        sl = sh.devices_indices_map(shape)[sh.mesh.devices[pos]][0]
        out[key] = [sl.start or 0, shape[0] if sl.stop is None else sl.stop]
    return out

def spec(sh):
    return [list(e) if isinstance(e, tuple) else ([e] if isinstance(e, str) else None)
            for e in tuple(sh.spec)]

meshes, batches, cond_ndims = json.loads(sys.argv[1])
out = []
for names, sizes in meshes:
    n = int(np.prod(sizes))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(sizes), tuple(names))
    for b in batches:
        arr, vec, rep = S.sample_state_shardings(mesh, b, 4)
        cond = {k: jax.ShapeDtypeStruct((b,) + (2,) * (d - 1), jnp.float32)
                for k, d in cond_ndims.items()}
        carry = S.solver_carry_shardings(mesh, b, 4, cond=cond, tolerances=True)
        leaves = {"x": (arr, (b, 2, 2, 2)), "t": (vec, (b,)),
                  "nfe": (carry.nfe, (b,)), "done": (carry.done, (b,)),
                  "atol": (carry.atol, (b,)), "rtol": (carry.rtol, (b,)),
                  "x_prev": (carry.x_prev, (b, 2, 2, 2)),
                  "iterations": (carry.iterations, ())}
        leaves.update({"cond." + k: (carry.cond[k], cond[k].shape) for k in cond})
        out.append({"names": names, "sizes": sizes, "batch": b,
                    "data_axes": list(S.data_axes(mesh)),
                    "rep_spec": spec(rep),
                    "leaves": {k: {"spec": spec(s), "rows": rows(s, shape)}
                               for k, (s, shape) in leaves.items()}})
print(json.dumps(out))
"""


def _reference_layouts(n_devices: int, meshes) -> list:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE,
                           json.dumps([meshes, BATCHES, COND_NDIMS])],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _norm(spec) -> list:
    """A spec as lists of axis names per dimension (None: not sharded)."""
    return [list(e) if isinstance(e, tuple) else ([e] if isinstance(e, str) else None)
            for e in tuple(spec)]


def _spec(s) -> list:
    return _norm(s.spec)


def _rows(s, batch):
    r = s.rows
    return [r.start or 0, batch if r.stop is None else r.stop]


def _port_layout(names, sizes, pos, batch):
    mesh = Mesh(tuple(names), tuple(sizes), tuple(pos))
    arr, vec, rep = sample_state_shardings(mesh, batch, 4)
    cond = {k: torch.zeros((batch,) + (2,) * (d - 1)) for k, d in COND_NDIMS.items()}
    carry = solver_carry_shardings(mesh, batch, 4, cond=cond, tolerances=True)
    leaves = {"x": arr, "t": vec, "nfe": carry.nfe, "done": carry.done,
              "atol": carry.atol, "rtol": carry.rtol, "x_prev": carry.x_prev,
              "iterations": carry.iterations}
    leaves.update({"cond." + k: carry.cond[k] for k in cond})
    return mesh, rep, leaves


def _assert_same_layouts(ref_layouts):
    checked = 0
    for case in ref_layouts:
        b = case["batch"]
        for key in next(iter(case["leaves"].values()))["rows"]:
            pos = tuple(int(i) for i in key.split(","))
            mesh, rep, leaves = _port_layout(case["names"], case["sizes"], pos, b)
            assert list(data_axes(mesh)) == case["data_axes"]
            assert _spec(rep) == case["rep_spec"] == []
            for name, s in leaves.items():
                want = case["leaves"][name]
                assert _spec(s) == want["spec"], (case["names"], case["sizes"], b, name)
                if name == "iterations":
                    assert want["rows"][key] is None
                    assert s.batch is None and s.rows == slice(None)
                else:
                    assert _rows(s, b) == want["rows"][key], (case["sizes"], b, name, pos)
                checked += 1
    return checked


def test_layouts_match_reference_on_one_device():
    """In process: the conftest pins one CPU device."""
    import jax
    from jax.sharding import Mesh as JMesh

    from repro.parallel import sharding as S

    assert jax.device_count() == 1
    for names in (("data",), ("data", "model")):
        jmesh = JMesh(np.array(jax.devices()).reshape((1,) * len(names)), names)
        mesh = Mesh(names, (1,) * len(names), (0,) * len(names))
        for b in BATCHES:
            for ndim in (1, 2, 4):
                ref = S.batch_sharding(jmesh, b, ndim)
                port = batch_sharding(mesh, b, ndim)
                shape = (b,) + (3,) * (ndim - 1)
                idx = ref.devices_indices_map(shape)[jax.devices()[0]][0]
                assert _spec(port) == _norm(ref.spec)
                assert _rows(port, b) == [idx.start or 0, b if idx.stop is None else idx.stop]
        assert tuple(S.data_axes(jmesh)) == data_axes(mesh)
        assert tuple(S.replicated(jmesh).spec) == replicated(mesh).spec == ()


@pytest.fixture(scope="module")
def forced_device_layouts():
    """The reference's layouts on 2 and 4 forced devices, one subprocess each."""
    two = [m for m in MESHES if int(np.prod(m[1])) == 2]
    four = [m for m in MESHES if int(np.prod(m[1])) == 4]
    return {2: _reference_layouts(2, two), 4: _reference_layouts(4, four)}


@pytest.mark.parametrize("n_devices", [2, 4])
def test_layouts_match_reference_on_forced_devices(forced_device_layouts, n_devices):
    layouts = forced_device_layouts[n_devices]
    assert layouts and _assert_same_layouts(layouts) > 0


@pytest.mark.parametrize("names,sizes", MESHES, ids=lambda v: "x".join(map(str, v)))
def test_divisible_batch_splits_and_indivisible_replicates(names, sizes):
    """Every row has one owner per data shard; an indivisible batch is whole
    on every rank, as the reference replicates it."""
    n_data = int(np.prod([s for a, s in zip(names, sizes) if a != "model"]))
    for b in BATCHES:
        owners = np.zeros(b, int)
        for pos in np.ndindex(*sizes):
            s = batch_sharding(Mesh(names, sizes, pos), b, 2)
            r = s.rows
            if b % n_data == 0:
                assert s.n_shards == n_data and r.stop - r.start == b // n_data
                owners[r] += 1
            else:
                assert s.replicated and s.spec == (None, None) and r == slice(0, b)
        if b % n_data == 0:
            assert (owners == int(np.prod(sizes)) // n_data).all()


def test_carry_leaves_cond_and_tolerances():
    mesh = Mesh(("data", "model"), (2, 2), (1, 0))
    cond = {"y": torch.arange(8), "mask": torch.zeros(8, 3, 2)}
    carry = solver_carry_shardings(mesh, 8, 3, cond=cond, tolerances=True)
    assert carry.x.rows == carry.atol.rows == carry.cond["mask"].rows == slice(4, 8)
    assert carry.cond["y"].spec == (("data",),) and carry.cond["mask"].ndim == 3
    assert carry.generator.batch is None and carry.iterations.spec == ()
    no_tol = solver_carry_shardings(mesh, 8, 3)
    assert no_tol.atol is None and no_tol.rtol is None and no_tol.cond is None


def test_mesh_checks_and_local_rows():
    with pytest.raises(ValueError):
        Mesh(("data",), (2,), (2,))
    with pytest.raises(ValueError):
        Mesh(("rows",), (2,), (0,))
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2), (1, 0, 1))
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.size == 8
    assert mesh.index(("pod", "data")) == 2 and mesh.coord("model") == 1
    for m, axis in ((mesh, "model"), (Mesh(("data",), (1,), (0,)), "data")):
        with pytest.raises(RuntimeError, match="init_mesh"):
            m.group(axis)
    s = batch_sharding(mesh, 8, 2)
    x = torch.arange(16.).reshape(8, 2)
    assert torch.equal(s.local(x), x[4:6]) and s.global_shape((2, 2)) == (8, 2)
    with pytest.raises(ValueError):
        s.local(x[:6])


def test_launcher_under_torchrun(tmp_path):
    """``torchrun`` drives the sampling launcher data-parallel (gloo, two
    ranks): rank 0 prints a record of the gathered batch for each solve,
    the adaptive one with the unsharded run's NFE and iterations, then
    EM at 100 steps (101 NFE with the denoise)."""
    from repro_torch.launch import sample as launcher
    from repro_torch.launch.sharded_selftest import free_port

    kw = dict(batch=4, max_iters=4)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "localhost", "--master-port", str(free_port()),
         "-m", "repro_torch.launch.sample", "--device", "cpu", "--arch", "cifar_dit",
         "--batch", str(kw["batch"]), "--max-iters", str(kw["max_iters"])],
        env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    assert [(l["method"], l["ranks"]) for l in lines] == [("adaptive", 2), ("em", 2)]
    em = lines[1]
    assert em["finite"] and em["mean_nfe"] == em["max_nfe"] == 101
    assert em["shape"] == [kw["batch"], 32, 32, 3]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs
    try:
        want = launcher.run("cifar_dit", device="cpu", **kw)
    finally:
        torch.set_num_threads(threads)
    for k in ("mean_nfe", "max_nfe", "iterations", "converged", "finite", "shape"):
        assert lines[0][k] == want[k], k


@pytest.mark.parametrize("D,n", [(300, 2), (30, 4), (999, 4), (3, 4), (196608, 4)])
def test_feature_ranges_tile_the_columns(D, n):
    ranges = [feature_range(D, n, i) for i in range(n)]
    assert ranges[0][0] == 0 and ranges[-1][1] == D
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    widths = [b - a for a, b in ranges]
    assert max(widths) == -(-D // n) and all(w >= 0 for w in widths)
