"""K4, the sharded solver step (``ops.sharded_error_step``), on the CPU.

Ranks are spawned processes in a gloo process group, at world 2 and 4.
Each rank draws the same global inputs from numpy, holds its rows (and,
feature-sharded, its column range) and runs K4's plain path: the
partial sums of ``ref.error_step_sums`` combined by one all-reduce.

* Against the port's unsharded ``error_step`` on the whole state: x''
  bitwise; e2 bitwise batch-only (the rank runs the same step on its
  rows); feature-sharded within ``FEATURE_RTOL`` relative, since the
  same squares are summed per column range and then across ranges.
* Against the reference's ``sharded_error_step`` (its Pallas kernel in
  interpret mode under ``shard_map``) on 4 forced host devices with an
  Auto-axes ``jax.sharding.Mesh``: x'' bitwise, e2 within 1e-5
  relative, the reference selftest's bound. The reference's kernel
  reads past its padded width where a shard's padded width exceeds 512
  and is not a multiple of 512 (ROADMAP §C,
  ``tests/test_torch_solver_step.py::test_reference_kernel_reads_past_padded_d``
  pins it); the widths compared here (D 300, 30, 999, 2048 at f = 2) are
  free of it. The port's ragged ranges (D 999 at f = 4: 250, 250, 250,
  249; D 3 at f = 4: one range is empty) are held against the
  reference's plain ``ref.py`` instead, with the bounds of the K1 parity
  test (``tests/test_torch_solver_step.py``): x'' rtol 1e-5 / atol 1e-6
  in fp32 and 1e-2 in bf16 (the port contracts x̃ into fused
  multiply-adds as the kernels do, ``ref.py`` rounds every product, and
  x'' cancels terms of the operands' size), e2 within 1e-5.
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

from repro_torch.kernels.solver_step import ops
from repro_torch.launch.sharded_selftest import put_result, spawn_ranks
from repro_torch.parallel import batch_sharding, init_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_RTOL = 1e-6
REF_E2_RTOL = 1e-5

#: (id, shape, dtype, per-sample ε, use_prev)
CASES = [
    ("d300", (8, 10, 10, 3), "fp32", False, True),
    ("d300-bf16", (8, 10, 10, 3), "bf16", False, True),
    ("d300-vec", (8, 10, 10, 3), "fp32", True, True),
    ("d300-noprev", (8, 10, 10, 3), "fp32", False, False),
    ("d300-bf16-vec-noprev", (8, 10, 10, 3), "bf16", True, False),
    ("d30", (8, 30), "fp32", False, True),
    ("d2048", (8, 2048), "fp32", True, True),
    ("d999", (4, 999), "fp32", False, True),
    ("d999-bf16", (4, 999), "bf16", True, False),
    ("d3", (4, 3), "fp32", False, True),
]
#: cases compared with the reference's sharded kernel (widths free of its fault)
REFERENCE_CASES = ["d300", "d300-bf16", "d300-vec", "d300-noprev", "d30", "d2048", "d999"]
#: (batch-only mesh, batch+feature meshes) per world, as (data, model)
LAYOUTS = {2: [(2, 1), (1, 2)], 4: [(4, 1), (2, 2), (1, 4)]}
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}


def case_inputs(shape, vector: bool, seed: int = 0):
    """numpy inputs: five states, three (B,) coefficients, (ε_abs, ε_rel)."""
    rng = np.random.default_rng(seed)
    B = shape[0]
    states = [rng.standard_normal(shape).astype(np.float32) for _ in range(5)]
    coeffs = [rng.uniform(0, 1, B).astype(np.float32) for _ in range(3)]
    if vector:
        eps = (rng.uniform(1e-3, 0.1, B).astype(np.float32),
               rng.uniform(0.01, 0.5, B).astype(np.float32))
    else:
        eps = (0.0078, 0.05)
    return states, coeffs, eps


def _torch_case(case):
    _, shape, dtype, vector, _ = case
    states, coeffs, eps = case_inputs(shape, vector)
    ts = [torch.from_numpy(s).to(TDTYPE[dtype]) for s in states]
    tc = [torch.from_numpy(c) for c in coeffs]
    te = [torch.from_numpy(e) if vector else e for e in eps]
    return ts, tc, te


def _rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    out = {"rank": rank, "cases": {}}
    try:
        meshes = [init_mesh(d, m, device="cpu") for d, m in LAYOUTS[world]]
        for case in CASES:
            name, shape, _, vector, use_prev = case
            ts, tc, (ea, er) = _torch_case(case)
            kw = dict(use_prev=use_prev)
            ref_x, ref_e = ops.error_step(*ts, *tc, eps_abs=ea, eps_rel=er, **kw)
            B, D = shape[0], ref_x[0].numel()
            per_layout = []
            for mesh in meshes:
                rows = batch_sharding(mesh, B, len(shape)).rows
                local = lambda v: v[rows] if isinstance(v, torch.Tensor) else v
                feature = "model" if mesh.shape["model"] > 1 else None
                x, e = ops.sharded_error_step(
                    *(a[rows] for a in ts), *(c[rows] for c in tc),
                    eps_abs=local(ea), eps_rel=local(er), mesh=mesh,
                    batch_axes="data", feature_axis=feature, **kw)
                start, stop = ops.feature_range(D, mesh.shape["model"], mesh.coord("model"))
                want_x = ref_x[rows].reshape(x.shape[0], D)[:, start:stop]
                per_layout.append({
                    "layout": (mesh.shape["data"], mesh.shape["model"]),
                    "x_bitwise": bool(torch.equal(x.reshape(want_x.shape), want_x)),
                    "x_shape_kept": feature is not None or x.shape == ts[0][rows].shape,
                    "e2_bitwise": bool(torch.equal(e, ref_e[rows])),
                    "e2_rel": float(((e - ref_e[rows]).abs() / ref_e[rows]).max()),
                    "rows": (rows.start, rows.stop), "cols": (start, stop),
                    "x": x.float().reshape(x.shape[0], -1).numpy(), "e2": e.numpy()})
            out["cases"][name] = per_layout
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned():
    """Every rank's results at world 2 and 4 (one spawn each)."""
    return {world: spawn_ranks(_rank, world) for world in (2, 4)}


def _assemble(ranks, name, layout_index, shape):
    """The global (B, D) x'' and (B,) e2 from every rank's block; checks
    that every element has an owner and that copies agree."""
    B, D = shape[0], int(np.prod(shape[1:]))
    x = np.full((B, D), np.nan, np.float32)
    e2 = np.full(B, np.nan, np.float32)
    for r in ranks:
        blk = r["cases"][name][layout_index]
        (r0, r1), (c0, c1) = blk["rows"], blk["cols"]
        x[r0:r1, c0:c1] = blk["x"]
        if not np.isnan(e2[r0:r1]).any():
            np.testing.assert_array_equal(e2[r0:r1], blk["e2"])
        e2[r0:r1] = blk["e2"]
    assert not np.isnan(x).any() and not np.isnan(e2).any()
    return x, e2


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_unsharded_step(spawned, world, case):
    for r in spawned[world]:
        for blk in r["cases"][case[0]]:
            assert blk["x_bitwise"] and blk["x_shape_kept"], blk["layout"]
            if blk["layout"][1] == 1:
                assert blk["e2_bitwise"], blk["layout"]
            else:
                assert blk["e2_rel"] <= FEATURE_RTOL, blk["layout"]


_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.kernels.solver_step import ops

inp = np.load(sys.argv[1])
cases = json.loads(sys.argv[2])
devs = np.array(jax.devices())
meshes = {"batch": (Mesh(devs, ("data",)), None),
          "feature": (Mesh(devs.reshape(2, 2), ("data", "model")), "model")}
out = {}
for name, dtype, vector, use_prev in cases:
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    states = [jnp.asarray(inp[f"{name}/s{i}"]).astype(dt) for i in range(5)]
    coeffs = [jnp.asarray(inp[f"{name}/c{i}"]) for i in range(3)]
    if vector:
        ea, er = jnp.asarray(inp[f"{name}/ea"]), jnp.asarray(inp[f"{name}/er"])
    else:
        ea, er = float(inp[f"{name}/ea"]), float(inp[f"{name}/er"])
    for key, (mesh, feat) in meshes.items():
        x, e = ops.sharded_error_step(*states, *coeffs, eps_abs=ea, eps_rel=er,
                                      mesh=mesh, batch_axes=("data",),
                                      feature_axis=feat, use_prev=use_prev)
        out[f"{name}/{key}/x"] = np.asarray(x.astype(jnp.float32)).reshape(x.shape[0], -1)
        out[f"{name}/{key}/e2"] = np.asarray(e)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded step on 4 forced devices, batch-sharded over
    ("data",) and batch+feature-sharded over (2, 2), one subprocess."""
    d = tmp_path_factory.mktemp("k4ref")
    arrays, specs = {}, []
    for case in CASES:
        name, shape, dtype, vector, use_prev = case
        if name not in REFERENCE_CASES:
            continue
        states, coeffs, (ea, er) = case_inputs(shape, vector)
        arrays.update({f"{name}/s{i}": s for i, s in enumerate(states)})
        arrays.update({f"{name}/c{i}": c for i, c in enumerate(coeffs)})
        arrays[f"{name}/ea"], arrays[f"{name}/er"] = np.asarray(ea), np.asarray(er)
        specs.append((name, dtype, vector, use_prev))
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
                           json.dumps(specs), str(d / "out.npz")],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_matches_reference_sharded_kernel(spawned, reference, name):
    """World 4: the port's batch-only (4, 1) and batch+feature (2, 2)
    layouts against the reference's on the same four-way layouts."""
    shape = next(c[1] for c in CASES if c[0] == name)
    for key, index in (("batch", 0), ("feature", 1)):
        x, e2 = _assemble(spawned[4], name, index, shape)
        np.testing.assert_array_equal(x, reference[f"{name}/{key}/x"], err_msg=key)
        np.testing.assert_allclose(e2, reference[f"{name}/{key}/e2"], rtol=REF_E2_RTOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["d999", "d999-bf16", "d3", "d30"])
def test_ragged_ranges_match_reference_plain(spawned, name):
    """World 4, (1, 4) and (2, 2): ragged and empty column ranges against the
    reference's ``ref.py`` on the whole state."""
    import jax.numpy as jnp

    from repro.kernels.solver_step import ref as jref

    _, shape, dtype, vector, use_prev = next(c for c in CASES if c[0] == name)
    states, coeffs, (ea, er) = case_inputs(shape, vector)
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    B = shape[0]
    jx, je = jref.error_step(*(jnp.asarray(s).astype(dt).reshape(B, -1) for s in states),
                             *map(jnp.asarray, coeffs), eps_abs=jnp.asarray(ea) if vector
                             else ea, eps_rel=jnp.asarray(er) if vector else er,
                             use_prev=use_prev)
    jx = np.asarray(jx.astype(jnp.float32))
    x_tol = dict(rtol=1e-5, atol=1e-6) if dtype == "fp32" else dict(rtol=1e-2, atol=1e-2)
    for index in (1, 2):
        x, e2 = _assemble(spawned[4], name, index, shape)
        np.testing.assert_allclose(x, jx, **x_tol)
        np.testing.assert_allclose(e2, np.asarray(je), rtol=REF_E2_RTOL)


def test_cuda_path_raises_where_it_cannot_build(monkeypatch, tmp_path):
    """The partial mode launches the kernel or raises; it counts only a
    launch that happened, and never hands a request to the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.solver_step import ref

    monkeypatch.setattr(ref, "error_step_sums", lambda *a, **k: pytest.fail("fell back"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _build.library.cache_clear()
    before = (ops.launches, ops.sharded_launches)
    try:
        x, c = torch.zeros(2, 8), torch.zeros(2)
        with pytest.raises(RuntimeError, match="nvcc"):
            ops._launch(x[:, 2:6], x[:, 2:6], x[:, 2:6], x[:, 2:6], x[:, 2:6],
                        c, c, c, c, c, use_prev=True, raw=True, k4=True)
        with pytest.raises(ValueError, match="row stride"):
            ops._launch(x[:, 2:6], x[:, 2:6].contiguous(), x[:, 2:6], x[:, 2:6],
                        x[:, 2:6], c, c, c, c, c, use_prev=True, raw=True, k4=True)
    finally:
        _build.library.cache_clear()
    assert (ops.launches, ops.sharded_launches) == before
