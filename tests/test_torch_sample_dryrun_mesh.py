"""The sampler's dry runs under a mesh (``launch/sample.py``: ``dryrun``
with ``mesh`` "1pod" / "2pod" and ``pipeline``, ``dryrun_loop``) and the
counting mode of the collectives (``parallel/collectives.py::counting``)
they run in, on the CPU.

* The count against a real run: in one spawn of 4 gloo ranks (one
  thread each), one Algorithm-1 iteration of a small DiT
  (``mesh_iteration``) on the ("data", "model") mesh (2, 2), tensor
  parallel, and on the ("pod", "data", "model") mesh (2, 1, 2),
  pipelined over "pod" with tensor parallelism inside each stage, each
  rank on its rows of the state. Each rank then counts the same
  iteration on meta tensors for its coordinate of a mesh without process
  groups: the books are equal, call for call and byte for byte, by the
  reference's op kinds and by the port's.
* HIGHRES_DIT at batch 512 on the reference's meshes, one rank counted:
  256 devices at 1pod, 512 at 2pod, and at 2pod pipelined 6 of 12
  layers a stage at 4 microbatches; ``state_bytes_per_device`` is
  2·(512 / n_data)·196,608·4; and the collectives are the forward's
  sums and gathers as counted by hand: at 1pod an all-reduce after each
  layer's MLP, two forwards of 12 layers of the rank's 32 rows (the
  heads, 12 % 16 ≠ 0, stay whole), and the modulation's all-gather.
* The command line: ``--mesh 1pod`` and ``--multi-pod`` exclude each
  other, and ``--pipeline`` without ``--multi-pod`` raises.
* ``--dryrun-loop --loop-devices 8 --batch 32`` runs, and its collectives
  are loop bookkeeping: one 8-byte all-reduce a sync group, none in the
  loop body.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.sde import VESDE
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.launch import sample
from repro_torch.launch.sharded_selftest import put_result, spawn_ranks
from repro_torch.models import dit as tdit
from repro_torch.parallel import Mesh, init_mesh
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import batch_sharding

torch.set_num_threads(2)

CFG = tdit.DiTConfig(image_size=8, patch=2, d_model=32, num_layers=4, num_heads=4, d_ff=64)
B = 8
WORLD = 4
#: (pod, data, model) sizes (pod 0: no pod axis), pipelined
MESHES = {"tp": ((0, 2, 2), False), "pipelined": ((2, 1, 2), True)}
HIGHRES_STATE = 256 * 256 * 3


def _iteration(model, mesh, x, pipeline):
    rows = batch_sharding(mesh, B, 4)
    sde = VESDE(sigma_max=50.0)
    cfg = AdaptiveConfig(eps_rel=0.02)
    body, carry, _ = sample.mesh_iteration(model, sde, cfg, x[rows.rows], mesh=mesh,
                                           pipeline=pipeline,
                                           sharded_rows=not rows.replicated)
    return body, carry


def _rank(rank, world, port, out_dir, _):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        full = tdit.init_dit(CFG, torch.Generator().manual_seed(0))
        tdit.liven_zero_init(full, torch.Generator().manual_seed(1))
        x = torch.randn(B, 8, 8, 3, generator=torch.Generator().manual_seed(2)) * 50.0
        meta = torch.device("meta")
        out = {}
        for name, ((pod, data, msize), pipe) in MESHES.items():
            mesh = init_mesh(data, msize, device="cpu", pod=pod or None)
            axis = "pod" if pipe else None
            model = tdit.shard_dit(full, sample._dit_param_shardings(full, mesh, axis))
            body, carry = _iteration(model, mesh, x, pipe)
            with torch.no_grad():
                torch.manual_seed(5)
                coll.reset()
                new = body(carry)
                books = (coll.op_counts(), coll.counts())
                place = Mesh(mesh.axis_names, mesh.sizes, mesh.coordinate, device=meta)
                shadow = tdit.DiT(CFG, device=meta,
                                  shardings=sample._dit_param_shardings(CFG, place, axis))
                body, carry = _iteration(shadow, place, x.to(meta), pipe)
                coll.reset()
                with coll.counting():
                    counted_x = body(carry).x
                counted = (coll.op_counts(), coll.counts())
            out[name] = {"books": books, "counted": counted, "finite": bool(
                torch.isfinite(new.x).all()), "shapes": (tuple(new.x.shape),
                                                         tuple(counted_x.shape))}
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned():
    return spawn_ranks(_rank, WORLD, None)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_meta_count_equals_real_books(spawned, name):
    for r in spawned:
        res = r[name]
        assert res["counted"] == res["books"]
        assert res["finite"] and res["shapes"][0] == res["shapes"][1]
    ops = [r[name]["books"][0] for r in spawned]
    assert all("all-reduce" in o and "all-gather" in o for o in ops)
    if name == "pipelined":  # stage 0 sends M microbatches to stage 1, stage 1 none
        sends = sorted(o.get("collective-permute", (0, 0))[0] for o in ops)
        assert sends == [0, 0, 2 * sample.PIPELINE_MICROBATCHES,
                         2 * sample.PIPELINE_MICROBATCHES]  # two forwards


@pytest.fixture(scope="module")
def records():
    return {(m, p): sample.dryrun(512, "fp32", mesh=m, pipeline=p, save=False)
            for m, p in (("1pod", False), ("2pod", False), ("2pod", True))}


@pytest.mark.parametrize("mesh,pipeline,devices,n_data",
                         [("1pod", False, 256, 16), ("2pod", False, 512, 32),
                          ("2pod", True, 512, 32)])
def test_highres_records(records, mesh, pipeline, devices, n_data):
    rec = records[(mesh, pipeline)]
    assert rec["devices"] == devices and rec["mesh"] == mesh
    assert rec["arch"] == "dit-highres-sampler" + ("-pipelined" if pipeline else "")
    assert rec["precision"]["state_bytes_per_device"] == 2 * (512 // n_data) * HIGHRES_STATE * 4
    assert rec["rank"]["rows"] == 512 // n_data
    assert rec["rank"]["layers"] == ([0, 6] if pipeline else [0, 12])
    rows = 512 // n_data * (2 if pipeline else 1)  # the pipeline gathers over "pod"
    layers = 6 if pipeline else 12
    act = rows * 256 * 768 * 4
    coll_bytes = rec["collectives"]["bytes_by_kind"]
    assert coll_bytes["all-reduce"] == 2 * layers * act + (2 * act * 257 // 256 if pipeline
                                                           else 0)
    assert coll_bytes["all-gather"] == 2 * layers * rows * 6 * 768 * 4 + (
        2 * act * 257 // 256 if pipeline else 0)
    if pipeline:
        mb = rows // sample.PIPELINE_MICROBATCHES
        assert coll_bytes["collective-permute"] == 2 * 4 * mb * 257 * 768 * 4
    else:
        assert "collective-permute" not in coll_bytes
    flops = records[("1pod", False)]["cost"]["flops"]
    assert rec["cost"]["flops"] == pytest.approx(flops * (0.5 if mesh == "2pod" else 1),
                                                 rel=1e-3)


def test_dryrun_loop_counts_loop_bookkeeping(tmp_path):
    rec = sample.main(["--dryrun-loop", "--loop-devices", "8", "--batch", "32",
                       "--out", str(tmp_path)])[0]
    assert (tmp_path / "dit-cifar-sampler-whole-loop_sample_b32_32px_data8.json").exists()
    assert rec["devices"] == 8 and rec["mesh"] == "data8"
    assert rec["collectives"]["body"]["total_bytes"] == 0
    assert rec["collectives"]["loop_control"]["bytes_by_kind"] == {"all-reduce": 8}
    assert rec["collective_bytes_per_iteration"] == 8
    assert rec["collective_bytes_per_iteration"] < 4 * 32 * 32 * 3 * 4 / 100
    assert rec["cost"]["body"]["flops"] > 0 and rec["cost"]["denoise"]["flops"] > 0
    assert np.isclose(rec["cost"]["body"]["flops"], 2 * rec["cost"]["denoise"]["flops"],
                      rtol=1e-2)
    assert "data-dependent" in rec["note"]


def test_cli_mesh_flags(tmp_path):
    """``--mesh 1pod`` and ``--multi-pod`` pick the mesh and exclude each
    other; ``--pipeline`` needs ``--multi-pod``, as the reference's dry
    run asserts."""
    rec = sample.main(["--mesh", "1pod", "--batch", "32", "--out", str(tmp_path)])[0]
    assert rec["mesh"] == "1pod" and rec["devices"] == 256
    with pytest.raises(SystemExit):
        sample.main(["--mesh", "1pod", "--multi-pod", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="2pod"):
        sample.main(["--pipeline", "--batch", "32", "--out", str(tmp_path)])
