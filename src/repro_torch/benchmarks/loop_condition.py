"""Walls of the graphed loops beside their host-driven chains, for
comparing two builds of the port on one card (no reference counterpart:
the reference's loops are ``lax.while_loop``s it does not time apart).

A graphed solve is one launch of a WHILE-node CUDA graph whose condition
(P2, ``kernels.graph_loop``) decides after each unit whether the next
runs; the host-driven chain runs whole groups of ``SYNC_EVERY`` masked
units between host reads. Times, each the median of ``reps`` calls,
synchronised on the card around each call, replays and host-driven calls
in turns:

- HIGHRES_DIT (seed-0 weights, livened; batch 8, fp32, flash attention,
  the fused step): the adaptive solve at eps_rel 0.05 and the
  probability-flow RK45 at rtol = atol = 1e-3 (at most 40 attempts), the
  replayed graph (a key's third solve) and the host-driven chain (a fresh
  score wrapper each call: a key's first solve), with each one's kernel
  launches (K1, K3, P1, P2) and whether the two are bitwise equal;
- Table 1's adaptive rows (N 4096, the trained TOY_MLPs, VP and VE, each
  eps_rel), the same two ways (``table1_adaptive_walls``);
- the world-1 NCCL mesh's agreement that ends an Algorithm-1 horizon
  under a mesh (``adaptive.MeshFlags.update``: the all-reduce of the
  flags and the catch-up), captured in a CUDA graph and replayed, and
  eager, and the captured all-reduce alone (``mesh_flags_times``; CUDA
  events around ``reps`` calls).

It calls only the port's public entry points, so it times any checkout
of the port: run this file by path with ``PYTHONPATH`` at that
checkout's ``src``, e.g. the parent and this tree in turns on one card:

  PYTHONPATH=/path/to/parent/src python src/repro_torch/benchmarks/loop_condition.py
  PYTHONPATH=src python -m repro_torch.benchmarks.loop_condition

Prints the card's name and power limit, then one JSON line. Needs a
CUDA card; exits 1 without one.
"""

from __future__ import annotations

import datetime
import json
import statistics
import sys
import time

import torch

#: phase 3's adaptive solve and phase 4b's RK45 from HIGHRES_DIT
ADAPTIVE_KW = dict(eps_rel=0.05, use_fused_kernel=True, max_iters=400)
ODE_KW = dict(rtol=1e-3, atol=1e-3, max_iters=40)
#: the state a mesh horizon's agreement runs beside (HIGHRES_DIT's slots)
MESH_SLOTS, MESH_SHAPE = 8, (256, 256, 3)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _counts() -> dict:
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.graph_loop import ops as loop_ops
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.solver_step import ops as step_ops

    return {"K1": step_ops.launches, "K3": flash_ops.launches, "P1": ph.launches,
            "P2": loop_ops.launches}


def _call(fn) -> tuple:
    """(seconds, result, launches) of one synchronised ``fn()``."""
    before = _counts()
    _sync()
    t0 = time.perf_counter()
    res = fn()
    _sync()
    wall = time.perf_counter() - t0
    return wall, res, {k: v - before[k] for k, v in _counts().items()}


def graphed_against_host(solve, score, reps: int = 3) -> dict:
    """``solve(score_fn)`` (a ``SolveResult``) replayed and host-driven:
    two solves at ``score``'s key first (the one-shot rule's host-driven
    solve and the capture), then ``reps`` replays and ``reps`` host-driven
    solves in turns, each of those on a fresh wrapper of ``score`` (a new
    key: its first solve). Returns the median walls, every wall, the
    iterations, each path's launches and whether every solve is bitwise
    the first replay (x, nfe, iterations)."""
    for _ in range(2):
        _call(lambda: solve(score))
    replays, hosts, first = [], [], None
    same = True
    for _ in range(reps):
        wall, res, n_replay = _call(lambda: solve(score))
        replays.append(wall)
        first = res if first is None else first
        wall, host, n_host = _call(lambda: solve(lambda *a: score(*a)))
        hosts.append(wall)
        same &= all(torch.equal(getattr(r, f), getattr(first, f))
                    for r in (res, host) for f in ("x", "nfe", "iterations"))
    return {"iterations": int(first.iterations), "replay_s": statistics.median(replays),
            "host_s": statistics.median(hosts), "replay_walls_s": replays,
            "host_walls_s": hosts, "launches_replay": n_replay, "launches_host": n_host,
            "bitwise": bool(same)}


def highres_walls(device, reps: int = 3) -> dict:
    """HIGHRES_DIT's adaptive solve and RK45, replayed and host-driven."""
    from repro_torch.core.sampling import sample
    from repro_torch.core.sde import VPSDE
    from repro_torch.launch.sample import build_score

    net, model, score = build_score("highres_dit", flash=True, precision="fp32", seed=0,
                                    liven_seed=0, device=device)
    shape = (8, net.image_size, net.image_size, net.channels)
    out = {}
    for name, kw in (("adaptive", ADAPTIVE_KW), ("ode", dict(method="ode", **ODE_KW))):
        out[name] = graphed_against_host(
            lambda sc, kw=kw: sample(VPSDE(), sc, shape, seed=0, device=device, **kw),
            score, reps)
    del model, score
    return out


def table1_adaptive_walls(device, reps: int = 3) -> list:
    """Table 1's adaptive rows (``table1_solver_grid``: N 4096, seed 42, the
    fused step), each replayed and host-driven; the rows' keys warmed up
    as the table does (``common.warm_up``)."""
    from repro_torch.benchmarks.common import trained_mlp_score, warm_up
    from repro_torch.benchmarks.table1_solver_grid import EPS_GRID, N_SAMPLES
    from repro_torch.core.sampling import sample

    rows = []
    for process in ("vp", "ve"):
        sde, score = trained_mlp_score(process, device=device)
        for eps in EPS_GRID:
            kw = dict(eps_rel=eps, use_fused_kernel=True)
            warm_up(sde, score, (N_SAMPLES, 2), device, "adaptive", **kw)
            w = graphed_against_host(
                lambda sc, kw=kw: sample(sde, sc, (N_SAMPLES, 2), seed=42, method="adaptive",
                                         device=device, **kw), score, reps)
            rows.append({"name": f"table1/{process}/ours-eps{eps}",
                         "iterations": w["iterations"], "replay_us": w["replay_s"] * 1e6,
                         "host_us": w["host_s"] * 1e6, "k1_replay": w["launches_replay"]["K1"],
                         "k1_host": w["launches_host"]["K1"], "p2_replay":
                         w["launches_replay"]["P2"], "bitwise": w["bitwise"]})
    return rows


def _events_ms(fn, reps: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def mesh_flags_times(device, reps: int = 200) -> dict:
    """The agreement that ends an Algorithm-1 horizon on a world-1 NCCL mesh
    (``MeshFlags.update`` on MESH_SLOTS rows of a MESH_SHAPE state), in ms a
    call: captured in a CUDA graph and replayed (how the device-resident
    driver and a graphed solve under a mesh run it, once a horizon), eager
    (launched from the host, as between two host-driven groups), and the
    captured all-reduce of its three int32 alone, with the nodes each
    captured graph holds (``kernel_times.graph_nodes``): at world 1 an
    in-place all-reduce may enqueue no work at all. Makes its own process
    group (and destroys it) unless one is up."""
    import torch.distributed as dist

    from repro_torch.benchmarks.kernel_times import graph_nodes
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import SYNC_EVERY, MeshFlags, init_carry, own_buffers
    from repro_torch.core.streams import SlotStreams
    from repro_torch.launch.sharded_selftest import free_port
    from repro_torch.parallel import init_mesh
    from repro_torch.parallel.collectives import all_max
    from repro_torch.parallel.sharding import sample_state_shardings

    dev = torch.device(device)
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_mesh(1, 1, device=dev)
        sharding = sample_state_shardings(mesh, MESH_SLOTS, 1 + len(MESH_SHAPE))[0]
        carry = own_buffers(init_carry(
            VPSDE(), torch.zeros((MESH_SLOTS,) + MESH_SHAPE, device=dev),
            SlotStreams.of(list(range(MESH_SLOTS)), 1, device=dev), eps_rel=0.05,
            sharding=sharding))
        occupied = torch.ones(MESH_SLOTS, dtype=torch.bool, device=dev)
        flags = MeshFlags(sharding, occupied, horizon=SYNC_EVERY, draws=1)
        with torch.no_grad():
            flags.update(carry)  # NCCL's communicator, before any capture
            torch.cuda.synchronize()
            graphs = {}
            for name, fn in (("update", lambda: flags.update(carry)),
                             ("all_reduce", lambda: all_max(flags.buf, flags.group))):
                g = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(g):
                    fn()
                graphs[name] = g
            torch.cuda.synchronize()
            out = {"captured_update_ms": _events_ms(graphs["update"].replay, reps),
                   "captured_all_reduce_ms": _events_ms(graphs["all_reduce"].replay, reps),
                   "eager_update_ms": _events_ms(lambda: flags.update(carry), reps),
                   "update_nodes": sum(graph_nodes(graphs["update"]).values()),
                   "all_reduce_nodes": sum(graph_nodes(graphs["all_reduce"]).values()),
                   "reps": reps, "slots": MESH_SLOTS}
        del graphs
    finally:
        if owned:
            dist.destroy_process_group()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("loop_condition: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import repro_torch
    from repro_torch.benchmarks.kernel_times import card

    dev = torch.device("cuda")
    result = {"package": repro_torch.__file__, "highres_dit": highres_walls(dev),
              "table1_adaptive": table1_adaptive_walls(dev),
              "mesh_flags": mesh_flags_times(dev)}
    print(card())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
