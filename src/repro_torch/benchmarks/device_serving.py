"""Device-resident serve loop against the host-driven chunk chain
(DESIGN.md §12); port of ``benchmarks/bench_device_serving.py``.

The host-driven ``DiffusionBatcher`` pays O(sync horizons) device→host
reads a drain: every horizon pulls the convergence mask and the iteration
counter even when nothing converged (plus the solver's own syncs inside
``solve_chunk``). The device-resident mode reads one (event, horizons)
flag a driver window and pulls bookkeeping only at events, so its reads
are O(delivered requests).

Section 1, the reference's workload (the closed-form Gaussian score, D 2,
3 requests a slot after a warm-up drain that builds the driver, sync
horizons 1, 4 and 8, both modes), reports for each row the serve loop's
host transfers a request, the solver's syncs, windows, iterations and
samples/s. Section 2 replaces the reference's Pallas block choice, which
has no counterpart here: it times K1 (the fused solver step) at the
trajectory rows a planning server feeds it, 64 plans of 16·6 = 96 and
32·8 = 256 features, against the bytes bound, on the card only.

Rows print as the reference's CSV, ``name,us_per_call,derived``.

  PYTHONPATH=src python -m repro_torch.benchmarks.device_serving [--slots 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.analysis.roofline import HBM_BW
from repro_torch.core import analytic
from repro_torch.core.sde import VPSDE
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.device import resolve_device
from repro_torch.launch.sample import make_sample_step
from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

MU, S0 = 0.3, 0.5
DIM = 2           # low-d: the widest per-sample NFE spread
REQUESTS_PER_SLOT = 3
SYNC_HORIZONS = (1, 4, 8)
#: the trajectory rows of section 2: (plans, horizon · transition width)
TRAJ_ROWS = (("traj16x6", 64, 96), ("traj32x8", 64, 256))


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.3f},{derived}", flush=True)


def serve_row(slots: int, sync_horizon: int, device_resident: bool, device) -> dict:
    """One drain of REQUESTS_PER_SLOT · slots requests after a warm-up
    drain of ``slots`` requests (which builds, on the card, the driver's
    graph): the serve loop's host transfers, the solver's syncs, windows
    and iterations of the timed drain, and its wall time."""
    dev = resolve_device(device)
    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True)
    fwd = analytic.gaussian_noise_pred(sde, MU, S0)
    step = make_sample_step(sde, cfg, forward_fn=lambda p, x, t: fwd(x, t))
    b = DiffusionBatcher(sde, step, None, (DIM,), slots=slots, cfg=cfg,
                         sync_horizon=sync_horizon, device_resident=device_resident,
                         device=dev)
    for uid in range(slots):
        b.submit(ImageRequest(uid=10_000 + uid, seed=10_000 + uid))
    b.run_to_completion()
    before = (b.host_transfers, b.solver_syncs, b.horizon_windows, b.total_iterations)
    n = REQUESTS_PER_SLOT * slots
    for uid in range(n):
        b.submit(ImageRequest(uid=uid, seed=uid))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = b.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if len(done) != slots + n:
        raise RuntimeError(f"delivered {len(done)} of {slots + n} requests")
    transfers, syncs, windows, iters = (a - b_ for a, b_ in zip(
        (b.host_transfers, b.solver_syncs, b.horizon_windows, b.total_iterations), before))
    return {"transfers": transfers, "per_request": transfers / n, "solver_syncs": syncs,
            "windows": windows, "iterations": iters, "wall_s": wall,
            "samples_per_s": n / wall, "graph_captures": b.graph_captures}


def bench_serving(slots: int, device, horizons=SYNC_HORIZONS) -> dict:
    """Section 1: {horizon: {"host": row, "device": row, "ratio": x}}."""
    out = {}
    for h in horizons:
        host = serve_row(slots, h, False, device)
        dr = serve_row(slots, h, True, device)
        ratio = host["per_request"] / max(dr["per_request"], 1e-9)
        for mode, r in (("host", host), ("device", dr)):
            emit(f"device_serving/h{h}/{mode}", r["wall_s"] * 1e6,
                 f"host_transfers_per_request={r['per_request']:.2f};"
                 f"transfers={r['transfers']};solver_syncs={r['solver_syncs']};"
                 f"windows={r['windows']};iters={r['iterations']};"
                 f"samples_per_s={r['samples_per_s']:.2f}")
        emit(f"device_serving/h{h}/ratio", 0.0, f"host_transfers_host_over_device={ratio:.1f}x")
        out[h] = {"host": host, "device": dr, "ratio": ratio}
    return out


def bench_trajectory_rows(device) -> dict:
    """Section 2 (card only): K1 at the trajectory rows, device µs from
    replayed CUDA graphs, beside the bytes bound (five operands read,
    x'' written, fp32)."""
    from repro_torch.benchmarks.kernel_times import device_ms
    from repro_torch.kernels.solver_step import ops as step_ops

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    fn = lambda *a: step_ops.error_step(*a[:8], eps_abs=a[8], eps_rel=a[9])
    out = {}
    for name, b, d in TRAJ_ROWS:
        sets = [(*[torch.randn(b, d, generator=gen, device=dev) for _ in range(5)],
                 *[torch.rand(b, generator=gen, device=dev) for _ in range(3)],
                 step_ops.per_sample_tolerance(0.0078, b, dev),
                 step_ops.per_sample_tolerance(0.05, b, dev)) for _ in range(4)]
        ms = device_ms(fn, sets)
        bound = (6 * b * d * 4 + 6 * b * 4) / HBM_BW * 1e3
        emit(f"device_serving/kernel/{name}", ms * 1e3,
             f"bound_us={bound * 1e3:.3f};rows={b};features={d}")
        out[name] = {"ms": ms, "bound_ms": bound}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    bench_serving(args.slots, args.device)
    if resolve_device(args.device).type == "cuda":
        bench_trajectory_rows(args.device)


if __name__ == "__main__":
    main()
