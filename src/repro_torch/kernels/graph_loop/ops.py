"""Wrappers of the WHILE-node driver (``csrc/while_driver.cu``): the
parent graph around a captured unit of a loop, and P2 (``horizon_cond``),
the reference's two nested loop conditions evaluated after every unit.

``WhileDriver(unit_graph, occupied, done, iterations, state, ...)`` builds
the parent graph once from a ``torch.cuda.CUDAGraph`` captured with
``keep_graph=True`` (its ``raw_cuda_graph()``): P2 before the first
unit, then a WHILE node whose body is the unit (one Algorithm-1
iteration, one RK45 attempt, one Algorithm-2 or grid step; under a mesh
the masked group that ends in the mesh's all-reduce) followed by P2.
P2 runs the next unit while ``solve_chunk``'s condition holds (some row
not done, fewer than ``horizon`` units in this horizon, the carry's
``iterations`` below ``max_iters``); where it fails, the horizon is over
and ``solve_horizons``' condition (some occupied row running, no event,
fewer than ``max_horizons`` horizons) decides whether the next horizon
starts. ``launch()`` runs one driver window on PyTorch's current stream
and returns at once; ``state`` (4 int32 on the device, ``STATE``) then
holds the event flag of the carry at exit, the horizons run, the units
run in the horizon (0 at exit) and the units run, the one thing the host
reads.

``horizon_cond`` launches P2 alone, outside a graph, on hand-built masks
(its check and its time); CPU tensors take ``ref.horizon_cond``.

``launches`` counts P2's kernel executions: one an eager call, and
``units + 1`` a driver window. A graph's kernels run where the host
cannot count them, so ``WhileDriver.account`` charges a window once the
caller has read its state: P2's executions, and for each wrapper the
unit runs (K1/K2, K4, K5, K3, K6, P1) its calls recorded into the unit
at capture (``captured_calls``) times the units run. ``windows`` counts
parent-graph launches.
Conditional nodes need CUDA 12.3 or later in the toolkit the library was
built with and in the driver: ``require_conditional_nodes`` raises,
naming both, where either is older.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.graph_loop import ref
from repro_torch.kernels.groupnorm_silu import ops as gn_ops
from repro_torch.kernels.philox import ops as philox_ops
from repro_torch.kernels.solver_step import ops as step_ops

Tensor = torch.Tensor

#: P2 kernel executions since the count was last set to 0
launches = 0
#: driver windows (parent-graph launches) since the count was last set to 0
windows = 0

#: the CUDA version conditional graph nodes need (cudaRuntimeGetVersion's form)
MIN_CUDA = 12030
#: what P2 writes into its state, in order: the event flag, the horizons
#: run, the units run in the current horizon, the units run in the window
STATE = ("event", "horizons", "horizon_units", "units")


def _declare(lib):
    if lib.graph_loop_build.argtypes is None:
        lib.graph_loop_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.graph_loop_build.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                         + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                         + [ctypes.POINTER(ctypes.c_void_p)])
        lib.graph_loop_launch.argtypes = [ctypes.c_void_p] * 2
        lib.graph_loop_destroy.argtypes = [ctypes.c_void_p]
        lib.graph_loop_cond.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        for fn in ("versions", "build", "launch", "destroy", "cond"):
            getattr(lib, f"graph_loop_{fn}").restype = ctypes.c_int
    return lib


def cuda_versions() -> tuple:
    """(runtime, driver): the CUDA runtime the kernel library was built
    with and the installed driver's, as 12030 for 12.3."""
    lib = _declare(_build.library())
    rt, drv = ctypes.c_int(), ctypes.c_int()
    rc = lib.graph_loop_versions(ctypes.byref(rt), ctypes.byref(drv))
    if rc != 0:
        raise RuntimeError(f"cudaRuntimeGetVersion/cudaDriverGetVersion failed: CUDA error {rc}")
    return rt.value, drv.value


def captured_calls() -> dict:
    """{(wrapper module, its launch counter): the calls recorded into CUDA
    graphs so far}, for the wrappers a captured unit runs: K1/K2, K4
    (the sharded step, ``sharded_launches``), K5 (``em_launches``, the
    fixed-grid baselines), K3, K6 and P1. The difference across a capture
    is what one replay launches."""
    return {(step_ops, "launches"): step_ops.captured,
            (step_ops, "sharded_launches"): step_ops.captured_sharded,
            (step_ops, "em_launches"): step_ops.captured_em,
            (flash_ops, "launches"): flash_ops.captured,
            (gn_ops, "launches"): gn_ops.captured,
            (philox_ops, "launches"): philox_ops.captured}


def _dotted(v: int) -> str:
    return f"{v // 1000}.{v % 1000 // 10}"


def require_conditional_nodes() -> None:
    """Raise unless both the toolkit and the driver are CUDA 12.3 or later."""
    rt, drv = cuda_versions()
    if rt < MIN_CUDA or drv < MIN_CUDA:
        raise RuntimeError(
            f"the device-resident serve loop needs CUDA graph conditional (WHILE) nodes, "
            f"CUDA {_dotted(MIN_CUDA)} or later in the toolkit and the driver; this library "
            f"was built with CUDA {_dotted(rt)} and the driver is CUDA {_dotted(drv)}")


def _check_masks(occupied: Tensor, done: Tensor, iterations: Tensor, state: Tensor) -> None:
    if occupied.dtype != torch.bool or done.dtype != torch.bool:
        raise TypeError("occupied and done must be bool")
    if occupied.ndim != 1 or done.shape != occupied.shape:
        raise ValueError(f"occupied {tuple(occupied.shape)} and done {tuple(done.shape)} "
                         "must both be (B,)")
    if iterations.dtype != torch.int32 or iterations.numel() != 1:
        raise ValueError("iterations must be one int32")
    if state.dtype != torch.int32 or state.shape != (len(STATE),):
        raise ValueError(f"state must be {len(STATE)} int32")
    tensors = (occupied, done, iterations, state)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("occupied, done, iterations and state must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("occupied, done, iterations and state must be contiguous")


def horizon_cond(occupied: Tensor, done: Tensor, iterations: Tensor, state: Tensor, *,
                 wait_all: bool, horizon: int, max_iters: int, max_horizons: int,
                 first: bool) -> Tensor:
    """P2 on its own: ``state`` ← what P2 writes before the first unit
    (``first``) or after a unit (``ref.horizon_cond``), in place; returns
    ``state``."""
    global launches
    _check_masks(occupied, done, iterations, state)
    if occupied.device.type == "cpu":
        ref.horizon_cond(occupied, done, iterations, state, wait_all=wait_all, horizon=horizon,
                         max_iters=max_iters, max_horizons=max_horizons, first=first)
        return state
    lib = _declare(_build.library())
    with torch.cuda.device(occupied.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.graph_loop_cond(occupied.data_ptr(), done.data_ptr(), occupied.shape[0],
                                 iterations.data_ptr(), state.data_ptr(), int(wait_all),
                                 int(horizon), int(max_iters), int(max_horizons), int(first),
                                 stream)
    if rc != 0:
        raise RuntimeError(f"horizon_cond kernel launch failed: CUDA error {rc}")
    launches += 1
    return state


class WhileDriver:
    """The instantiated parent graph around one captured unit. It keeps the
    unit's graph, the masks, ``iterations`` and ``state`` alive as long as
    it lives; they and the carry the unit writes must stay where they are.
    ``recorded`` is {(wrapper module, its launch counter): its calls in
    one unit}, the difference of ``captured_calls()`` across the unit's
    capture. ``horizon`` is the units a horizon holds at most,
    ``max_iters`` the bound on the carry's ``iterations`` counter,
    ``max_horizons`` the horizons a window runs at most."""

    def __init__(self, unit: "torch.cuda.CUDAGraph", occupied: Tensor, done: Tensor,
                 iterations: Tensor, state: Tensor, *, recorded: dict, horizon: int,
                 max_iters: int, max_horizons: int, wait_all: bool):
        _check_masks(occupied, done, iterations, state)
        if occupied.device.type != "cuda":
            raise ValueError("the WHILE driver runs on the card; the CPU takes ref.solve_horizons")
        require_conditional_nodes()
        self._lib = _declare(_build.library())
        self._keep = (unit, occupied, done, iterations, state)
        self.recorded = dict(recorded)
        self.device = occupied.device
        handle = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            rc = self._lib.graph_loop_build(unit.raw_cuda_graph(), occupied.data_ptr(),
                                            done.data_ptr(), occupied.shape[0],
                                            iterations.data_ptr(), state.data_ptr(),
                                            int(wait_all), int(horizon), int(max_iters),
                                            int(max_horizons), ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"building the WHILE-node driver graph failed: CUDA error {rc}")
        self._handle = handle

    def launch(self) -> None:
        """One window on the current stream; no host read, no sync."""
        global windows
        with torch.cuda.device(self.device):
            rc = self._lib.graph_loop_launch(self._handle,
                                             torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"driver graph launch failed: CUDA error {rc}")
        windows += 1

    def account(self, units: int) -> None:
        """Charge one window's launches, ``units`` read from its state: P2
        ``units`` + 1 times, each recorded wrapper call ``units`` times."""
        global launches
        launches += int(units) + 1
        for (module, counter), calls in self.recorded.items():
            setattr(module, counter, getattr(module, counter) + calls * int(units))

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None and self._handle.value:
            self._lib.graph_loop_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
