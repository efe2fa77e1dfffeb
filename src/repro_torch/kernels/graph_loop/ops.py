"""Wrappers of the device-resident driver (``csrc/while_driver.cu``): the
WHILE-node graph around a captured sync horizon, and P2
(``horizon_cond``), its condition.

``WhileDriver(horizon_graph, occupied, done, state, ...)`` builds the
parent graph once from a ``torch.cuda.CUDAGraph`` captured with
``keep_graph=True`` (its ``raw_cuda_graph()``): P2 with n = 0, then a
WHILE node whose body is the horizon followed by P2. ``launch()`` runs
one driver window on PyTorch's current stream and returns at once;
``state`` (2 int32 on the device) then holds the event flag of the carry
at exit and the horizons run, the one thing the host reads.

``horizon_cond`` launches P2 alone, outside a graph, on hand-built masks
(its check and its time); CPU tensors take ``ref.horizon_cond``.

``launches`` counts P2's kernel executions: one an eager call, and
``horizons + 1`` a driver window. A graph's kernels run where the host
cannot count them, so ``WhileDriver.account`` charges a window once the
caller has read its state: P2's executions, and for each wrapper the
horizon runs (K1/K2, K4, K5, K3, K6, P1) its calls recorded into the horizon
at capture (``captured_calls``) times the horizons run. ``windows`` counts
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


def _declare(lib):
    if lib.graph_loop_build.argtypes is None:
        lib.graph_loop_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.graph_loop_build.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                                         + [ctypes.c_int] * 2
                                         + [ctypes.POINTER(ctypes.c_void_p)])
        lib.graph_loop_launch.argtypes = [ctypes.c_void_p] * 2
        lib.graph_loop_destroy.argtypes = [ctypes.c_void_p]
        lib.graph_loop_cond.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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
    graphs so far}, for the wrappers a captured horizon runs: K1/K2, K4
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


def _check_masks(occupied: Tensor, done: Tensor, state: Tensor) -> None:
    if occupied.dtype != torch.bool or done.dtype != torch.bool:
        raise TypeError("occupied and done must be bool")
    if occupied.ndim != 1 or done.shape != occupied.shape:
        raise ValueError(f"occupied {tuple(occupied.shape)} and done {tuple(done.shape)} "
                         "must both be (B,)")
    if state.dtype != torch.int32 or state.shape != (2,):
        raise ValueError("state must be 2 int32")
    if not (occupied.device == done.device == state.device):
        raise ValueError("occupied, done and state must be on one device")
    if not (occupied.is_contiguous() and done.is_contiguous() and state.is_contiguous()):
        raise ValueError("occupied, done and state must be contiguous")


def horizon_cond(occupied: Tensor, done: Tensor, state: Tensor, *, wait_all: bool,
                 max_horizons: int, first: bool) -> Tensor:
    """P2 on its own: state ← [event, n] in place (n = 0 with ``first``,
    else state[1] + 1); returns ``state``."""
    global launches
    _check_masks(occupied, done, state)
    if occupied.device.type == "cpu":
        ref.horizon_cond(occupied, done, state, wait_all=wait_all,
                         max_horizons=max_horizons, first=first)
        return state
    lib = _declare(_build.library())
    with torch.cuda.device(occupied.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.graph_loop_cond(occupied.data_ptr(), done.data_ptr(), occupied.shape[0],
                                 state.data_ptr(), int(wait_all), int(max_horizons),
                                 int(first), stream)
    if rc != 0:
        raise RuntimeError(f"horizon_cond kernel launch failed: CUDA error {rc}")
    launches += 1
    return state


class WhileDriver:
    """The instantiated parent graph around one captured horizon. It keeps
    the horizon graph, the masks and ``state`` alive as long as it lives;
    the masks and the carry the horizon writes must stay where they are.
    ``recorded`` is {(wrapper module, its launch counter): its calls in
    one horizon}, the difference of ``captured_calls()`` across the
    horizon's capture."""

    def __init__(self, horizon: "torch.cuda.CUDAGraph", occupied: Tensor, done: Tensor,
                 state: Tensor, *, recorded: dict, max_horizons: int, wait_all: bool):
        _check_masks(occupied, done, state)
        if occupied.device.type != "cuda":
            raise ValueError("the WHILE driver runs on the card; the CPU takes ref.solve_horizons")
        require_conditional_nodes()
        self._lib = _declare(_build.library())
        self._keep = (horizon, occupied, done, state)
        self.recorded = dict(recorded)
        self.device = occupied.device
        handle = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            rc = self._lib.graph_loop_build(horizon.raw_cuda_graph(), occupied.data_ptr(),
                                            done.data_ptr(), occupied.shape[0],
                                            state.data_ptr(), int(wait_all),
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

    def account(self, horizons: int) -> None:
        """Charge one window's launches, ``horizons`` read from its state:
        P2 ``horizons`` + 1 times, each recorded wrapper call ``horizons``
        times."""
        global launches
        launches += int(horizons) + 1
        for (module, counter), calls in self.recorded.items():
            setattr(module, counter, getattr(module, counter) + calls * int(horizons))

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None and self._handle.value:
            self._lib.graph_loop_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
