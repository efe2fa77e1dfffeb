"""Device times of the small kernels of the planning and DiT paths, for
comparing two builds of the port on one card (no reference
counterpart: the reference times its Pallas kernels in
``benchmarks/run.py``).

Times, each the mean device time of one call from a replayed CUDA graph
of 40 calls (no host time between launches), with inputs rotated
through sets that stay in the 50 MB L2 where the path finds them there:

- the launch floor: a one-element ``zero_()`` in the same harness;
- K6 ``groupnorm_silu`` at each distinct (H, C) of a TRAJ_UNET forward
  (128 rows, 8 groups, fp32), and the sum of one forward's 17 launches;
- K1 ``error_step`` at the DiT's state (8, 196,608) and at planning's
  (64, 736), fp32, per-sample tolerances;
- K5 ``em_step`` at the DiT's state, Table 2's (256, 3072) and the
  tables' (4096, 2) and (2048, 2), fp32 and bf16;
- K3 ``flash_attention`` at the mixture-of-experts LMs' prefill shapes
  (``MOE_ATTN_SHAPES``) and llama-3.2-vision-90b's and musicgen-medium's
  (``VLM_AUDIO_ATTN_SHAPES``), causal, fp32, beside its plain version and
  SDPA (``is_causal``, ``enable_gqa``), and K7 ``ssd_scan`` at
  jamba-v0.1-52b's "M" layers (``JAMBA_SSD_SHAPE``, d_state 16) beside
  its plain ``ssd_chunked``.

Last it trains Table 1's VP ``TOY_MLP`` (600 steps) and times one
EM-1000 solve at N 4096 both ways (``table1_em_idle``): graphed, its
wall and its driver window's device span (CUDA events); host-driven,
its wall and the device idle share 1 − (device busy time of a profiled
solve, torch.profiler) / (wall time of an unprofiled one).

It calls only the wrappers' public functions, so it times any checkout
of the port: run this file by path with ``PYTHONPATH`` at that
checkout's ``src`` (the kernels build into that checkout's ``build/``),
e.g. the parent and this tree in turns on one card:

  PYTHONPATH=/path/to/parent/src python src/repro_torch/benchmarks/kernel_times.py
  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_times

Prints the card's name and power limit, then one JSON line. Needs a
CUDA card; exits 1 without one. ``graph_nodes`` (the kernels a captured
CUDA graph holds, read through the driver API) serves ``chip_smoke.py``
and the card tests' one-kernel-a-call checks.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys

import torch

#: (H, C) of TRAJ_UNET's 17 GroupNorm → SiLU launches a forward, in
#: order (horizon 32, base 32, mults (1, 2, 4)), at 8 groups
TRAJ_GN_SHAPES = ([(32, 32)] * 2 + [(16, 32), (16, 64), (8, 64)] + [(8, 128)] * 7
                  + [(16, 128), (16, 64), (32, 64), (32, 32), (32, 32)])
#: rows of a planning forward: 64 plans under classifier-free guidance
GN_ROWS = 128
GN_GROUPS = 8
#: K1's shapes: the DiT's state, planning's (horizon 32 × transition 23)
STEP_SHAPES = ((8, 196_608), (64, 736))
#: K5's shapes: the DiT's state, Table 2's, Table 1's and Tables 3/4–5's
EM_SHAPES = ((8, 196_608), (256, 3072), (4096, 2), (2048, 2))
#: the L2's bytes: sets of inputs larger than half of it rotate through 4
L2_BYTES = 50e6
#: K3 at the mixture-of-experts LMs' prefills, (B, Hq, Hkv, S, D), causal:
#: deepseek-moe-16b's "A" layers (MHA, head_dim 128), granite-moe-3b-a800m's
#: (GQA 24:8, 64) at S 4096, jamba-v0.1-52b's one "A" layer a period (GQA
#: 32:8, 128) at its (1, 2048) prefill
MOE_ATTN_SHAPES = {"deepseek-moe-16b": (1, 16, 16, 4096, 128),
                   "granite-moe-3b-a800m": (1, 24, 8, 4096, 64),
                   "jamba-v0.1-52b": (1, 32, 8, 2048, 128)}
#: K3 at llama-3.2-vision-90b's "A" layers in its (1, 4096) prefill (GQA
#: 64:8, head_dim 128) and at musicgen-medium's in its (4, 1500) prefill
#: (MHA 24 heads of 64; 30 s of audio at 50 frames a second, a ragged S)
VLM_AUDIO_ATTN_SHAPES = {"llama-3.2-vision-90b": (1, 64, 8, 4096, 128),
                         "musicgen-medium": (4, 24, 24, 1500, 64)}
#: K7 at jamba-v0.1-52b's "M" layers in its (1, 2048) prefill, (B, S, H, P,
#: G, N): d_inner 8192 in 128 heads of 64, one group, d_state 16
JAMBA_SSD_SHAPE = (1, 2048, 128, 64, 1, 16)


def device_ms(fn, sets, reps: int = 40, replays: int = 5) -> float:
    """Mean device ms per call: ``reps`` calls captured in one CUDA graph
    and replayed ``replays`` times, rotating through ``sets`` of inputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def graph_nodes(graph) -> dict:
    """The nodes of a CUDA graph captured with ``keep_graph=True``, read
    through the driver API (cuGraphGetNodes; a kernel node's function by
    cuGraphKernelNodeGetParams and cuFuncGetName or cuKernelGetName): the
    kernel nodes by function name, any other node under "other nodes".
    What the graph holds is what its capture launched; unlike a CUPTI
    trace, no record can be lost on the way."""
    import ctypes

    class KernelParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        rc = getattr(cu, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} returned CUresult {rc}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(count))
    if not count.value:  # an empty graph: the driver refuses a second call
        return {}
    nodes = (ctypes.c_void_p * count.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(count))
    held = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        key = "other nodes"
        if kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            p = KernelParams()
            call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(p))
            name = ctypes.c_char_p()
            if p.func:
                call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(p.func))
            else:
                call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(p.kern))
            key = name.value.decode()
        held[key] = held.get(key, 0) + 1
    return held


def launch_floor_ms(dev) -> float:
    """Device ms of the smallest kernel: ``zero_()`` of one element."""
    one = torch.empty(1, device=dev)
    return device_ms(lambda t: t.zero_(), [(one,)])


def groupnorm_times(dev, gen, fn=None) -> dict:
    """ms of ``fn(x, scale, bias)`` (default: the K6 wrapper at 8 groups)
    at each distinct (H, C) of a forward, keyed "HxC", and "forward", the
    sum over the forward's 17 launches."""
    if fn is None:
        from repro_torch.kernels.groupnorm_silu import ops as gn_ops
        fn = lambda x, s, b: gn_ops.groupnorm_silu(x, s, b, groups=GN_GROUPS)
    times = {}
    for h, c in dict.fromkeys(TRAJ_GN_SHAPES):
        sets = [(torch.randn(GN_ROWS, h, c, generator=gen, device=dev),
                 1 + 0.1 * torch.randn(c, generator=gen, device=dev),
                 0.1 * torch.randn(c, generator=gen, device=dev)) for _ in range(4)]
        times[f"{h}x{c}"] = device_ms(fn, sets)
    times["forward"] = sum(times[f"{h}x{c}"] for h, c in TRAJ_GN_SHAPES)
    return times


def solver_step_times(dev, gen) -> dict:
    """ms of the K1 wrapper at each of ``STEP_SHAPES``, keyed "BxD"."""
    from repro_torch.kernels.solver_step import ops as step_ops

    fn = lambda *a: step_ops.error_step(*a[:8], eps_abs=a[8], eps_rel=a[9])
    times = {}
    for b, d in STEP_SHAPES:
        sets = []
        for _ in range(4):
            states = [torch.randn(b, d, generator=gen, device=dev) for _ in range(5)]
            coeffs = [torch.rand(b, generator=gen, device=dev) for _ in range(3)]
            eps = [step_ops.per_sample_tolerance(e, b, dev) for e in (0.0078, 0.05)]
            sets.append((*states, *coeffs, *eps))
        times[f"{b}x{d}"] = device_ms(fn, sets)
    return times


def em_sets(dev, gen, b: int, d: int, dtype=torch.float32) -> list:
    """Input sets (x, score, z, c0, c1, c2) of K5 at (b, d): 8 of them, or
    4 where a set's 4·b·d elements pass half the L2, so the sets exceed
    it."""
    big = 4 * b * d * dtype.itemsize > L2_BYTES / 2
    return [tuple([torch.randn(b, d, generator=gen, device=dev).to(dtype) for _ in range(3)]
                  + [torch.rand(b, generator=gen, device=dev) for _ in range(3)])
            for _ in range(4 if big else 8)]


def em_step_times(dev, gen, dtype=torch.float32) -> dict:
    """ms of the K5 wrapper at each of ``EM_SHAPES`` in ``dtype``, keyed
    "BxD", on ``em_sets``."""
    from repro_torch.kernels.solver_step import ops as step_ops

    return {f"{b}x{d}": device_ms(step_ops.em_step, em_sets(dev, gen, b, d, dtype))
            for b, d in EM_SHAPES}


def causal_attention_times(dev, gen, shape) -> dict:
    """K3 at ``shape`` (B, Hq, Hkv, S, D), causal, fp32, on two input sets:
    device ms of the wrapper (``ms``), of its plain version
    (``plain_ms``) and of SDPA with ``is_causal`` and ``enable_gqa``
    (``library_ms``, a yardstick the port never calls), and SDPA's max
    abs difference from the plain version."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref

    B, Hq, Hkv, S, D = shape
    sets = [(torch.randn(B, Hq, S, D, generator=gen, device=dev),
             torch.randn(B, Hkv, S, D, generator=gen, device=dev),
             torch.randn(B, Hkv, S, D, generator=gen, device=dev)) for _ in range(2)]
    sdpa = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    plain = lambda q, k, v: flash_ref.attention(q, k, v, causal=True)
    out = {"ms": device_ms(lambda q, k, v: flash_ops.attention(q, k, v, causal=True), sets,
                           reps=8, replays=2),
           "plain_ms": device_ms(plain, sets, reps=2, replays=2),
           "library_ms": device_ms(sdpa, sets, reps=4, replays=2),
           "library_max_abs_diff": (sdpa(*sets[0]) - plain(*sets[0])).abs().max().item()}
    del sets
    torch.cuda.empty_cache()
    return out


def ssd_sets(dev, gen, shape, n: int = 2) -> list:
    """``n`` sets of K7's operands at ``shape`` (B, S, H, P, G, N), fp32, as
    the reference's kernel test draws them: x, B, C normal, dt =
    softplus(normal), A = −exp(normal)."""
    B, S, H, P, G, N = shape
    return [(torch.randn(B, S, H, P, generator=gen, device=dev),
             torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=dev)),
             -torch.exp(torch.randn(H, generator=gen, device=dev)),
             torch.randn(B, S, G, N, generator=gen, device=dev),
             torch.randn(B, S, G, N, generator=gen, device=dev)) for _ in range(n)]


def ssd_times(dev, gen, shape) -> dict:
    """K7 at ``shape``: device ms of the wrapper (``ms``, the range count it
    picks) and of the plain ``ssd_chunked`` (``plain_ms``)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    sets = ssd_sets(dev, gen, shape)
    return {"ms": device_ms(lambda *a: ssd_ops.ssd_scan(*a), sets, reps=10, replays=2),
            "plain_ms": device_ms(lambda *a: ssd_ref.ssd_chunked(*a), sets, reps=2, replays=2),
            "ranges": ssd_ops.ranges_for(sets[0][0])}


@contextlib.contextmanager
def window_events():
    """CUDA events around every driver window launched inside the block
    (``adaptive.HorizonDriver.window``): yields the list of (start, end)
    pairs. The profiler cannot trace a WHILE node, so a graphed solve's
    device span is read this way."""
    from repro_torch.core.solvers import adaptive as ad

    spans, real = [], ad.HorizonDriver.window

    def timed(self):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state = real(self)
        e1.record()
        spans.append((e0, e1))
        return state

    ad.HorizonDriver.window = timed
    try:
        yield spans
    finally:
        ad.HorizonDriver.window = real


def table1_em_idle(dev, n_steps: int = 1000) -> dict:
    """Table 1's EM row (VP, N 4096, the 600-step TOY_MLP, ``n_steps`` K5
    launches) graphed and host-driven. Graphed: the wall of a replayed
    solve (the key's first two solves run before it: the host-driven
    first and the capture) and the device span of its driver window
    (``window_events``; None where the solve ran no window). Host-driven:
    the wall of the chain (a fresh wrapper of the score is a new key, so
    its one solve is the key's first) and the device busy time of a
    profiled one, with K5's part and the idle share 1 − busy / wall."""
    import time

    from repro_torch.benchmarks.common import trained_mlp_score
    from repro_torch.core.sampling import sample

    sde, score_fn = trained_mlp_score("vp", steps=600, device=dev)

    def run(score):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(sde, score, (4096, 2), seed=42, method="em", n_steps=n_steps, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(score_fn)
    run(score_fn)
    with window_events() as spans:
        graphed = run(score_fn)
    window = sum(e0.elapsed_time(e1) for e0, e1 in spans) if spans else None
    host = run(lambda x, t: score_fn(x, t))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(lambda x, t: score_fn(x, t))
    busy = em = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.device_time_total
            em += e.device_time_total if "em_step_kernel" in e.name else 0.0
    return {"graphed_wall_ms": graphed * 1e3, "window_ms": window,
            "window_share": None if window is None else window / (graphed * 1e3),
            "wall_ms": host * 1e3, "busy_ms": busy / 1e3, "em_step_ms": em / 1e3,
            "idle_share": 1 - busy / 1e3 / (host * 1e3)}


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main() -> None:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import repro_torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"package": repro_torch.__file__, "floor_ms": launch_floor_ms(dev),
              "groupnorm_silu_ms": groupnorm_times(dev, gen),
              "solver_step_ms": solver_step_times(dev, gen),
              "em_step_ms": {"fp32": em_step_times(dev, gen),
                             "bf16": em_step_times(dev, gen, torch.bfloat16)},
              "table1_em1000": table1_em_idle(dev),
              "moe_lm_attention": {name: causal_attention_times(dev, gen, shape)
                                   for name, shape in MOE_ATTN_SHAPES.items()},
              "vlm_audio_lm_attention": {name: causal_attention_times(dev, gen, shape)
                                         for name, shape in VLM_AUDIO_ATTN_SHAPES.items()},
              "jamba_ssd": ssd_times(dev, gen, JAMBA_SSD_SHAPE)}
    print(card())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
