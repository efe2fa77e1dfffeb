"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a card; the decision
is made inside the ``cuda`` fixture, never at import or collection time.
Run them on a machine with an H100:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Bounds: solver step fp32 1e-5 (the kernel contracts a·b + c into FMAs
and sums the row in another order); bf16 1e-2 on x'' (one bf16 ulp)
with e2 still fp32 1e-5; flash attention fp32 3e-5 and bf16 2e-2, as on
the CPU side, and the same bits on a second call and for strided views; GroupNorm → SiLU fp32 1e-5 absolute and bf16 one bf16 ulp
plus that 1e-5 (both sides compute in fp32 and round once, so the
rounded outputs differ by at most an ulp more than the fp32 values,
which matters near zero, where an ulp is smaller than the fp32
difference), 2e-3 absolute on the
x = 1e3 + N(0, 1) slabs (the sums reach 1e3·n, where fp32 spacing is
about 1e-4·n, added in another order). K5 ``em_step``: bitwise equal to
its plain version (both round each product and sum once, in the same
order, and the bf16 store once), held to two ulps of the output dtype at
max|x'|. EM and PC on the card against the same solve on the CPU with
the same injected noise: rtol 1e-5 with atol 1e-5·max|x| (the closed-form
score's exp, sqrt and pow round differently on the two devices).
K7 ``ssd_scan``: against the sequential oracle rtol = atol = 3e-4, the
reference's own bound of its kernel (``tests/test_kernels_ssd.py``);
against the plain chunked version 6e-4, since each of the two is held to
3e-4 of the oracle and they chunk differently (64 against 128 rows); bf16
one bf16 ulp more. Bitwise equal on a second call, at every range count
the kernel may run. K4, the sharded step:
x'' bitwise equal to K1's on every column range and batch half; the
partial sums within 1e-5 of the plain version's, as K1's e2; the range
sums combined within 1e-6 of K1's e2 (the same tile sums in another
grouping); batch-only e2 bitwise equal to K1's. "One CUDA kernel a call"
reads the kernel nodes of a CUDA graph that captured the calls (the
driver API), not a torch.profiler trace, which can lose records.
A scaled-down musicgen-medium train step on the card against the same
step on the CPU: the loss within 1e-5 relative, each leaf's update
within 2e-4·(1 + max|update|), or 2·lr where the clipped gradient is
within 1e3·ε of 0 (AdamW's first step turns a last-bit gradient
difference there into an update difference of up to lr).
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.groupnorm_silu import ops as gn_ops
from repro_torch.kernels.groupnorm_silu import ref as gn_ref
from repro_torch.kernels.solver_step import ops as step_ops
from repro_torch.kernels.solver_step import ref as step_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
import numpy as np

from repro_torch.core import analytic as tan
from repro_torch.core.sde import VESDE, VPSDE
from repro_torch.core.solvers import get_solver
from repro_torch.core.solvers.adaptive import AdaptiveConfig
from repro_torch.models import dit as tdit
from repro_torch.models import temporal_unet as ttu
from repro_torch.planning import PlannerConfig, plan

pytestmark = pytest.mark.gpu

X_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
         torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
A_TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),
         torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on a machine with an H100")
    return torch.device("cuda")


def _step_inputs(B, D, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    states = [torch.randn(B, D, generator=g, device=dev).to(dtype) for _ in range(5)]
    coeffs = [torch.rand(B, generator=g, device=dev) for _ in range(3)]
    eps = (torch.rand(B, generator=g, device=dev) * 0.1 + 1e-3,
           torch.rand(B, generator=g, device=dev) * 0.5 + 0.01)
    return states, coeffs, eps


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [196_608, 4_999], ids=["main_path", "ragged"])
def test_solver_step_kernel_matches_plain(cuda, D, dtype, vector):
    states, coeffs, (ea, er) = _step_inputs(8, D, dtype, cuda)
    kw = dict(eps_abs=ea, eps_rel=er) if vector else dict(eps_abs=0.0078, eps_rel=0.05)
    before = step_ops.launches
    xh, e2 = step_ops.error_step(*states, *coeffs, **kw)
    assert step_ops.launches == before + 1
    ea_v = step_ops.per_sample_tolerance(kw["eps_abs"], 8, cuda)
    er_v = step_ops.per_sample_tolerance(kw["eps_rel"], 8, cuda)
    xr, er2 = step_ref.error_step(*states, *coeffs, ea_v, er_v)
    torch.cuda.synchronize()
    torch.testing.assert_close(xh.float(), xr.float(), **X_TOL[dtype])
    torch.testing.assert_close(e2, er2, rtol=1e-5, atol=1e-6)
    again = step_ops.error_step(*states, *coeffs, **kw)
    assert torch.equal(again[0], xh) and torch.equal(again[1], e2)  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("D", [196_608, 4_999], ids=["main_path", "ragged"])
def test_sharded_step_partial_sums_match_plain(cuda, D, f, dtype):
    """K4's partial mode on f column ranges of the DiT state (views, read in
    place): x'' bitwise equal to K1's columns, the sums within 1e-5 of the
    plain version's, and the sums combined in range order within 1e-6 of
    K1's e2 on the whole state (the same tile sums, added in another
    grouping)."""
    states, coeffs, (ea, er) = _step_inputs(8, D, dtype, cuda, seed=1)
    xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
    before = step_ops.sharded_launches
    total = torch.zeros(8, device=cuda)
    for i in range(f):
        a, b = step_ops.feature_range(D, f, i)
        block = [t[:, a:b] for t in states]
        bx, bs = step_ops.error_step_sums(*block, *coeffs, eps_abs=ea, eps_rel=er)
        px, ps = step_ref.error_step_sums(*block, *coeffs, ea, er)
        torch.cuda.synchronize()
        assert torch.equal(bx, xh[:, a:b])
        torch.testing.assert_close(bx.float(), px.float(), **X_TOL[dtype])
        torch.testing.assert_close(bs, ps, rtol=1e-5, atol=0)
        total = total + bs
    assert step_ops.sharded_launches == before + f
    torch.testing.assert_close(torch.sqrt(total / D), e2, rtol=1e-6, atol=0)


@pytest.fixture
def one_rank_mesh(cuda):
    """A 1×1 mesh over a real NCCL process group of one rank."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.sharded_selftest import free_port
    from repro_torch.parallel import init_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield init_mesh(1, 1, device=cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_sharded_step_on_batch_halves_is_k1_bitwise(cuda, one_rank_mesh, dtype):
    """``sharded_error_step`` on each half of the batch (a one-rank NCCL
    mesh) gives K1's bits for those rows, batch-only and through the
    partial mode and its all-reduce with a feature axis of one."""
    states, coeffs, (ea, er) = _step_inputs(8, 196_608, dtype, cuda, seed=2)
    xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
    mesh = one_rank_mesh
    for rows in (slice(0, 4), slice(4, 8)):
        local = [t[rows] for t in states] + [c[rows] for c in coeffs]
        bx, be = step_ops.sharded_error_step(*local, eps_abs=ea[rows], eps_rel=er[rows],
                                             mesh=mesh, batch_axes="data")
        fx, fe = step_ops.sharded_error_step(*local, eps_abs=ea[rows], eps_rel=er[rows],
                                             mesh=mesh, batch_axes="data",
                                             feature_axis="model")
        torch.cuda.synchronize()
        assert torch.equal(bx, xh[rows]) and torch.equal(be, e2[rows])
        assert torch.equal(fx, xh[rows])
        torch.testing.assert_close(fe, e2[rows], rtol=1e-6, atol=0)


def _kernel_names(fn, calls=8):
    """Names of the CUDA kernels ``calls`` calls of ``fn`` launch, one entry
    a launch: the kernel nodes of a CUDA graph that captured the calls
    (``kernel_times.graph_nodes``, the driver API; a torch.profiler trace
    can lose records). Copies and memsets are nodes of another kind."""
    from repro_torch.benchmarks.kernel_times import graph_nodes

    fn()  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    nodes = graph_nodes(graph)
    return [name for name, n in nodes.items() if name != "other nodes" for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [736, 2048, 2049, 3073, 4_999, 196_608])
def test_solver_step_kernel_widths_batches_and_unaligned_views(cuda, D, dtype):
    """K1 at one 3072-column tile a row (736, 2048, 2049), at two (3073, and
    4999, ragged) and many (the DiT's 196,608), at B = 1 and 8: one launch,
    within the plain version's
    bounds, the same bits twice. Operands 1 element into their buffers
    (off 16 bytes, so single-element loads) give the aligned copies' bits:
    the load width never changes the order of the sums."""
    for B in (1, 8):
        states, coeffs, (ea, er) = _step_inputs(B, D, dtype, cuda, seed=D + B)
        before = step_ops.launches
        xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
        assert step_ops.launches == before + 1
        xr, e2r = step_ref.error_step(*states, *coeffs, ea, er)
        torch.cuda.synchronize()
        torch.testing.assert_close(xh.float(), xr.float(), **X_TOL[dtype])
        torch.testing.assert_close(e2, e2r, rtol=1e-5, atol=1e-6)
        again = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
        assert torch.equal(again[0], xh) and torch.equal(again[1], e2)
        views = []
        for t in states:
            buf = torch.empty(B * D + 1, dtype=dtype, device=cuda)
            views.append(buf[1:].view(B, D))
            views[-1].copy_(t)
        assert not step_ops.runs_aligned(views[:1])
        vx, ve = step_ops.error_step(*views, *coeffs, eps_abs=ea, eps_rel=er)
        assert torch.equal(vx, xh) and torch.equal(ve, e2)


@pytest.mark.parametrize("D", [736, 4_999, 196_608])
def test_solver_step_row_bits_independent_of_batch(cuda, D):
    """A row gives the same bits at B = 64 and in any sub-batch, as a view
    (same addresses) or a contiguous copy (other alignment)."""
    states, coeffs, (ea, er) = _step_inputs(64, D, torch.float32, cuda, seed=7)
    xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
    for rows in (slice(0, 1), slice(5, 6), slice(3, 40), slice(63, 64), slice(1, 64)):
        for copy in (False, True):
            part = [t[rows].contiguous() if copy else t[rows] for t in states]
            bx, be = step_ops.error_step(*part, *(c[rows] for c in coeffs),
                                         eps_abs=ea[rows], eps_rel=er[rows])
            assert torch.equal(bx, xh[rows]) and torch.equal(be, e2[rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_sharded_step_partial_sums_at_odd_column_offsets(cuda, dtype):
    """K4's partial mode on column ranges that start off 16 bytes (columns
    1 and 3 of the DiT state, and a ragged D): x'' bitwise equal to K1's
    columns, the sums within 1e-5 of the plain version's."""
    for D, (a, b) in ((196_608, (1, 98_305)), (196_608, (3, 196_608)), (4_999, (1, 2_501))):
        states, coeffs, (ea, er) = _step_inputs(8, D, dtype, cuda, seed=a + D)
        xh, _ = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
        block = [t[:, a:b] for t in states]
        assert not step_ops.runs_aligned(block[:1])
        bx, bs = step_ops.error_step_sums(*block, *coeffs, eps_abs=ea, eps_rel=er)
        px, ps = step_ref.error_step_sums(*block, *coeffs, ea, er)
        torch.cuda.synchronize()
        assert torch.equal(bx, xh[:, a:b])
        torch.testing.assert_close(bs, ps, rtol=1e-5, atol=0)


@pytest.mark.parametrize("D", [736, 196_608])
def test_solver_step_is_one_cuda_kernel_a_call(cuda, D):
    """With (B,) tolerances (no fill for a scalar one), a call runs exactly
    one CUDA kernel, at one tile a row and at many: 8 calls, 8 kernels."""
    states, coeffs, (ea, er) = _step_inputs(8, D, torch.float32, cuda, seed=3)
    step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
    names = _kernel_names(lambda: step_ops.error_step(*states, *coeffs, eps_abs=ea,
                                                      eps_rel=er))
    assert len(names) == 8 and all("error_step_kernel" in n for n in names), names


def test_solver_step_in_a_cuda_graph_matches_eager(cuda):
    """Captured in a CUDA graph and replayed three times, the DiT-shape
    step (its row counters persist across calls) gives the eager bits on
    every replay."""
    states, coeffs, (ea, er) = _step_inputs(8, 196_608, torch.float32, cuda, seed=4)
    want = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
                for _ in range(3)]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for xh, e2 in outs:
            assert torch.equal(xh, want[0]) and torch.equal(e2, want[1])
    assert torch.equal(step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)[1],
                       want[1])


CASES = [
    # B, Hq, Hkv, S, D, causal, window, dtype
    (8, 12, 12, 256, 64, False, None, torch.float32),
    (8, 12, 12, 256, 64, False, None, torch.bfloat16),
    (2, 4, 2, 200, 32, True, 64, torch.float32),
    (1, 2, 1, 25, 16, False, None, torch.float32),
    (1, 4, 4, 64, 256, True, None, torch.float32),
    (128, 4, 4, 8, 32, False, None, torch.float32),    # the planning shape
    (128, 4, 4, 8, 32, False, None, torch.bfloat16),
    (2, 4, 2, 200, 32, True, 64, torch.bfloat16),      # GQA, causal, window
    (1, 4, 4, 64, 256, True, None, torch.bfloat16),
    (1, 16, 8, 4096, 256, True, 1024, torch.float32),  # gemma3-12b's "L" prefill
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case):
    B, Hq, Hkv, S, D, causal, window, dtype = case
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, Hq, S, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, Hkv, S, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    out = flash_ops.attention(q, k, v, causal=causal, window=window)
    want = flash_ref.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **A_TOL[dtype])


def test_flash_attention_gemma3_shapes(cuda):
    """gemma3-12b's prefill shapes, "L" (causal, window 1024: most key tiles
    skipped, so a wrong first tile shows only at long S) and "A"
    (causal), GQA 16:8 at head_dim 256, fp32: within the bound of the
    plain version, the same bits on a second call, one CUDA kernel a
    call."""
    q, k, v = _qkv_on(cuda, 1, 16, 8, 4096, 256, torch.float32, seed=7)
    for window in (1024, None):
        out = flash_ops.attention(q, k, v, causal=True, window=window)
        want = flash_ref.attention(q, k, v, causal=True, window=window)
        torch.testing.assert_close(out, want, **A_TOL[torch.float32])
        assert torch.equal(flash_ops.attention(q, k, v, causal=True, window=window), out)
        names = _kernel_names(lambda: flash_ops.attention(q, k, v, causal=True, window=window),
                              calls=2)
        assert len(names) == 2 and all("flash_fwd_kernel" in n for n in names), names


def test_flash_attention_head_dim_128(cuda):
    """deepseek-moe-16b's attention (MHA 16 heads, head_dim 128: the
    ``Cfg<float, 128>`` instantiation), causal, fp32, at S = 512: within
    the bound of the plain version, the same bits on a second call."""
    q, k, v = _qkv_on(cuda, 1, 16, 16, 512, 128, torch.float32, seed=8)
    out = flash_ops.attention(q, k, v, causal=True)
    want = flash_ref.attention(q, k, v, causal=True)
    torch.testing.assert_close(out, want, **A_TOL[torch.float32])
    assert torch.equal(flash_ops.attention(q, k, v, causal=True), out)


@pytest.mark.parametrize("shape", [(1, 64, 8, 512, 128), (2, 24, 24, 300, 64)],
                         ids=["llama_gqa8", "musicgen_ragged"])
def test_flash_attention_new_lm_shapes(cuda, shape):
    """llama-3.2-vision-90b's "A" layers (GQA 64:8, a group of 8) and
    musicgen-medium's (MHA 24 heads at head_dim 64, a ragged S), causal,
    fp32, at a short S: within the bound of the plain version, the same
    bits on a second call."""
    B, Hq, Hkv, S, D = shape
    q, k, v = _qkv_on(cuda, B, Hq, Hkv, S, D, torch.float32, seed=9)
    out = flash_ops.attention(q, k, v, causal=True)
    want = flash_ref.attention(q, k, v, causal=True)
    torch.testing.assert_close(out, want, **A_TOL[torch.float32])
    assert torch.equal(flash_ops.attention(q, k, v, causal=True), out)


def test_musicgen_train_step_on_card_matches_cpu(cuda):
    """One scaled-down musicgen-medium train step (4 codebooks, the delay
    pattern, plain attention under grad) on the card against the same step
    on the CPU: the loss within 1e-5 relative, each updated leaf within
    2e-4·(1 + max|update|) of the CPU's, or 2·lr where the CPU's clipped
    gradient is within 1e3·ε of 0 (AdamW's first step moves such an element by up
    to lr on a last-bit difference)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig, synth_batch
    from repro_torch.launch.steps import make_loss_fn, make_train_step
    from repro_torch.models import init_model
    from repro_torch.models.transformer import _map
    from repro_torch.optim import AdamW, global_norm

    cfg = get_config("musicgen-medium").scaled_down()
    toks = synth_batch(TokenPipelineConfig(cfg.vocab_size, 32, 2, num_codebooks=4), 0)
    lr = 1e-3
    fresh = init_model(cfg, 0, device="cpu")
    flat = []
    _map(lambda a: flat.append(a.requires_grad_(True)), fresh)
    loss, _, _ = make_loss_fn(cfg)(fresh, {"tokens": toks})
    grads = torch.autograd.grad(loss, flat)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        params = _map(lambda a: a.to(dev), init_model(cfg, 0, device="cpu"))
        old = []
        _map(lambda a: old.append(a.detach().cpu().clone()), params)
        opt = AdamW(lr=lr)
        params, _, m = make_train_step(cfg, opt, device=dev)(params, opt.init(params),
                                                             {"tokens": toks})
        new = []
        _map(lambda a: new.append(a.detach().cpu()), params)
        out[dev.type] = (float(m["loss"]), [n - o for n, o in zip(new, old)])
    (loss_c, upd_c), (loss_g, upd_g) = out["cpu"], out[cuda.type]
    assert loss_c == float(loss.detach())
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    clip = min(1.0, 1.0 / max(float(global_norm(list(grads))), 1e-9))
    for a, b, g in zip(upd_g, upd_c, grads):
        err = (a - b).abs()
        sharp = g.abs() * clip > 1e3 * 1e-8
        assert (err[sharp] <= 2e-4 * (1 + b.abs().max())).all()
        assert (err <= 2 * lr).all()


def test_apply_moe_on_card_matches_cpu(cuda):
    """The mixture-of-experts MLP at deepseek-moe-16b's per-layer widths
    (d_model 2048, 64 experts of 1408, top-6, shared 2816), 1024 tokens
    in 2 groups of 512, both dispatches, on the card against the same call
    on the CPU (TF32 off): the same routing decisions, y within
    1e-5·(1 + max|y|), the aux loss within 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import pin_full_fp32_math
    from repro_torch.models import apply_moe, init_moe

    pin_full_fp32_math()
    cfg = get_config("deepseek-moe-16b")
    params = init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 512, cfg.d_model, generator=torch.Generator().manual_seed(1))
    on_card = {k: (v.to(cuda) if k != "shared" else {n: w.to(cuda) for n, w in v.items()})
               for k, v in params.items()}
    for dispatch in ("einsum", "gather"):
        want_rec, got_rec = [], []
        want, want_aux = apply_moe(params, x, cfg, dispatch=dispatch, routing=want_rec)
        got, aux = apply_moe(on_card, x.to(cuda), cfg, dispatch=dispatch, routing=got_rec)
        assert want_rec[0]["expert_idx"].shape == (2, 512, 6)
        for key in ("expert_idx", "pos", "keep"):
            assert torch.equal(got_rec[0][key].cpu(), want_rec[0][key]), (dispatch, key)
        bound = 1e-5 * (1 + want.abs().max().item())
        assert (got.cpu() - want).abs().max().item() <= bound, dispatch
        assert abs(aux.item() - want_aux.item()) <= 1e-6


def _qkv_on(dev, B, Hq, Hkv, S, D, dtype, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hq, S, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, Hkv, S, D, generator=g, device=dev).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_ragged_tiles_and_true_len(cuda, dtype, causal):
    """S = 75 is no multiple of the kernel's 32-key tile, and keys at or
    past true_len = 50 are masked: the ragged tiles are zero-filled."""
    q, k, v = _qkv_on(cuda, 2, 4, 4, 75, 64, dtype)
    out = flash_ops.attention(q, k, v, causal=causal, true_len=50)
    want = flash_ref.attention(q, k, v, causal=causal, true_len=50)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **A_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_same_bits_on_a_second_call(cuda, dtype):
    """No atomics and fixed-order sums: the DiT's shape gives the same bits
    on every call."""
    q, k, v = _qkv_on(cuda, 8, 12, 12, 256, 64, dtype)
    first = flash_ops.attention(q, k, v, causal=False)
    assert torch.equal(flash_ops.attention(q, k, v, causal=False), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_model_layout_views_are_bitwise_copies(cuda, dtype):
    """The DiT hands over transposed (B, S, H, D) views, read in place
    through their strides: bitwise the result of contiguous copies. A view
    whose rows are not 16-byte aligned is refused."""
    g = torch.Generator(device=cuda).manual_seed(2)
    views = [torch.randn(8, 256, 12, 64, generator=g, device=cuda).to(dtype).transpose(1, 2)
             for _ in range(3)]
    assert not views[0].is_contiguous()
    out = flash_ops.attention(*views, causal=False)
    assert torch.equal(out, flash_ops.attention(*(a.contiguous() for a in views),
                                                causal=False))
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops.attention(views[0][..., 1:33], views[1][..., :32], views[2][..., :32])


def test_flash_attention_odd_head_width_view_gets_aligned_output(cuda):
    """q/k/v are views of wider rows (head width 33 of 36): their rows are
    aligned, so the kernel takes them, and the output, which cannot copy
    q's non-dense layout, gets rows padded to a 16-byte multiple."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 4, 40, 36, generator=g, device=cuda)[..., :33] for _ in range(3))
    out = flash_ops.attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.stride(2) % 4 == 0
    torch.testing.assert_close(out, flash_ref.attention(q, k, v, causal=True),
                               **A_TOL[torch.float32])


def test_dit_forward_flash_matches_plain_on_card(cuda):
    cfg = tdit.DiTConfig(image_size=32, patch=4, d_model=128, num_layers=2,
                         num_heads=4, d_ff=256)
    model = tdit.init_dit(cfg, torch.Generator(device=cuda).manual_seed(0))
    tdit.liven_zero_init(model, torch.Generator(device=cuda).manual_seed(1))
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4, 32, 32, 3, generator=g, device=cuda)
    t = torch.linspace(0.1, 1.0, 4, device=cuda)
    with torch.no_grad():  # the DiT's leaves are trainable; the kernel has no backward
        plain = model(x, t)
        model.cfg = dataclasses.replace(cfg, use_flash=True)
        before = flash_ops.launches
        fast = model(x, t)
    assert flash_ops.launches == before + cfg.num_layers
    torch.testing.assert_close(fast, plain, rtol=1e-4, atol=1e-4)
    assert plain.abs().mean() > 1e-2


#: (H, C) of TRAJ_UNET's 17 GroupNorm → SiLU launches per forward, g = 8
TRAJ_GN_SHAPES = ([(32, 32)] * 2 + [(16, 32), (16, 64), (8, 64)] + [(8, 128)] * 7
                  + [(16, 128), (16, 64), (32, 64), (32, 32), (32, 32)])


def _bf16_ulp(a):
    mag = a.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _gn_inputs(B, H, C, dev, dtype, offset=0.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (offset + torch.randn(B, H, C, generator=g, device=dev)).to(dtype)
    scale = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
    bias = 0.1 * torch.randn(C, generator=g, device=dev)
    return x, scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("i", range(len(TRAJ_GN_SHAPES)))
def test_groupnorm_silu_kernel_matches_plain(cuda, i, dtype):
    H, C = TRAJ_GN_SHAPES[i]
    x, scale, bias = _gn_inputs(128, H, C, cuda, dtype, seed=i)
    before = gn_ops.launches
    out = gn_ops.groupnorm_silu(x, scale, bias, groups=8)
    assert gn_ops.launches == before + 1
    want = gn_ref.groupnorm_silu(x, scale, bias, groups=8)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    diff = (out.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
    else:
        assert (diff <= torch.maximum(_bf16_ulp(out), _bf16_ulp(want)) + 1e-5).all()
    again = gn_ops.groupnorm_silu(x, scale, bias, groups=8)
    assert torch.equal(again, out)  # deterministic


def test_groupnorm_silu_kernel_large_offset_and_edges(cuda):
    x, _, _ = _gn_inputs(128, 32, 64, cuda, torch.float32, offset=1e3)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    out = gn_ops.groupnorm_silu(x, ones, zeros, groups=8)
    torch.testing.assert_close(out, gn_ref.groupnorm_silu(x, ones, zeros, groups=8),
                               rtol=0, atol=2e-3)
    assert 0.3 < float(out.std()) < 1.2
    for (B, H, C, G) in ((3, 30, 96, 6), (2, 16, 4, 8), (1, 64, 256, 8)):
        x, s, b = _gn_inputs(B, H, C, cuda, torch.float32, seed=C)
        torch.testing.assert_close(gn_ops.groupnorm_silu(x, s, b, groups=G),
                                   gn_ref.groupnorm_silu(x, s, b, groups=G),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        gn_ops.groupnorm_silu(x[:, ::2], s, b, groups=G)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("i", range(len(TRAJ_GN_SHAPES)))
def test_groupnorm_silu_general_path_matches_plain(cuda, i, dtype):
    """The general kernel, forced, at every TRAJ_UNET shape (the register
    kernel is the one the wrapper picks there): the same bounds and the
    same bits twice."""
    H, C = TRAJ_GN_SHAPES[i]
    assert gn_ops.kernel_config(128, H, C, 8, dtype, True)["path"] == "register"
    x, scale, bias = _gn_inputs(128, H, C, cuda, dtype, seed=100 + i)
    out = gn_ops._launch(x, scale, bias, groups=8, eps=1e-6, path="general")
    want = gn_ref.groupnorm_silu(x, scale, bias, groups=8)
    torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
    else:
        assert (diff <= torch.maximum(_bf16_ulp(out), _bf16_ulp(want)) + 1e-5).all()
    assert torch.equal(gn_ops._launch(x, scale, bias, groups=8, eps=1e-6, path="general"), out)


@pytest.mark.parametrize("path", [None, "general"], ids=["chosen", "general"])
def test_groupnorm_silu_both_paths_large_offset_and_edges(cuda, path):
    """x = 1e3 + N(0, 1) at (128, 32, 64) within 2e-3 and with its spread,
    the odd shapes of the edge test (6 groups; C/g 1; a 2048-element slab:
    general either way) and register-path edges (30 rows of C/g 16; the
    largest register slab, 1024; C/g 512, wider than a team of vectors,
    so a lane's vectors take other channels), each the same bits twice;
    an x 4 bytes into its buffer takes the general path."""
    run = lambda x, s, b, g: gn_ops._launch(x, s, b, groups=g, eps=1e-6, path=path)
    x, _, _ = _gn_inputs(128, 32, 64, cuda, torch.float32, offset=1e3)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    out = run(x, ones, zeros, 8)
    torch.testing.assert_close(out, gn_ref.groupnorm_silu(x, ones, zeros, groups=8),
                               rtol=0, atol=2e-3)
    assert 0.3 < float(out.std()) < 1.2 and torch.equal(run(x, ones, zeros, 8), out)
    for (B, H, C, G) in ((3, 30, 96, 6), (2, 16, 4, 8), (1, 64, 256, 8), (5, 16, 24, 8),
                         (3, 30, 128, 8), (2, 64, 128, 8), (2, 2, 1024, 2)):
        x, s, b = _gn_inputs(B, H, C, cuda, torch.float32, seed=C)
        g = min(G, C)
        out = run(x, s, b, g)
        torch.testing.assert_close(out, gn_ref.groupnorm_silu(x, s, b, groups=G),
                                   rtol=0, atol=1e-5)
        assert torch.equal(run(x, s, b, g), out)
    x, s, b = _gn_inputs(128, 32, 64, cuda, torch.float32, seed=9)
    view = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    view.copy_(x)
    torch.testing.assert_close(run(view, s, b, 8), gn_ref.groupnorm_silu(x, s, b, groups=8),
                               rtol=0, atol=1e-5)


def test_groupnorm_silu_is_one_cuda_kernel_a_call(cuda):
    x, s, b = _gn_inputs(128, 32, 64, cuda, torch.float32)
    gn_ops.groupnorm_silu(x, s, b, groups=8)
    names = _kernel_names(lambda: gn_ops.groupnorm_silu(x, s, b, groups=8))
    assert len(names) == 8 and all("gn_silu_regs" in n for n in names), names


def test_small_plan_on_card_runs_all_three_kernels(cuda):
    cfg = ttu.TemporalUNetConfig(horizon=16, transition_dim=6, base=16, mults=(1, 2),
                                 t_dim=32, groups=4, returns_bins=4, attention=True,
                                 attn_heads=2, use_flash=True, use_fused_norm=True)
    model = ttu.init_temporal_unet(cfg, torch.Generator(device=cuda).manual_seed(0))
    ttu.liven_zero_init(model, torch.Generator(device=cuda).manual_seed(1))
    sde = VPSDE()
    pcfg = PlannerConfig(horizon=16, obs_dim=4, act_dim=2, guidance_scale=1.5)
    g = torch.Generator(device=cuda).manual_seed(2)
    obs = 0.3 * torch.randn(8, 4, generator=g, device=cuda)
    bins = torch.arange(8, device=cuda) % 4
    counts = (step_ops.launches, flash_ops.launches, gn_ops.launches)
    res = plan(sde, ttu.make_score_fn(model, sde), obs, pcfg=pcfg, returns=bins,
               config=AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, max_iters=400))
    torch.cuda.synchronize()
    step, flash, gn = (a - b for a, b in zip(
        (step_ops.launches, flash_ops.launches, gn_ops.launches), counts))
    iters = int(res.iterations)
    assert step >= iters and flash >= 2 * iters + 1
    assert gn == 13 * flash  # 2 per residual block × 6 blocks + the output norm
    assert torch.isfinite(res.x).all() and torch.equal(res.x[:, 0, :4], obs)
    assert bool((res.nfe == 2 * (res.accepted + res.rejected) + 1).all())


EM_SHAPES = [(8, 196_608), (256, 3072), (64, 736), (8, 1000), (3, 999), (4096, 2),
             (2048, 2), (5, 3), (70_000, 2)]


def _ulp(dtype, mag):
    return 2.0 ** (np.floor(np.log2(max(mag, 1e-30))) - (23 if dtype == torch.float32 else 7))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", EM_SHAPES, ids=str)
def test_em_step_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, s, z = (torch.randn(*shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    cs = [torch.rand(shape[0], generator=g, device=cuda) * 2 - 0.5 for _ in range(3)]
    before = step_ops.em_launches
    out = step_ops.em_step(x, s, z, *cs)
    assert step_ops.em_launches == before + 1
    want = step_ref.em_step(x, s, z, *cs)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= 2 * _ulp(dtype, want.float().abs().max().item())
    assert torch.equal(step_ops.em_step(x, s, z, *cs), out)  # deterministic


def test_em_step_kernel_takes_image_states_and_refuses_misaligned_views(cuda):
    """Image states flatten to (B, D); a contiguous view off 16 bytes takes
    single-element loads and gives the aligned call's bits (the kernel
    refused it before its flat redesign); a non-contiguous one is still
    refused, launching nothing."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x, s, z = (torch.randn(4, 16, 16, 3, generator=g, device=cuda) for _ in range(3))
    cs = [torch.rand(4, generator=g, device=cuda) for _ in range(3)]
    out = step_ops.em_step(x, s, z, *cs)
    assert out.shape == x.shape
    assert torch.equal(out, step_ref.em_step(x.reshape(4, -1), s.reshape(4, -1),
                                             z.reshape(4, -1), *cs).reshape(x.shape))
    buf = torch.randn(4 * 1000 + 1, generator=g, device=cuda)
    view = buf[1:].view(4, 1000)
    aligned = view.clone()
    assert view.data_ptr() % 16 and not aligned.data_ptr() % 16
    before = step_ops.em_launches
    got = step_ops.em_step(view, view, view, *cs)
    assert step_ops.em_launches == before + 1
    assert torch.equal(got, step_ops.em_step(aligned, aligned, aligned, *cs))
    before = step_ops.em_launches
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.randn(4, 2000, device=cuda)[:, :1000]
        step_ops.em_step(wide, wide, wide, *cs)
    assert step_ops.em_launches == before


@pytest.mark.parametrize("shape", [(4096, 2), (8, 196_608)], ids=str)
def test_em_step_is_one_cuda_kernel_a_call(cuda, shape):
    """A K5 call runs exactly one CUDA kernel, at Table 1's state and at
    the DiT's: 8 calls, 8 kernels."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x, s, z = (torch.randn(*shape, generator=g, device=cuda) for _ in range(3))
    cs = [torch.rand(shape[0], generator=g, device=cuda) for _ in range(3)]
    step_ops.em_step(x, s, z, *cs)
    names = _kernel_names(lambda: step_ops.em_step(x, s, z, *cs))
    assert len(names) == 8 and all("em_step_kernel" in n for n in names), names


@pytest.mark.parametrize("shape", [(4096, 2), (8, 196_608)], ids=str)
def test_em_step_in_a_cuda_graph_matches_eager(cuda, shape):
    """Captured in a CUDA graph and replayed three times, K5 gives the
    eager call's bits on every replay."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x, s, z = (torch.randn(*shape, generator=g, device=cuda) for _ in range(3))
    cs = [torch.rand(shape[0], generator=g, device=cuda) for _ in range(3)]
    want = step_ops.em_step(x, s, z, *cs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step_ops.em_step(x, s, z, *cs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launched, captured = step_ops.em_launches, step_ops.captured_em
    with torch.cuda.graph(graph):
        outs = [step_ops.em_step(x, s, z, *cs) for _ in range(3)]
    # a call under capture launches nothing: it counts as captured
    assert (step_ops.em_launches, step_ops.captured_em) == (launched, captured + 3)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)


class _SeededNoise:
    """The same sequence of normal draws on every device."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, x):
        return torch.from_numpy(self.rng.standard_normal(tuple(x.shape)).astype(np.float32))


@pytest.mark.parametrize("method,kw,per_step", [
    ("em", dict(n_steps=50), 1), ("pc", dict(n_steps=25), 2),
    ("pc_hmc", dict(n_steps=25), 1)])
@pytest.mark.parametrize("sde", [VPSDE(), VESDE(sigma_max=10.0)], ids=["vp", "ve"])
def test_baselines_on_card_match_cpu(cuda, sde, method, kw, per_step):
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 24)).astype(np.float32))
    x0 = x0 * sde.prior_std()
    score = tan.gaussian_score(sde)
    before = step_ops.em_launches
    got = get_solver(method)(sde, score, x0, noise_fn=_SeededNoise(4), device=cuda, **kw)
    torch.cuda.synchronize()
    assert step_ops.em_launches - before == per_step * kw["n_steps"]
    want = get_solver(method)(sde, score, x0, noise_fn=_SeededNoise(4), device="cpu", **kw)
    assert torch.equal(got.nfe.cpu(), want.nfe)
    scale = max(1.0, want.x.abs().max().item())
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-5, atol=1e-5 * scale)


#: (B, S, H, P, G, N): mamba2-2.7b's prefill, a ragged S, several groups,
#: prefill_32k's sequence length, and 8 heads over 5000 rows, which the
#: wrapper splits into ranges (79 chunks, the last ragged)
SSD_SHAPES = [(4, 2048, 80, 64, 1, 128), (4, 1000, 80, 64, 1, 128),
              (1, 100, 8, 32, 2, 32), (1, 32768, 80, 64, 1, 128),
              (1, 5000, 8, 64, 1, 128)]
SSD_RANGE_SHAPE = SSD_SHAPES[4]


def _ssd_inputs(B, S, H, P, G, N, dev, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=dev))
    A = -torch.exp(torch.randn(H, generator=g, device=dev))
    Bm, C = (torch.randn(B, S, G, N, generator=g, device=dev).to(dtype) for _ in range(2))
    return x, dt, A, Bm, C


def _within(got, want, tol):
    return bool(((got - want).abs() <= tol * (1 + want.abs())).all())


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_scan_kernel_matches_plain(cuda, shape):
    args = _ssd_inputs(*shape, cuda)
    before = ssd_ops.launches
    y = ssd_ops.ssd_scan(*args)
    assert ssd_ops.launches == before + 1
    want = ssd_ref.ssd_chunked(*args)
    torch.cuda.synchronize()
    assert y.shape == want.shape and y.dtype == torch.float32
    assert _within(y, want, 6e-4)
    assert torch.equal(ssd_ops.ssd_scan(*args), y)  # deterministic


def test_ssd_scan_kernel_matches_sequential_oracle(cuda):
    """y and the final state against the exact recurrence."""
    x, dt, A, Bm, C = _ssd_inputs(2, 150, 8, 32, 2, 32, cuda, seed=1)
    y, state = ssd_ops.ssd_scan(x, dt, A, Bm, C, return_state=True)
    ys, ss = ssd_ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), A,
                              Bm.transpose(1, 2), C.transpose(1, 2))
    torch.cuda.synchronize()
    assert _within(y, ys.transpose(1, 2), 3e-4) and _within(state, ss, 3e-4)


@pytest.mark.parametrize("shape", [(2, 300, 8, 64, 1, 128), SSD_RANGE_SHAPE], ids=str)
def test_ssd_scan_kernel_bf16(cuda, shape):
    args = _ssd_inputs(*shape, cuda, dtype=torch.bfloat16, seed=2)
    y = ssd_ops.ssd_scan(*args)
    want = ssd_ref.ssd_chunked(*args)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    bound = torch.maximum(_bf16_ulp(y), _bf16_ulp(want)) + 6e-4 * (1 + want.float().abs())
    assert ((y.float() - want.float()).abs() <= bound).all()


def test_ssd_scan_kernel_ranges_match_sequential_oracle(cuda):
    """A shape the wrapper splits into ranges (a ragged last range): y and
    the final state against the exact recurrence, the same bits twice."""
    x, dt, A, Bm, C = _ssd_inputs(*SSD_RANGE_SHAPE, cuda, seed=5)
    assert ssd_ops.ranges_for(x) > 1
    y, state = ssd_ops.ssd_scan(x, dt, A, Bm, C, return_state=True)
    y2, state2 = ssd_ops.ssd_scan(x, dt, A, Bm, C, return_state=True)
    ys, ss = ssd_ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), A,
                              Bm.transpose(1, 2), C.transpose(1, 2))
    torch.cuda.synchronize()
    assert _within(y, ys.transpose(1, 2), 3e-4) and _within(state, ss, 3e-4)
    assert torch.equal(y, y2) and torch.equal(state, state2)


@pytest.mark.parametrize("ranges", [1, 2, 5, None], ids=["R1", "R2", "R5", "chosen"])
def test_ssd_scan_kernel_range_counts_agree(cuda, ranges):
    """Every range count gives y and the final state within the kernel's
    bound of the plain version, and the same bits on a second call."""
    args = _ssd_inputs(*SSD_RANGE_SHAPE, cuda, seed=6)
    y, state = ssd_ops._launch(*args, return_state=True, ranges=ranges)
    y2, state2 = ssd_ops._launch(*args, return_state=True, ranges=ranges)
    want, want_state = ssd_ref.ssd_chunked(*args, return_state=True)
    torch.cuda.synchronize()
    assert _within(y, want, 6e-4) and _within(state, want_state, 6e-4)
    assert torch.equal(y, y2) and torch.equal(state, state2)


def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, C = _ssd_inputs(1, 64, 4, 32, 1, 32, cuda, seed=3)
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, C)
    x8, dt8, A8, B8, C8 = _ssd_inputs(1, 64, 2, 8, 1, 32, cuda, seed=3)
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_ops.ssd_scan(x8, dt8, A8, B8, C8)
    assert ssd_ops.launches == before


def test_ssd_scan_kernel_refuses_misaligned_views(cuda):
    """A contiguous view 4 bytes into a buffer would fault on the kernel's
    16-byte loads (a sticky error that ends the context): it raises
    before the launch instead."""
    x, dt, A, Bm, C = _ssd_inputs(1, 64, 4, 32, 1, 32, cuda, seed=3)
    flat = torch.empty(x.numel() + 4, device=cuda)
    view = flat[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="16-byte-aligned x"):
        ssd_ops.ssd_scan(view, dt, A, Bm, C)
    assert ssd_ops.launches == before
    assert torch.equal(ssd_ops.ssd_scan(x, dt, A, Bm, C), ssd_ops.ssd_scan(x, dt, A, Bm, C))


def test_prefill_on_card_launches_k7_once_per_layer(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import forward, init_model

    cfg = get_config("mamba2-2.7b").scaled_down().replace(num_layers=3)
    params = init_model(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 200),
                         generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    before = ssd_ops.launches
    nxt = make_prefill_step(cfg, use_kernel_ssd=True, device=cuda)(params, {"tokens": toks})
    assert ssd_ops.launches - before == cfg.num_layers
    before = ssd_ops.launches  # the default prefill takes the same route
    assert torch.equal(make_prefill_step(cfg, device=cuda)(params, {"tokens": toks}), nxt)
    assert ssd_ops.launches - before == cfg.num_layers
    with torch.no_grad():
        fast, _ = forward(params, toks, cfg, use_kernel_ssd=True, last_logits_only=True)
        plain, _ = forward(params, toks, cfg, use_kernel_ssd=False, last_logits_only=True)
    torch.testing.assert_close(fast, plain, rtol=2e-4, atol=2e-4)
    assert torch.equal(nxt, torch.argmax(plain[:, -1:], dim=-1).to(torch.int32))


def test_attention_lm_prefill_on_card_launches_k3_once_per_layer(cuda):
    """gemma3-12b scaled down (five "L" layers of window 16, one "A"): the
    default prefill runs K3 once an attention layer, within the LM bound of
    the plain attention; the continuous batcher on the card gives each
    request its solo serve_batch tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import forward, init_model
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    cfg = get_config("gemma3-12b").scaled_down()
    params = init_model(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    before = flash_ops.launches
    nxt = make_prefill_step(cfg, device=cuda)(params, {"tokens": toks})
    assert flash_ops.launches - before == cfg.num_layers
    with torch.no_grad():
        fast, _ = forward(params, toks, cfg, last_logits_only=True)
        plain, _ = forward(params, toks, cfg, use_flash=False, last_logits_only=True)
    torch.testing.assert_close(fast, plain, rtol=2e-4, atol=2e-4)
    assert torch.equal(nxt, torch.argmax(plain[:, -1:], dim=-1).to(torch.int32))
    b = ContinuousBatcher(cfg, params, slots=2, cache_len=64, device=cuda)
    prompts = [toks[0, :n].cpu().numpy() for n in (5, 9, 3)]
    for uid, p in enumerate(prompts):
        b.submit(Request(uid=uid, prompt=p, max_new_tokens=12))
    done = b.run_to_completion()
    for uid, p in enumerate(prompts):
        solo = serve_batch(cfg, params, torch.from_numpy(p)[None], gen_len=12, device=cuda)
        assert done[uid].output == solo[0].tolist(), uid


def test_wrappers_refuse_autograd_on_card(cuda):
    """Under grad mode every CUDA wrapper refuses an input that requires
    grad and counts nothing; under no_grad the same call launches."""
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    cs = [torch.rand(8, generator=g, device=cuda) for _ in range(3)]
    q = r(1, 2, 64, 64).requires_grad_(True)
    x = r(8, 64).requires_grad_(True)
    before = (flash_ops.launches, step_ops.launches, step_ops.em_launches)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_ops.attention(q, q.detach(), q.detach(), causal=False)
    with pytest.raises(ValueError, match="solver_step"):
        step_ops.error_step(x, *(r(8, 64) for _ in range(4)), *cs, eps_abs=0.01, eps_rel=0.05)
    with pytest.raises(ValueError, match="em_step"):
        step_ops.em_step(x, r(8, 64), r(8, 64), *cs)
    with pytest.raises(ValueError, match="groupnorm_silu"):
        gn_ops.groupnorm_silu(r(4, 32, 64).requires_grad_(True), torch.ones(64, device=cuda),
                              torch.zeros(64, device=cuda), groups=8)
    assert (flash_ops.launches, step_ops.launches, step_ops.em_launches) == before
    with torch.no_grad():
        flash_ops.attention(q, q, q, causal=False)
    assert flash_ops.launches == before[0] + 1


def test_dit_training_step_on_card(cuda):
    """A DiT trains on the card with plain attention (every leaf gets a
    gradient); with flash attention under grad mode it raises instead of
    dropping the attention's gradient."""
    from repro_torch.core.losses import dsm_loss

    cfg = tdit.DiTConfig(image_size=16, patch=4, d_model=64, num_layers=2, num_heads=4,
                         d_ff=128)
    model = tdit.init_dit(cfg, torch.Generator(device=cuda).manual_seed(0))
    tdit.liven_zero_init(model, torch.Generator(device=cuda).manual_seed(1))
    sde = VPSDE()
    g = torch.Generator(device=cuda).manual_seed(2)
    x0 = torch.rand(4, 16, 16, 3, generator=g, device=cuda) * 2 - 1
    apply = lambda m, x, t: m(x, t) / sde.marginal(t)[1].reshape(-1, 1, 1, 1)
    dsm_loss(sde, apply, model, x0, g).backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in model.parameters())
    model.cfg = dataclasses.replace(cfg, use_flash=True)
    with pytest.raises(ValueError, match="flash_attention"):
        dsm_loss(sde, apply, model, x0, g)


def test_sample_chunked_on_card_is_the_chunks_bitwise(cuda):
    """The pinned, side-stream copies give each chunk's bits, and launch
    no kernel of their own (K5 once a step, K1 once an iteration). The
    chunks share one key of the graph cache: the first solve runs
    host-driven, the second captures and the rest replay, and a capture's
    warm-up runs one iteration eagerly (K1 once; K5 once for EM's one
    step), so the captures' rise is taken off each side. The first
    chunk's host-driven adaptive solve runs whole groups of SYNC_EVERY
    (K1 8·⌈iterations/8⌉) where its replay, in the direct calls, runs the
    iterations alone: that tail is added to the direct side."""
    from repro_torch.core.sampling import chunk_seeds, sample, sample_chunked
    from repro_torch.core.solvers import adaptive as ad

    sde = VPSDE()
    score = tan.gaussian_score(sde)
    for method, kw, counter in (("em", dict(n_steps=30), "em_launches"),
                                ("adaptive", dict(eps_rel=0.1, use_fused_kernel=True),
                                 "launches")):
        setattr(step_ops, counter, 0)
        c0 = ad.captures
        x, mean_nfe = sample_chunked(sde, score, 10, (8,), seed=1, chunk=4, method=method,
                                     device=cuda, **kw)
        chunked = getattr(step_ops, counter) - (ad.captures - c0)
        setattr(step_ops, counter, 0)
        c0 = ad.captures
        outs, nfes, its = [], [], []
        for s in chunk_seeds(1, 3):
            res = sample(sde, score, (4, 8), seed=s, method=method, device=cuda, **kw)
            outs.append(res.x.cpu().numpy())
            nfes.append(res.nfe.cpu().numpy())
            its.append(int(res.iterations))
        tail = ad.SYNC_EVERY * -(-its[0] // ad.SYNC_EVERY) - its[0] if method == "adaptive" else 0
        direct = getattr(step_ops, counter) - (ad.captures - c0)
        assert chunked == direct + tail and direct > 0
        assert type(x) is np.ndarray
        np.testing.assert_array_equal(x, np.concatenate(outs)[:10])
        assert mean_nfe == pytest.approx(float(np.concatenate(nfes)[:10].mean()))


def test_adaptive_forward_on_card(cuda):
    """Algorithm 2 on the card: the OU process's stationary moments."""
    from repro_torch.core import ForwardAdaptiveConfig, adaptive_forward

    res = adaptive_forward(lambda x, t: -x, lambda x, t: torch.full_like(x, 0.8),
                           torch.zeros(1024, 2, device=cuda), 0.0, 4.0,
                           torch.Generator(device=cuda).manual_seed(0),
                           config=ForwardAdaptiveConfig(eps_abs=2e-2, eps_rel=0.1,
                                                        h_init=0.1), device=cuda)
    assert float(res.x.mean()) == pytest.approx(0.0, abs=0.04)
    assert float(res.x.std()) == pytest.approx(0.8 / 2 ** 0.5, rel=0.06)


@pytest.mark.parametrize("D", [196_608, 4_999], ids=["main_path", "ragged"])
def test_k2_with_the_tiers_eps_per_row(cuda, D):
    """K2 as a tiered serve calls it: the three tiers' ε_rel in one call at
    the VP SDE's ε_abs, within K1's bounds of the plain version, the same
    bits twice, and each row bitwise the row of a call at a uniform ε."""
    from repro_torch.configs.diffusion import TOLERANCE_CLASSES

    tiers = [c.eps_rel for c in TOLERANCE_CLASSES.values()]
    rel = torch.tensor([tiers[i % 3] for i in range(8)], device=cuda)
    atol = torch.full((8,), VPSDE().abs_tolerance, device=cuda)
    states, coeffs, _ = _step_inputs(8, D, torch.float32, cuda, seed=5)
    xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=atol, eps_rel=rel)
    xr, e2r = step_ref.error_step(*states, *coeffs, atol, rel)
    torch.testing.assert_close(xh, xr, **X_TOL[torch.float32])
    torch.testing.assert_close(e2, e2r, rtol=1e-5, atol=1e-6)
    again = step_ops.error_step(*states, *coeffs, eps_abs=atol, eps_rel=rel)
    assert torch.equal(again[0], xh) and torch.equal(again[1], e2)
    for eps in tiers:
        ux, ue = step_ops.error_step(*states, *coeffs, eps_abs=atol, eps_rel=eps)
        rows = rel == eps
        assert torch.equal(ux[rows], xh[rows]) and torch.equal(ue[rows], e2[rows])


def test_tiered_serve_on_card_is_bitwise_its_solo_runs(cuda):
    """A 4-request mixed-tier serve through K2 and K3 on a small livened
    DiT: each request bitwise (sample and NFE) its run alone in an idle
    server of the same slot count, and exactly one solver-step launch and
    2·layers flash launches a body iteration."""
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

    cfg = tdit.DiTConfig(image_size=16, patch=4, d_model=128, num_layers=2, num_heads=2,
                         d_ff=256, use_flash=True)
    model = tdit.init_dit(cfg, torch.Generator(device=cuda).manual_seed(0))
    tdit.liven_zero_init(model, torch.Generator(device=cuda).manual_seed(1))
    sde = VPSDE()
    acfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True)
    step = make_sample_step(sde, acfg)
    tiers = ("draft", "high_fidelity", "standard", "draft")

    def serve(uids):
        b = DiffusionBatcher(sde, step, model, (16, 16, 3), slots=4, cfg=acfg, sync_horizon=4,
                             tolerance_classes=True, device=cuda)
        for u in uids:
            b.submit(ImageRequest(uid=u, seed=10 + u, tier=tiers[u]))
        return b, b.run_to_completion()

    step_ops.launches = flash_ops.launches = 0
    b, mixed = serve(range(4))
    body = 4 * b.horizon_windows
    assert step_ops.launches == body and flash_ops.launches == 2 * cfg.num_layers * body
    for u in range(4):
        _, solo = serve([u])
        assert solo[u].nfe == mixed[u].nfe, u
        np.testing.assert_array_equal(solo[u].result, mixed[u].result, err_msg=f"uid {u}")
        assert np.isfinite(mixed[u].result).all()


# --------------------------------------------------------------------------
# the device-resident serve loop: P1, P2, the graphed horizon, K1/K3 ranges
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 196_608), (64, 736), (4096, 2), (5, 7)], ids=str)
def test_philox_kernel_matches_plain(cuda, shape):
    """P1 against ``ref.py`` on the card: the uint32 words exactly, z within
    2e-6·(1 + |z|) (library log/sqrt/sin/cos on both sides), an idle row
    0, and permuted rows the output permuted bit for bit."""
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.philox import ref as ph_ref

    B, D = shape
    g = torch.Generator(device=cuda).manual_seed(B)
    seed = torch.randint(0, 2**62, (B,), generator=g, device=cuda)
    seed[0] = -1
    ctr = torch.randint(0, 2**40, (B,), generator=g, device=cuda)
    assert torch.equal(ph.words(seed, ctr, D), ph_ref.philox_words(seed, ctr, D))
    z, want = ph.normal(seed, ctr, D), ph_ref.philox_normal(seed, ctr, D)
    assert ((z - want).abs() / (1 + want.abs())).max().item() <= 2e-6
    assert not z[0].any()
    perm = torch.randperm(B, generator=g, device=cuda)
    assert torch.equal(ph.normal(seed[perm], ctr[perm], D), z[perm])


def test_horizon_cond_flags_on_hand_built_masks(cuda):
    """P2 against its plain version on hand-built masks: a horizon ending
    by its length (horizon 2), the budget spent mid-horizon (iterations
    at max_iters), every row done, an idle slot, both event forms; the
    state after each of five evaluations equal."""
    from repro_torch.kernels.graph_loop import ops as loop_ops
    from repro_torch.kernels.graph_loop import ref as loop_ref

    state = torch.zeros(4, dtype=torch.int32, device=cuda)
    for occ, done in (([1, 1, 0, 1], [0, 0, 1, 0]), ([1, 1, 0, 1], [1, 0, 1, 0]),
                      ([1, 1, 0, 1], [1, 1, 1, 1]), ([0, 0, 0, 0], [1, 1, 1, 1]),
                      ([1, 0, 0, 0], [1, 0, 1, 1])):
        o = torch.tensor(occ, dtype=torch.bool, device=cuda)
        d = torch.tensor(done, dtype=torch.bool, device=cuda)
        for wait_all in (False, True):
            for its in (0, 5):
                it = torch.full((), its, dtype=torch.int32, device=cuda)
                plain = torch.zeros(4, dtype=torch.int32)
                kw = dict(wait_all=wait_all, horizon=2, max_iters=5, max_horizons=3)
                for first in (True, False, False, False, False):
                    loop_ops.horizon_cond(o, d, it, state, first=first, **kw)
                    loop_ref.horizon_cond(o.cpu(), d.cpu(), it.cpu(), plain, first=first, **kw)
                    assert state.tolist() == plain.tolist(), (occ, done, wait_all, its, first)


def _analytic_step(cuda, **kw):
    from repro_torch.launch.sample import make_sample_step

    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, **kw)
    f = tan.gaussian_noise_pred(sde, 0.3, 0.5)
    return sde, cfg, make_sample_step(sde, cfg, forward_fn=lambda p, x, t: f(x, t))


def test_graphed_horizon_is_bitwise_the_eager_horizon(cuda):
    """Two replays of one captured horizon on a carry of SlotStreams equal
    two eager ``solve_chunk`` horizons leaf for leaf, counters included."""
    import copy

    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.core.solvers.base import SlotStreams

    sde, cfg, step = _analytic_step(cuda)
    seeds = list(range(8))
    x0 = sde.prior_sample((8, 32), SlotStreams.of(seeds, 0, cuda))
    graphed = ad.own_buffers(ad.init_carry(sde, x0, SlotStreams.of(seeds, 1, cuda), config=cfg))
    eager = copy.deepcopy(graphed)
    g = step.capture_horizon(None, graphed, 4)
    for _ in range(2):
        g.replay()
        eager = step(None, eager, max_sync_iters=4)
    for a, b in zip(ad._tensor_leaves(graphed), ad._tensor_leaves(eager)):
        assert torch.equal(a, b)


def test_graphed_horizon_counts_the_kernels_its_replays_launch(cuda):
    """The device-resident driver's unit, one body iteration, under
    capture launches nothing and records K1 and P1 once; a drain's counts
    are those calls times the units (iterations) the device ran, plus the
    capture's eager warm-up iteration and P1 once an admission."""
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

    sde, cfg, step = _analytic_step(cuda)
    b = DiffusionBatcher(sde, step, None, (32,), slots=4, cfg=cfg, sync_horizon=2,
                         device_resident=True, device=cuda)
    for u in range(12):
        b.submit(ImageRequest(uid=u, seed=u))
    step_ops.launches = ph.launches = 0
    graph = b._device_driver().graph
    assert graph.recorded == {(step_ops, "launches"): 1, (step_ops, "sharded_launches"): 0,
                              (step_ops, "em_launches"): 0, (flash_ops, "launches"): 0,
                              (gn_ops, "launches"): 0, (ph, "launches"): 1}
    assert (step_ops.launches, ph.launches) == (1, 1)
    b.run_to_completion()
    assert b.device_units <= 2 * b.device_horizons
    assert step_ops.launches == 1 + b.device_units
    admissions = ph.launches - 1 - b.device_units
    assert 1 <= admissions <= b.event_visits + b.admission_visits


@pytest.mark.parametrize("compaction", [True, False], ids=["compaction", "monolithic"])
def test_device_resident_serve_on_card_matches_host_driven(cuda, compaction):
    """The WHILE-node driver against the host-driven loop on the card: the
    same samples, nfe and delivery order, fewer host reads, one capture,
    and the carry's buffers where they were."""
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

    sde, cfg, step = _analytic_step(cuda)
    runs = {}
    for dr in (False, True):
        b = DiffusionBatcher(sde, step, None, (32,), slots=4, cfg=cfg, sync_horizon=2,
                             compaction=compaction, device_resident=dr, device=cuda)
        for u in range(12):
            b.submit(ImageRequest(uid=u, seed=u))
        ptrs = [t.data_ptr() for t in ad._tensor_leaves(b._carry)]
        done = b.run_to_completion()
        runs[dr] = (b, done, ptrs)
    (bh, dh, _), (bd, dd, ptrs) = runs[False], runs[True]
    assert list(dh) == list(dd)
    for u in dh:
        assert dh[u].nfe == dd[u].nfe
        np.testing.assert_array_equal(dh[u].result, dd[u].result)
    assert bh.total_iterations == bd.total_iterations
    assert bd.graph_captures == 1 and bd.solver_syncs == 0
    assert bd.host_transfers + bd.solver_syncs < bh.host_transfers + bh.solver_syncs
    assert [t.data_ptr() for t in ad._tensor_leaves(bd._carry)] == ptrs


def test_device_resident_on_card_refuses_python_streams(cuda):
    from repro_torch.serving.diffusion_server import DiffusionBatcher

    sde, cfg, step = _analytic_step(cuda)
    with pytest.raises(ValueError, match="CUDA graph"):
        DiffusionBatcher(sde, step, None, (32,), slots=2, cfg=cfg, device_resident=True,
                         device=cuda, request_streams=lambda req, shape, dev: None)


@pytest.mark.parametrize("B", [70_000, 200_000])
def test_solver_step_past_65535_rows_matches_plain(cuda, B):
    """Rows past one launch's gridDim.y: the ranges' launches against the
    plain version, and the first range bitwise a call on its rows alone."""
    states, coeffs, (ea, er) = _step_inputs(B, 2, torch.float32, cuda, seed=6)
    step_ops.launches = 0
    xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
    assert step_ops.launches == -(-B // step_ops.MAX_GRID_ROWS)
    xr, er2 = step_ref.error_step(*states, *coeffs, ea, er)
    torch.testing.assert_close(xh, xr, **X_TOL[torch.float32])
    torch.testing.assert_close(e2, er2, rtol=1e-5, atol=0)
    n = step_ops.MAX_GRID_ROWS
    xa, ea2 = step_ops.error_step(*(a[:n] for a in states + coeffs), eps_abs=ea[:n],
                                  eps_rel=er[:n])
    assert torch.equal(xa, xh[:n]) and torch.equal(ea2, e2[:n])


def test_flash_attention_past_65535_heads_matches_plain(cuda):
    q, k, v = _qkv_on(cuda, 17_500, 4, 4, 8, 32, torch.float32)
    flash_ops.launches = 0
    out = flash_ops.attention(q, k, v, causal=False)
    assert flash_ops.launches == 2
    want = flash_ref.attention(q, k, v, causal=False)
    torch.testing.assert_close(out, want, **A_TOL[torch.float32])
    nb = flash_ops.batch_ranges(17_500, 4)[0][1]
    assert torch.equal(flash_ops.attention(q[:nb], k[:nb], v[:nb], causal=False), out[:nb])


def test_groupnorm_silu_under_capture_counts_as_captured(cuda):
    """K6 called while a stream is captured launches nothing: it counts in
    ``captured``, and each replay runs it (a device-resident TRAJ_UNET
    horizon holds 17 calls a forward)."""
    x = torch.randn(4, 32, 64, device=cuda)
    scale, bias = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    want = gn_ops.groupnorm_silu(x, scale, bias, groups=8)
    launches, captured = gn_ops.launches, gn_ops.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gn_ops.groupnorm_silu(x, scale, bias, groups=8)
    assert (gn_ops.launches, gn_ops.captured) == (launches, captured + 1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("family", ["momentum", "heun"])
def test_zoo_family_graphed_horizon_bitwise_eager(cuda, family):
    """A captured horizon of the momentum or Heun body replays bitwise the
    eager chunks, through K1 and the per-slot streams; Heun's holds no P1
    (no z, no projection)."""
    import copy

    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.core.solvers.base import SlotStreams
    from repro_torch.kernels.philox import ops as ph

    field = {"momentum": dict(momentum=0.15), "heun": dict(probability_flow=True)}[family]
    sde, cfg, step = _analytic_step(cuda, **field)
    seeds = list(range(8))
    x0 = sde.prior_sample((8, 32), SlotStreams.of(seeds, 0, cuda))
    graphed = ad.own_buffers(ad.init_carry(sde, x0, SlotStreams.of(seeds, 1, cuda), config=cfg))
    eager = copy.deepcopy(graphed)
    g = step.capture_horizon(None, graphed, 4)
    assert g.recorded[(ph, "launches")] == (4 if family == "momentum" else 0)
    assert g.recorded[(step_ops, "launches")] == 4
    for _ in range(3):
        g.replay()
        eager = step(None, eager, max_sync_iters=4)
    for a, b in zip(ad._tensor_leaves(graphed), ad._tensor_leaves(eager)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method,kw,k5", [
    ("em", dict(n_steps=30), 30), ("pc", dict(n_steps=25), 50),
    ("pc_hmc", dict(n_steps=25), 25), ("ddim", dict(n_steps=30), 0),
    ("ode", dict(rtol=1e-3, atol=1e-3), 0)])
def test_graphed_baselines_on_card_are_the_host_chain(cuda, method, kw, k5):
    """Three solves at one key on per-row streams: the first runs the
    host-driven loop and captures nothing, the second captures, the third
    replays; both graphed solves are the first bit for bit, read the host
    once, and the replay launches the host chain's K5 count (the second
    adds one step's warm-up)."""
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.core.solvers.base import SlotStreams

    sde = VPSDE()
    score = tan.gaussian_score(sde)
    st = SlotStreams.of(list(range(64)), 1, cuda)
    x0 = sde.prior_sample((64, 24), SlotStreams.of(list(range(64)), 0, cuda))
    runs = []
    for _ in range(3):
        step_ops.em_launches = 0
        c0, r0 = ad.captures, ad.host_syncs
        res = get_solver(method)(sde, score, x0, st, device=cuda, **kw)
        torch.cuda.synchronize()
        runs.append((res, ad.captures - c0, ad.host_syncs - r0, step_ops.em_launches))
    (host, *_), graphed, replay = runs
    assert [r[1] for r in runs] == [0, 1, 0]
    assert graphed[2] == replay[2] == 1
    assert runs[0][3] == replay[3] == k5
    for res, *_ in (graphed, replay):
        for f in ("x", "nfe", "iterations"):
            assert torch.equal(getattr(res, f), getattr(host, f)), f


def test_adaptive_forward_graphed_on_card_is_the_host_chain(cuda):
    """Algorithm 2 on per-row streams with a state-dependent g: the
    second solve captures, and both graphed solves are the host-driven
    first bit for bit, one host read each."""
    from repro_torch.core import ForwardAdaptiveConfig, adaptive_forward
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.core.solvers.base import SlotStreams

    st = SlotStreams.of(list(range(4096)), 0, cuda)
    f, g = (lambda x, t: 0.05 * x), (lambda x, t: 0.2 * x)
    cfg = ForwardAdaptiveConfig(eps_abs=1e-3, eps_rel=0.02, h_init=0.1)
    runs = []
    for _ in range(3):
        c0, r0 = ad.captures, ad.host_syncs
        res = adaptive_forward(f, g, torch.ones(4096, 2, device=cuda), 0.0, 1.0, st,
                               config=cfg, device=cuda)
        torch.cuda.synchronize()
        runs.append((res, ad.captures - c0, ad.host_syncs - r0))
    assert [r[1] for r in runs] == [0, 1, 0]
    assert runs[1][2] == runs[2][2] == 1
    for res, *_ in runs[1:]:
        for fld in ("x", "nfe", "accepted", "rejected", "iterations"):
            assert torch.equal(getattr(res, fld), getattr(runs[0][0], fld)), fld
    assert float(runs[0][0].x.mean()) == pytest.approx(float(np.exp(0.05)), rel=0.02)


@pytest.mark.parametrize("method,kw", [("em", dict(n_steps=25)), ("ode", dict(rtol=1e-3)),
                                       ("adaptive", dict(eps_rel=0.1))])
def test_captured_driver_holds_no_score_function(cuda, method, kw):
    """A cached driver's graph holds neither its score function nor the
    closures around it: once the score is collected its driver goes."""
    import gc

    from repro_torch.core.sampling import sample
    from repro_torch.core.solvers import adaptive as ad

    sde = VPSDE()
    inner = tan.gaussian_score(sde)
    score = lambda x, t: inner(x, t)
    n = len(ad._drivers)
    for _ in range(2):
        sample(sde, score, (16, 8), seed=0, method=method, device=cuda, **kw)
    assert len(ad._drivers) == n + 1
    del score
    gc.collect()
    assert len(ad._drivers) == n


@pytest.mark.parametrize("method,kw", [
    ("adaptive", dict(eps_rel=0.05, use_fused_kernel=True)), ("em", dict(n_steps=30))])
def test_graphed_sample_under_an_nccl_mesh_is_the_host_chain(cuda, one_rank_mesh, method, kw):
    """``sample(mesh=)`` on a one-rank NCCL mesh, three calls at one key:
    the first runs the host-driven sharded loop and captures nothing, the
    second captures (the mesh's flags' all-reduce inside the horizon for
    Algorithm 1), the third replays; both graphed calls are the first bit
    for bit and read the host at most twice (the branch's agreement and
    the window), and the replay launches the host-driven call's K4 and
    K5, with P2 once a horizon plus one."""
    from repro_torch.core.sampling import sample
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.kernels.graph_loop import ops as loop_ops

    sde = VPSDE()
    score = tan.gaussian_score(sde)
    runs = []
    for _ in range(3):
        step_ops.em_launches = step_ops.sharded_launches = loop_ops.launches = 0
        c0, r0 = ad.captures, ad.host_syncs
        res = sample(sde, score, (64, 24), seed=4, method=method, device=cuda,
                     mesh=one_rank_mesh, **kw)
        torch.cuda.synchronize()
        runs.append((res, ad.captures - c0, ad.host_syncs - r0,
                     (step_ops.sharded_launches, step_ops.em_launches), loop_ops.launches))
    (host, *_), graphed, replay = runs
    assert [r[1] for r in runs] == [0, 1, 0]
    assert graphed[2] <= 2 and replay[2] <= 2
    assert replay[3] == runs[0][3] and sum(runs[0][3]) > 0
    horizons = (-(-int(host.iterations) // ad.SYNC_EVERY) if method == "adaptive"
                else kw["n_steps"])
    assert replay[4] == horizons + 1
    for res, *_ in (graphed, replay):
        for f in ("x", "nfe", "accepted", "rejected", "iterations"):
            assert torch.equal(getattr(res, f), getattr(host, f)), f


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "gemma3-12b"])
def test_graphed_decode_under_an_nccl_mesh_is_the_eager_step(cuda, one_rank_mesh, arch):
    """The serve step under a one-rank NCCL mesh is graphed: its tokens and
    final state are the eager step's bit for bit, one capture, and a
    replay charges the books one eager step makes (the tokens' gather)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import state_tensors
    from repro_torch.launch.steps import GraphedServeStep, make_serve_step
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.parallel import collectives as coll

    cfg = get_config(arch).scaled_down()
    params = init_model(cfg, 0, device=cuda, mesh=one_rank_mesh)
    step = make_serve_step(cfg, mesh=one_rank_mesh)
    assert isinstance(step, GraphedServeStep)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=torch.Generator().manual_seed(0))
    out, books = {}, {}
    for name, fn in (("graphed", step), ("eager", step.eager)):
        state = init_decode_state(cfg, 4, 16, device=cuda, mesh=one_rank_mesh)
        t, toks = tok.to(cuda), []
        for i in range(6):
            if i == 4:
                coll.reset()
            t, state = fn(params, {"tokens": t}, state)
            if i == 4:
                books[name] = coll.books()
            toks.append(t)
        out[name] = (torch.cat(toks, 1), state_tensors(state))
    assert step.captures == 1
    assert torch.equal(out["graphed"][0], out["eager"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["graphed"][1], out["eager"][1]))
    assert books["graphed"] == books["eager"] and books["eager"]["counts"]


def test_serve_batch_captures_once_across_calls(cuda):
    """Three ``serve_batch`` calls at one key: eager, then a capture, then
    a replay (captures 0, 1, 0), every call's tokens the same bits, and
    the pooled state gone with its model."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_model

    cfg = get_config("gemma3-12b").scaled_down()
    params = init_model(cfg, 0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    stats, toks = [], []
    for _ in range(3):
        stats.append({})
        toks.append(serve.serve_batch(cfg, params, prompts, gen_len=5, device=cuda,
                                      stats=stats[-1]))
    assert [s["captures"] for s in stats] == [0, 1, 0]
    assert [s["graphed"] for s in stats] == [False, True, True]
    assert all(torch.equal(t, toks[0]) for t in toks)
    n = len(serve._pool)
    del params
    gc.collect()
    assert len(serve._pool) == n - 1


@pytest.mark.parametrize("kind", ["cfg", "inpaint"])
def test_guided_graphed_solve_on_card_is_the_host_chain(cuda, kind):
    """Classifier-free guidance and inpainting from a small livened DiT
    through ``sample()`` on per-row streams: the first call runs
    host-driven, the second captures, the third replays, both graphed
    calls bitwise the first with one host read each; a replay with another
    payload captures nothing and is bitwise the host-driven chain with that
    payload, not the first payload's sample (the payload is read from the
    driver's buffers, not baked into the capture); inpainted samples hold
    their observed pixels exactly."""
    from repro_torch.core.sampling import sample, seed_streams
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.launch import sample as launcher

    net = dataclasses.replace(launcher.DEMO_DIT, use_flash=True,
                              num_classes=launcher.DEMO_CLASSES if kind == "cfg" else 0)
    model = launcher.seeded_dit(net, seed=0, liven_seed=1, device=cuda)
    sde = VPSDE()
    score = tdit.make_score_fn(model, sde)
    guide = dict(cfg_scale=1.5) if kind == "cfg" else dict(inpaint=True)
    conditioner, cond, _ = launcher.guidance(8, net, **guide)
    other = ({"label": (cond["label"] + 5) % launcher.DEMO_CLASSES} if kind == "cfg"
             else {"mask": 1.0 - cond["mask"], "observed": -cond["observed"]})
    acfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, conditioner=conditioner)
    shape = (8, 16, 16, 3)

    def solve(c):
        c0, r0 = ad.captures, ad.host_syncs
        res = sample(sde, score, shape, seed=3, config=acfg, cond=c, device=cuda)
        torch.cuda.synchronize()
        return res, ad.captures - c0, ad.host_syncs - r0

    def host_chain(c):
        st = seed_streams(3, shape[0], cuda)
        carry = ad.init_carry(sde, sde.prior_sample(shape, st), st.advanced(1), config=acfg,
                              cond=c)
        carry = ad.solve_chunk(sde, score, carry, max_sync_iters=acfg.max_iters, config=acfg)
        return ad.finalize(sde, score, carry, precision=acfg.precision, conditioner=conditioner)

    fields = ("x", "nfe", "accepted", "rejected", "iterations")
    runs = [solve(cond) for _ in range(3)]
    assert [r[1] for r in runs] == [0, 1, 0]
    assert runs[1][2] == runs[2][2] == 1
    for res, *_ in runs[1:]:
        for f in fields:
            assert torch.equal(getattr(res, f), getattr(runs[0][0], f)), f
    swapped, captures, reads = solve(other)
    assert (captures, reads) == (0, 1)
    want = host_chain(other)
    for f in fields:
        assert torch.equal(getattr(swapped, f), getattr(want, f)), f
    assert not torch.equal(swapped.x, runs[0][0].x)
    assert torch.isfinite(swapped.x).all()
    if kind == "inpaint":
        for res, c in ((runs[2][0], cond), (swapped, other)):
            m = c["mask"].to(cuda) > 0
            assert torch.equal(res.x[m], c["observed"].to(cuda)[m])
