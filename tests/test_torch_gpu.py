"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a card; the decision
is made inside the ``cuda`` fixture, never at import or collection time.
Run them on a machine with an H100:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Bounds: solver step fp32 1e-5 (the kernel contracts a·b + c into FMAs
and sums the row in another order); bf16 1e-2 on x'' (one bf16 ulp)
with e2 still fp32 1e-5; flash attention fp32 3e-5 and bf16 2e-2, as on
the CPU side.
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.solver_step import ops as step_ops
from repro_torch.kernels.solver_step import ref as step_ref
from repro_torch.models import dit as tdit

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


CASES = [
    # B, Hq, Hkv, S, D, causal, window, dtype
    (8, 12, 12, 256, 64, False, None, torch.float32),
    (8, 12, 12, 256, 64, False, None, torch.bfloat16),
    (2, 4, 2, 200, 32, True, 64, torch.float32),
    (1, 2, 1, 25, 16, False, None, torch.float32),
    (1, 4, 4, 64, 256, True, None, torch.float32),
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


def test_dit_forward_flash_matches_plain_on_card(cuda):
    cfg = tdit.DiTConfig(image_size=32, patch=4, d_model=128, num_layers=2,
                         num_heads=4, d_ff=256)
    model = tdit.init_dit(cfg, torch.Generator(device=cuda).manual_seed(0))
    tdit.liven_zero_init(model, torch.Generator(device=cuda).manual_seed(1))
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4, 32, 32, 3, generator=g, device=cuda)
    t = torch.linspace(0.1, 1.0, 4, device=cuda)
    plain = model(x, t)
    model.cfg = dataclasses.replace(cfg, use_flash=True)
    before = flash_ops.launches
    fast = model(x, t)
    assert flash_ops.launches == before + cfg.num_layers
    torch.testing.assert_close(fast, plain, rtol=1e-4, atol=1e-4)
    assert plain.abs().mean() > 1e-2
