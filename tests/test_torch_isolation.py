"""The port stands alone and never falls back.

* No file under ``src/repro_torch/`` and no line of ``chip_smoke.py``
  imports ``jax`` or ``repro`` (an AST scan).
* Entry points asked for no device run on ``cuda``: with no card they
  raise instead of running on the CPU.
* A kernel wrapper takes its plain version only for CPU tensors; any
  other request goes to the kernel path, which raises where it cannot
  build or launch.
"""

import ast
import pathlib

import pytest
import torch

from repro_torch.core import analytic, sampling
from repro_torch.core.sde import VPSDE
from repro_torch.core.solvers import adaptive as tad
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.groupnorm_silu import ops as gn_ops
from repro_torch.kernels.groupnorm_silu import ref as gn_ref
from repro_torch.kernels.solver_step import ops as step_ops
from repro_torch.kernels.solver_step import ref as step_ref
from repro_torch.launch import sample as launcher
from repro_torch.launch.plan import serve_planning
from repro_torch.planning import OUEnv, PlannerConfig, RecedingHorizonPlanner, plan

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_card_raise(no_card):
    sde = VPSDE()
    score = analytic.gaussian_score(sde)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampling.sample(sde, score, (2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampling.solve_in_chunks(sde, score, (2, 3), max_sync_iters=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tad.adaptive(sde, score, torch.zeros(2, 3), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "cifar_dit"])
    pcfg = PlannerConfig(horizon=8, obs_dim=2, act_dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RecedingHorizonPlanner(sde, lambda p, x, t, y=None: x, None, pcfg, OUEnv())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_planning(envs=1, steps=1)
    # the same calls run when the caller asks for the CPU
    assert sampling.sample(sde, score, (2, 3), device="cpu").x.shape == (2, 3)


def _never(*args, **kwargs):
    raise AssertionError("a non-CPU request reached the plain version")


def test_wrappers_do_not_fall_back(monkeypatch):
    monkeypatch.setattr(step_ref, "error_step", _never)
    monkeypatch.setattr(flash_ref, "attention", _never)
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        step_ops.error_step(*(meta(2, 8) for _ in range(5)), *(meta(2) for _ in range(3)),
                            eps_abs=0.01, eps_rel=0.05)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_ops.attention(meta(1, 2, 8, 16), meta(1, 2, 8, 16), meta(1, 2, 8, 16))


def test_kernel_path_raises_where_it_cannot_build(monkeypatch, tmp_path):
    """Where the kernels cannot be built (a host without nvcc), the launch path
    raises; it does not hand the request to the plain version."""
    monkeypatch.setattr(step_ref, "error_step", _never)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _build.library.cache_clear()
    before = (step_ops.launches, flash_ops.launches)
    try:
        x = torch.zeros(2, 8)
        c = torch.zeros(2)
        with pytest.raises(RuntimeError, match="nvcc"):
            step_ops._launch(x, x, x, x, x, c, c, c, c, c, use_prev=True)
        with pytest.raises(RuntimeError, match="nvcc"):
            flash_ops._launch(*(torch.zeros(1, 2, 8, 16) for _ in range(3)),
                              causal=False, window=None, scale=0.25, true_len=None)
    finally:
        _build.library.cache_clear()
    assert (step_ops.launches, flash_ops.launches) == before


def test_plan_without_a_card_raises(no_card):
    sde = VPSDE()
    score = analytic.class_gaussian_score(sde, [0.0, 1.0])
    pcfg = PlannerConfig(horizon=4, obs_dim=2, act_dim=1, guidance_scale=1.5)
    obs, bins = torch.zeros(2, 2), torch.tensor([0, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan(sde, score, obs, pcfg=pcfg, returns=bins)
    res = plan(sde, score, obs, pcfg=pcfg, returns=bins, device="cpu")
    assert res.x.shape == (2, 4, 3) and torch.equal(res.x[:, 0, :2], obs)


def test_groupnorm_wrapper_does_not_fall_back(monkeypatch, tmp_path):
    """Meta tensors are refused; where the kernels cannot be built, the
    launch path raises and counts nothing."""
    monkeypatch.setattr(gn_ref, "groupnorm_silu", _never)
    meta = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gn_ops.groupnorm_silu(meta, torch.empty(16, device="meta"),
                              torch.empty(16, device="meta"), groups=4)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _build.library.cache_clear()
    before = gn_ops.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            gn_ops._launch(torch.zeros(2, 8, 16), torch.ones(16), torch.zeros(16),
                           groups=4, eps=1e-6)
    finally:
        _build.library.cache_clear()
    assert gn_ops.launches == before


def test_baselines_without_a_card_raise(no_card):
    from repro_torch.core.likelihood import log_likelihood
    from repro_torch.core.solvers import get_solver

    sde = VPSDE()
    score = analytic.gaussian_score(sde)
    for method in ("em", "pc", "pc_hmc", "ddim", "ode"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sampling.sample(sde, score, (2, 3), method=method)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_solver(method)(sde, score, torch.zeros(2, 3), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        log_likelihood(sde, score, torch.zeros(2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.run("cifar_dit", method="em", n_steps=2)


def test_em_step_wrapper_does_not_fall_back(monkeypatch, tmp_path):
    """K5: meta tensors are refused; where the kernels cannot be built, the
    launch path raises and counts nothing."""
    monkeypatch.setattr(step_ref, "em_step", _never)
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        step_ops.em_step(*(meta(2, 8) for _ in range(3)), *(meta(2) for _ in range(3)))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _build.library.cache_clear()
    before = step_ops.em_launches
    try:
        x, c = torch.zeros(2, 8), torch.zeros(2)
        with pytest.raises(RuntimeError, match="nvcc"):
            step_ops._launch_em(x, x, x, c, c, c)
    finally:
        _build.library.cache_clear()
    assert step_ops.em_launches == before


def test_lm_entry_points_without_a_card_raise(no_card):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_model

    cfg = get_config("mamba2-2.7b").scaled_down()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serve_step(cfg)
    params = init_model(cfg, device="cpu")
    prompts = torch.zeros(1, 3, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_batch(cfg, params, prompts, gen_len=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-2.7b", "--reduced"])
    # the same calls run when the caller asks for the CPU
    assert serve.serve_batch(cfg, params, prompts, gen_len=2, device="cpu").shape == (1, 2)


def test_ssd_wrapper_does_not_fall_back(monkeypatch, tmp_path):
    """K7: the plain version only for CPU tensors; meta tensors are
    refused; where the kernels cannot be built, the launch path raises and
    counts nothing."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    def shapes(make):
        return (make(1, 8, 2, 16), make(1, 8, 2), make(2), make(1, 8, 1, 16),
                make(1, 8, 1, 16))

    calls = []
    plain = ssd_ref.ssd_chunked
    monkeypatch.setattr(ssd_ref, "ssd_chunked", lambda *a, **k: calls.append(1) or plain(*a, **k))
    ssd_ops.ssd_scan(*shapes(torch.zeros))
    assert calls == [1]
    monkeypatch.setattr(ssd_ref, "ssd_chunked", _never)
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_ops.ssd_scan(*shapes(lambda *s: torch.empty(*s, device="meta")))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _build.library.cache_clear()
    before = ssd_ops.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            ssd_ops._launch(*shapes(torch.zeros), return_state=False)
    finally:
        _build.library.cache_clear()
    assert ssd_ops.launches == before


def test_port_scan_covers_the_lm_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("kernels/ssd/ops.py", "kernels/ssd/ref.py", "models/mamba2.py",
              "models/transformer.py", "models/config.py", "models/kvcache.py",
              "configs/mamba2_2_7b.py", "launch/steps.py", "launch/serve.py"):
        assert f"src/repro_torch/{f}" in names


def test_port_scan_covers_the_sharded_slice():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
              "parallel/collectives.py", "launch/mesh.py", "launch/sharded_selftest.py"):
        assert f"src/repro_torch/{f}" in names


def test_sharded_path_has_no_single_process_fallback(no_card):
    """Without a process group the mesh is not built; without a card the
    card's selftest and a sharded solve raise."""
    from repro_torch.launch import sharded_selftest
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import Mesh, init_mesh

    with pytest.raises(RuntimeError, match="process group"):
        init_mesh(1, 1, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_selftest.run(1)  # the card unless the caller asks for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_selftest.run(1, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="NCCL"):
        sharded_selftest.run(1, device="cpu", backend="nccl")
    sde = VPSDE()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampling.sample(sde, analytic.gaussian_score(sde), (2, 3),
                        mesh=Mesh(("data",), (1,), (0,)))


def test_sharded_step_wrappers_do_not_fall_back(monkeypatch):
    """K4: meta tensors are refused by the sharded step and its partial
    mode; the plain partial is taken only for CPU tensors."""
    from repro_torch.parallel import Mesh

    monkeypatch.setattr(step_ref, "error_step_sums", _never)
    monkeypatch.setattr(step_ref, "error_step", _never)
    meta = lambda *s: torch.empty(*s, device="meta")
    args = [meta(2, 8) for _ in range(5)] + [meta(2) for _ in range(3)]
    with pytest.raises(ValueError, match="unsupported device"):
        step_ops.error_step_sums(*args, eps_abs=0.01, eps_rel=0.05)
    mesh = Mesh(("data", "model"), (1, 1), (0, 0))
    for feature in (None, "model"):
        with pytest.raises(ValueError, match="unsupported device"):
            step_ops.sharded_error_step(*args, eps_abs=0.01, eps_rel=0.05, mesh=mesh,
                                        batch_axes="data", feature_axis=feature)
