"""Shared benchmark harness: trained score nets and quality metrics;
port of ``benchmarks/common.py``.

The paper scores solvers by FID; offline the quality metric is the
Fréchet distance between Gaussian fits on raw features (the statistic
FID computes on Inception features), plus a sliced-Wasserstein distance
on the 2-D mixture. The score nets are ``TOY_MLP`` nets trained here on
``GMM2D`` (``trained_mlp``, cached per process, steps, seed and device),
as the reference trains its own: batch 512, ``AdamW(lr=2e-3,
weight_decay=0.0)`` (so clip 1.0 and b2 0.95), EMA 0.995, and the
noise-parametrised ``apply_fn`` net(x, t)/std(t).

JAX's and torch's generators never agree, so the port's nets, draws and
rows are its own: comparable with the reference's in what they show, not
digit for digit. Every row prints as the reference's CSV,
``name,us_per_call,derived``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.diffusion import TOY_MLP
from repro_torch.core.losses import dsm_loss
from repro_torch.core.precision import pin_full_fp32_math
from repro_torch.core.sampling import sample
from repro_torch.core.sde import SDE, VESDE, VPSDE, bcast
from repro_torch.core.solvers.adaptive import ADAPTIVE_FAMILY
from repro_torch.data.images import GMM2D
from repro_torch.device import resolve_device
from repro_torch.models.score_unet import MLPScore, init_mlp_score
from repro_torch.optim import AdamW, ema_init, ema_params, ema_update

GMM = GMM2D()  # the 4-mode mixture, the benchmark data distribution


def frechet_gaussian(x, y) -> float:
    """Fréchet distance between Gaussian fits of two sample sets (the FID
    formula on raw features): |μ1−μ2|² + tr(C1 + C2 − 2(C1 C2)^½), in
    float64 numpy."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    c1 = np.cov(x, rowvar=False) + 1e-8 * np.eye(x.shape[1])
    c2 = np.cov(y, rowvar=False) + 1e-8 * np.eye(y.shape[1])
    # the matrix square root of c1 c2 through the symmetrised product
    s1 = _sqrtm_psd(c1)
    inner = _sqrtm_psd(s1 @ c2 @ s1)
    return float(((x.mean(0) - y.mean(0)) ** 2).sum() + np.trace(c1 + c2 - 2 * inner))


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh((a + a.T) / 2)
    return (v * np.sqrt(np.clip(w, 0, None))) @ v.T


def sliced_wasserstein(x, y, n_proj: int = 64, seed: int = 0) -> float:
    """Sliced W2 between two sample sets (exact in each 1-D projection),
    float64 numpy; the directions come from a CPU ``torch.Generator``
    seeded ``seed``."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    g = torch.Generator().manual_seed(seed)
    dirs = torch.randn(n_proj, x.shape[1], generator=g).numpy().astype(np.float64)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    n = min(x.shape[0], y.shape[0])
    px = np.sort(x[:n] @ dirs.T, axis=0)
    py = np.sort(y[:n] @ dirs.T, axis=0)
    return float(np.sqrt(np.mean((px - py) ** 2)))


def w2_gaussianized(x, y) -> float:
    """The cheap 2-Wasserstein proxy of the reference's end-to-end test
    (``tests/test_e2e_diffusion.py``): Σ_d |Δmean| + Σ_d |Δstd|."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return float(np.abs(x.mean(0) - y.mean(0)).sum() + np.abs(x.std(0) - y.std(0)).sum())


def mlp_sde(process: str) -> SDE:
    """The benchmark SDEs: VP as it is, VE with σ_max 12."""
    return VPSDE() if process == "vp" else VESDE(sigma_max=12.0)


def noise_apply(sde: SDE) -> Callable:
    """apply_fn(model, x, t) = model(x, t)/std(t): the noise-parametrised
    score the benchmarks and the examples train, for a state of any rank."""

    def apply_fn(model, x, t):
        _, std = sde.marginal(t)
        return model(x, t) / bcast(std, x)

    return apply_fn


@dataclasses.dataclass
class TrainedMLP:
    """A trained ``TOY_MLP``: its SDE, the EMA net (gradients off), the
    loss of every step, the training's synchronised wall seconds."""

    sde: SDE
    model: MLPScore
    losses: np.ndarray
    seconds: float

    def score_fn(self, x, t):
        return noise_apply(self.sde)(self.model, x, t)


def fit(model: torch.nn.Module, sde: SDE, draw: Callable, opt: AdamW, steps: int,
        ema_decay: float, gen: torch.Generator, *, log_every: int = 0):
    """Train ``model`` on the DSM loss of ``sde`` with the noise-parametrised
    ``apply_fn`` for ``steps`` steps: each step ``draw(step) -> (x0, t, z)``
    (t and z None to draw them in ``dsm_loss`` from ``gen``), the loss's
    gradients, ``opt.update`` (parameters updated in place), then the EMA at
    ``ema_decay``. Prints the loss every ``log_every`` steps (0: never).

    Returns (the EMA net, a copy of ``model`` with gradients off; the loss
    of every step; the ms of every step, synchronised: reading the loss
    waits for the step)."""
    params = list(model.parameters())
    dev = params[0].device
    state, ema = opt.init(params), ema_init(params)
    apply_fn = noise_apply(sde)
    losses, ms = [], []
    for step in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x0, t, z = draw(step)
        loss = dsm_loss(sde, apply_fn, model, x0, gen, t=t, z=z)
        grads = torch.autograd.grad(loss, params)
        params, state = opt.update(grads, state, params)
        ema = ema_update(ema, params, ema_decay)
        losses.append(float(loss.detach()))
        ms.append((time.perf_counter() - t0) * 1e3)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d}  loss {losses[-1]:10.2f}  {ms[-1]:.1f} ms/step")
    final = copy.deepcopy(model).requires_grad_(False)
    with torch.no_grad():
        for p, e in zip(final.parameters(), ema_params(ema, params)):
            p.copy_(e)
    return final, np.asarray(losses, np.float32), np.asarray(ms)


def train_mlp(process: str, steps: int = 600, seed: int = 0, device="cuda", *,
              batch: int = 512, model: Optional[MLPScore] = None,
              draws: Optional[Callable] = None, data: GMM2D = GMM,
              ema_decay: float = 0.995) -> TrainedMLP:
    """Train a ``TOY_MLP`` score net on ``data`` for ``process`` ("vp" or
    "ve") on ``device``, from ``model`` (default: ``init_mlp_score`` from a
    generator seeded ``seed``), through ``fit``.

    Each step draws a batch, then t and z (``dsm_loss``), from that
    generator; ``draws(step) -> (x0, t, z)`` replaces all three (tests
    replay the reference's). TF32 is turned off first: the products are
    fp32.
    """
    dev = resolve_device(device)
    pin_full_fp32_math()
    sde = mlp_sde(process)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if model is None:
        model = init_mlp_score(TOY_MLP, gen)
    model = model.to(dev)
    if draws is None:
        draw = lambda step: (data.sample(gen, batch), None, None)
    else:
        draw = lambda step: tuple(a.to(dev) for a in draws(step))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    final, losses, _ = fit(model, sde, draw, AdamW(lr=2e-3, weight_decay=0.0), steps,
                           ema_decay, gen)
    return TrainedMLP(sde=sde, model=final, losses=losses, seconds=time.perf_counter() - t0)


@functools.lru_cache(maxsize=4)
def _trained_mlp(process: str, steps: int, seed: int, device: str) -> TrainedMLP:
    return train_mlp(process, steps, seed, device)


def trained_mlp(process: str, steps: int = 600, seed: int = 0, device="cuda") -> TrainedMLP:
    """``train_mlp`` with its defaults, cached per (process, steps, seed,
    device): the tables share one net per process."""
    return _trained_mlp(process, steps, seed, str(resolve_device(device)))


def trained_mlp_score(process: str, steps: int = 600, seed: int = 0,
                      device="cuda") -> Tuple[SDE, Callable]:
    """(sde, score_fn) of the cached trained net, as the reference's."""
    net = trained_mlp(process, steps, seed, device)
    return net.sde, net.score_fn


def gmm_data(n: int, seed: int) -> np.ndarray:
    """n reference draws of ``GMM`` (n, 2) from a CPU generator seeded
    ``seed``: the same data whatever device the solves ran on."""
    return GMM.sample(torch.Generator().manual_seed(seed), n).numpy()


def timed(fn: Callable, *args, repeats: int = 1) -> Tuple[float, object]:
    """µs per call of ``fn(*args)`` over ``repeats`` calls, synchronised on
    the card around the timed calls. Eager PyTorch has no compile for a
    first call to absorb; the tables warm each row's graph key up before
    timing it instead (``warm_up``: allocator, first launches, the
    capture)."""
    cuda = torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / repeats * 1e6, out


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(csv_row(name, us_per_call, derived))


def warm_kwargs(method: str, solver_kwargs: dict) -> dict:
    """``solver_kwargs`` with the per-solve values the graph key leaves out
    (``adaptive.cached_driver``) set cheap: a two-step grid, loose
    tolerances. A solve with them reaches the same cached driver as one
    with ``solver_kwargs``."""
    kw = dict(solver_kwargs)
    if "n_steps" in kw:
        kw["n_steps"] = 2
    if method == "ode":
        kw.update(rtol=1e-2, atol=1e-2)
    elif method in ADAPTIVE_FAMILY:  # Algorithm 1's tolerances are per-solve values
        if kw.get("config") is not None:
            kw["config"] = dataclasses.replace(kw["config"], eps_rel=0.5)
        else:
            kw["eps_rel"] = 0.5
    return kw


def warm_up(sde: SDE, score_fn: Callable, shape, device, method: str,
            **solver_kwargs) -> None:
    """Two cheap solves (``warm_kwargs``) at the graph key of a row of
    ``method`` with ``solver_kwargs``: under the one-shot rule the first
    runs host-driven (the allocator's and the launches' first use) and
    the second captures, so the row's timed solve replays a graph (or
    runs on the CPU's plain driver) and captures nothing."""
    kw = warm_kwargs(method, solver_kwargs)
    for _ in range(2):
        sample(sde, score_fn, shape, seed=0, method=method, device=device, **kw)


def solve_row(name: str, sde: SDE, score_fn: Callable, shape, *, seed: int, device,
              data: np.ndarray, method: str, **solver_kwargs) -> dict:
    """One timed ``sample`` call and its row, after ``warm_up`` at its key:
    mean NFE, iterations, accept/reject totals and rate, the Fréchet
    distance, sliced W2 and ``w2_gaussianized`` against ``data``,
    finiteness, whether the fused solver step was asked for (``fused``),
    and the solver-step kernels' launches in this solve (both counts set
    to 0 just before it and read just after; 0 on the CPU, where the
    wrappers take their plain versions), with ``captures``, the CUDA
    graphs the timed solve captured (0 after the warm-up), and
    ``host_reads``, its device→host reads (``adaptive.host_syncs``: one a
    graphed solve)."""
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.kernels.solver_step import ops as step_ops

    warm_up(sde, score_fn, shape, device, method, **solver_kwargs)
    step_ops.launches = step_ops.em_launches = 0
    c0, r0 = ad.captures, ad.host_syncs
    us, res = timed(lambda: sample(sde, score_fn, shape, seed=seed, method=method,
                                   device=device, **solver_kwargs))
    launches = {"solver_step": step_ops.launches, "em_step": step_ops.em_launches}
    x = res.x.to(torch.float32).cpu().numpy()
    acc, rej = int(res.accepted.sum()), int(res.rejected.sum())
    config = solver_kwargs.get("config")
    fused = bool(solver_kwargs.get("use_fused_kernel",
                                   config is not None and config.use_fused_kernel))
    return dict(name=name, method=method, us=us, nfe=float(res.mean_nfe), fused=fused,
                iterations=int(res.iterations), accepted=acc, rejected=rej,
                rej=rej / max(acc + rej, 1), frechet=frechet_gaussian(x, data),
                sw2=sliced_wasserstein(x, data), w2g=w2_gaussianized(x, data),
                finite=bool(np.isfinite(x).all()), launches=launches,
                captures=ad.captures - c0, host_reads=ad.host_syncs - r0,
                n_steps=solver_kwargs.get("n_steps"))
