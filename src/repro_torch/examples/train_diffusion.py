"""End-to-end example: train a DiT score network on synthetic images, then
sample from it with the solver suite; port of
``examples/train_diffusion.py``.

Presets: ``small`` (a 16×16 DiT, CPU-feasible), ``cifar`` (``CIFAR_DIT``)
and ``100m`` (``DIT_100M``, the reference's ~100 M-parameter preset: 32×32,
patch 2, d_model 768, 12 layers). The data are ``GMMImageConfig`` images
at the preset's size (the port's own generator parameters, drawn from
``cfg.seed``); the loss is the DSM loss on the VP SDE; the optimiser is
``AdamW`` under ``warmup_cosine(3e-4, steps//10 + 1, steps)`` with no
weight decay, and the sampled net is the EMA at 0.999. TF32 is off: the
products are fp32.

Training runs with ``use_flash=False``, as the reference trains (neither
package has a backward for the flash kernel). The EMA net is written
through ``checkpoint.save_checkpoint`` when ``--ckpt-dir`` is given, and
sampling runs with flash attention (K3) and the fused solver step (K1)
on the card: EM at 500 steps, adaptive at ε_rel 0.01 and 0.05, and the
probability-flow ODE.

  PYTHONPATH=src python -m repro_torch.examples.train_diffusion --device cpu --preset small --steps 50
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import fit
from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.configs.diffusion import CIFAR_DIT, DIT_100M
from repro_torch.core.precision import pin_full_fp32_math
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VPSDE
from repro_torch.data.images import GMMImageConfig, generator_params, sample_images
from repro_torch.device import resolve_device
from repro_torch.models.dit import DiT, DiTConfig, init_dit, make_score_fn, param_count
from repro_torch.optim import AdamW, warmup_cosine

PRESETS = {
    "small": DiTConfig(image_size=16, patch=4, d_model=128, num_layers=4,
                       num_heads=4, d_ff=512),
    "cifar": CIFAR_DIT,
    "100m": DIT_100M,
}


def sampling_cfg(preset: str) -> DiTConfig:
    """The preset's config for sampling: flash attention on (K3 on the
    card). Training runs the same weights with ``use_flash=False``."""
    return dataclasses.replace(PRESETS[preset], use_flash=True)


@dataclasses.dataclass
class Trained:
    """A trained DiT: the EMA net (its ``cfg`` is ``sampling_cfg``), the
    loss and synchronised ms of every step, and the device's peak
    allocated bytes during training (None on the CPU)."""

    model: DiT
    losses: np.ndarray
    ms_per_step: np.ndarray
    peak_bytes: Optional[int]


def train(preset: str = "small", *, steps: int = 300, batch: int = 32, seed: int = 0,
          device="cuda", ckpt_dir: Optional[str] = None, log_every: int = 50) -> Trained:
    """Train the preset's DiT for ``steps`` steps of ``batch`` images."""
    dev = resolve_device(device)
    pin_full_fp32_math()
    cfg = dataclasses.replace(PRESETS[preset], use_flash=False)
    data_cfg = GMMImageConfig(image_size=cfg.image_size, channels=cfg.channels)
    data_params = generator_params(data_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_dit(cfg, gen)
    print(f"DiT preset={preset}: {param_count(model) / 1e6:.1f}M params")
    opt = AdamW(lr=warmup_cosine(3e-4, steps // 10 + 1, steps), weight_decay=0.0)
    draw = lambda step: (sample_images(data_cfg, gen, batch, params=data_params), None, None)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    final, losses, ms = fit(model, VPSDE(), draw, opt, steps, 0.999, gen,
                            log_every=log_every)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    final.cfg = sampling_cfg(preset)
    if ckpt_dir:
        path = save_checkpoint(ckpt_dir, steps, {"params": final.state_dict()},
                               metadata={"preset": preset})
        print(f"checkpoint written to {path}")
    return Trained(model=final, losses=losses, ms_per_step=ms, peak_bytes=peak)


def load_trained(ckpt_dir: str, preset: str, device="cuda") -> DiT:
    """The checkpointed EMA net of ``train(ckpt_dir=...)`` on ``device``,
    gradients off, under ``sampling_cfg``."""
    dev = resolve_device(device)
    tree, _ = restore_checkpoint(ckpt_dir)
    model = DiT(sampling_cfg(preset), device=dev)
    model.load_state_dict(tree["params"])
    return model.requires_grad_(False)


def compare_solvers(model: DiT, *, sample_batch: int = 64, seed: int = 0,
                    device="cuda") -> list:
    """EM-500, adaptive at ε_rel 0.01 and 0.05 (fused step), and the ODE
    from ``model``; per method the NFE and the errors of the channel
    means and of the overall std against data draws."""
    dev = resolve_device(device)
    cfg = model.cfg
    sde = VPSDE()
    score_fn = make_score_fn(model, sde)
    shape = (sample_batch, cfg.image_size, cfg.image_size, cfg.channels)
    data_cfg = GMMImageConfig(image_size=cfg.image_size, channels=cfg.channels)
    data = sample_images(data_cfg, torch.Generator(device=dev).manual_seed(7),
                         sample_batch).cpu()
    rows = []
    print("\nsolver comparison on the trained model:")
    for method, kw in [("em", dict(n_steps=500)),
                       ("adaptive", dict(eps_rel=0.01, use_fused_kernel=True)),
                       ("adaptive", dict(eps_rel=0.05, use_fused_kernel=True)),
                       ("ode", {})]:
        res = sample(sde, score_fn, shape, seed=seed, method=method, device=dev, **kw)
        x = res.x.cpu()
        mean_err = float((x.mean((0, 1, 2)) - data.mean((0, 1, 2))).abs().mean())
        std_err = float((x.std(unbiased=False) - data.std(unbiased=False)).abs())
        print(f"  {method:10s}{str(kw):46s} NFE {float(res.mean_nfe):6.0f}  "
              f"chan-mean err {mean_err:.3f}  std err {std_err:.3f}")
        rows.append(dict(method=method, nfe=float(res.mean_nfe), mean_err=mean_err,
                         std_err=std_err, finite=bool(torch.isfinite(x).all()), **kw))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sample-batch", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = train(args.preset, steps=args.steps, batch=args.batch, device=args.device,
                ckpt_dir=args.ckpt_dir)
    model = load_trained(args.ckpt_dir, args.preset, args.device) if args.ckpt_dir else run.model
    return compare_solvers(model, sample_batch=args.sample_batch, device=args.device)


if __name__ == "__main__":
    main()
