"""LM training launcher; port of ``repro/launch/train.py``.

``train_loop`` builds a model from ``seed`` on ``device`` (the card
unless the caller asks for the CPU), trains it on the synthetic token
pipeline (``data.tokens.synth_batch``; the delay pattern for codebook
models, seeded image embeddings for cross-attention ones) with
``optim.AdamW`` under ``warmup_cosine(lr, max(steps // 10, 1), steps)``,
in full fp32 with the plain attention and SSD paths (no kernel has a
backward), and checkpoints the parameters into ``ckpt_dir`` when given.

With ``mesh`` (a ``("data", "model")`` ``parallel.Mesh`` over an
initialised process group; every rank calls ``train_loop`` alike) it is
the reference's loop under its mesh (:31-90): the model built sharded
(``init_model(mesh=)``: ``param_shardings`` without ``fsdp``, with
``num_experts``, as the reference's :48-53), every rank drawing the same
batches and image embeddings and training on its rows
(``steps.make_train_step(mesh=)``), global rank 0 alone printing, and
the checkpoint the whole tree, gathered one leaf at a time and written
by global rank 0 (the layout of the unsharded checkpoint).

  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium --steps 20 --batch 2 --seq 512
"""

from __future__ import annotations

import argparse
import time

import torch

import torch.distributed as dist

from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import TokenPipelineConfig, synth_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_model
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.parallel.collectives import gather_whole
from repro_torch.parallel.sharding import tree_map_with_path


def train_loop(cfg: ModelConfig, *, steps: int = 20, batch: int = 8, seq: int = 128,
               lr: float = 3e-4, seed: int = 0, mesh=None, ckpt_dir: str | None = None,
               log_every: int = 5, step_times: list | None = None, device="cuda"):
    """Train ``cfg`` from seeded weights for ``steps`` steps of ``batch`` ×
    ``seq`` tokens; returns (params, the cross-entropy of every step).
    ``step_times``, when given, receives each step's seconds (the host
    waits for the step's cross-entropy, so the time is the device's).
    With ``mesh`` (module docstring) ``params`` are the rank's shard on
    ``mesh.device`` and the cross-entropies the batch's."""
    dev = resolve_device(device if mesh is None else mesh.device)
    talk = mesh is None or dist.get_rank(mesh.group()) == 0  # global rank 0 alone prints
    optimizer = AdamW(lr=warmup_cosine(lr, max(steps // 10, 1), steps))
    params = init_model(cfg, seed, device=dev, mesh=mesh)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer, device=dev, mesh=mesh)
    pipe = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                               num_codebooks=cfg.num_codebooks, seed=seed)
    cross = None
    if cfg.vision_dim:  # the same draw on every rank: one seed, one device type
        g = torch.Generator(device=dev).manual_seed(seed)
        cross = torch.randn((batch, cfg.num_patches, cfg.vision_dim), generator=g,
                            device=dev).to(getattr(torch, cfg.dtype))

    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        t_step = time.perf_counter()
        b = {"tokens": synth_batch(pipe, step).to(dev)}
        if cross is not None:
            b["cross_embeds"] = cross
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["ce"]))
        if step_times is not None:
            step_times.append(time.perf_counter() - t_step)
        if talk and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:4d}  ce {losses[-1]:.4f}  "
                  f"moe_aux {float(metrics['moe_aux']):.4f}  "
                  f"({(time.perf_counter() - t0) / (step + 1):.2f}s/step)")
    if ckpt_dir:
        tree = params if mesh is None else gather_params(params, mesh, cfg, keep=talk)
        if talk:
            save_checkpoint(ckpt_dir, steps, {"params": tree}, metadata={"arch": cfg.name})
        if mesh is not None:
            dist.barrier()
    return params, losses


def gather_params(params, mesh, cfg: ModelConfig, *, keep: bool = True):
    """The whole parameter tree from every rank's shard (laid out by
    ``model_shardings``): each leaf gathered in turn (every rank takes
    part) and, where ``keep`` (the checkpoint's writer), moved to the
    CPU; None leaves elsewhere."""
    shards = tr.model_shardings(cfg, mesh)

    def one(path, t):
        sh = shards
        for k in path:
            sh = sh[k]
        whole = gather_whole(t.detach(), sh)
        return whole.cpu() if keep else None

    return tree_map_with_path(one, params)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the config's scaled_down() variant")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.scaled_down()
    _, losses = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                           ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"final ce {losses[-1]:.4f} (from {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
