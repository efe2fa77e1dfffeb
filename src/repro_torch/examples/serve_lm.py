"""Both generation paradigms of the framework, served: a scaled-down LM of
the architecture zoo answers batched requests through the production
serve path (KV or SSM caches, greedy decode), and a DiT answers image
requests with the adaptive solver; port of ``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch gemma3-12b] [--device cpu]

``--arch`` takes any registered architecture, the mixture-of-experts
ones (deepseek-moe-16b, granite-moe-3b-a800m, jamba-v0.1-52b),
llama-3.2-vision-90b (seeded image embeddings) and musicgen-medium
(four-codebook prompts) included.
``python -m repro_torch.launch.serve --arch gemma3-12b`` serves the
full-width model on the card.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VPSDE
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve_batch
from repro_torch.models import init_model
from repro_torch.models.dit import DiTConfig, init_dit, make_score_fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-12b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. autoregressive serving, weights and prompts from seed 0
    cfg = get_config(args.arch).scaled_down()
    params = init_model(cfg, 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (args.batch, args.prompt_len) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                                            else ())
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)
    cross = None
    if cfg.vision_dim:
        cross = torch.randn((args.batch, cfg.num_patches, cfg.vision_dim), generator=g,
                            device=dev)
    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, prompts, gen_len=args.gen_len, cross_embeds=cross,
                       device=dev)
    dt = time.perf_counter() - t0
    print(f"[AR] {args.arch} (reduced): generated {tuple(toks.shape)} in {dt:.1f} s "
          f"({toks.numel() / dt:.0f} tok/s)")

    # 2. diffusion serving (the paper's technique)
    net = DiTConfig(image_size=16, patch=4, d_model=96, num_layers=2, num_heads=4, d_ff=256)
    sde = VPSDE()
    dit = init_dit(net, torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    res = sample(sde, make_score_fn(dit, sde), (args.batch, 16, 16, 3), seed=0,
                 method="adaptive", device=dev, eps_rel=0.05)
    dt = time.perf_counter() - t0
    print(f"[diffusion] served {args.batch} image requests in {dt:.1f} s "
          f"(mean NFE {float(res.mean_nfe):.0f}, adaptive solver)")
    return {"tokens": toks.tolist(), "mean_nfe": float(res.mean_nfe)}


if __name__ == "__main__":
    main()
