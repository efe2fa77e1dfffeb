"""Serving launcher, batched language-model decode; port of the LM mode
of ``repro/launch/serve.py``.

``serve_batch`` prefills a batch of prompts by replaying them token by
token through the serve step (exact and state-consistent, as the
reference does), then decodes greedily. The ``--diffusion`` and
``--plan`` modes of the reference come with serving (ROADMAP A7).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --batch 4 --prompt-len 16 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import init_decode_state, init_model
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def serve_batch(cfg: ModelConfig, params, prompts: Tensor, *, gen_len: int = 32,
                device="cuda") -> Tensor:
    """prompts (B, P) int → the generated tokens (B, gen_len) int32: the
    first from the last prompt position, then greedy."""
    dev = resolve_device(device)
    B, P = prompts.shape
    state = init_decode_state(cfg, B, P + gen_len, device=dev)
    step = make_serve_step(cfg, device=dev)
    prompts = prompts.to(dev)

    # prefill by replay (exact; the fused prefill is make_prefill_step)
    next_tok = None
    for i in range(P):
        next_tok, state = step(params, {"tokens": prompts[:, i:i + 1]}, state)

    out = [next_tok]
    for _ in range(gen_len - 1):
        nt, state = step(params, {"tokens": out[-1]}, state)
        out.append(nt)
    return torch.cat(out, dim=1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, help=f"one of {list(ARCH_IDS)}")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's scaled_down() variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.scaled_down()
    params = init_model(cfg, 0, device=dev)  # weights and prompts from seed 0
    g = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, device=dev)
    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, prompts, gen_len=args.gen_len, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_steps = args.prompt_len + args.gen_len - 1
    rec = {"arch": cfg.name, "device": str(dev), "batch": args.batch,
           "prompt_len": args.prompt_len, "gen_len": args.gen_len,
           "wall_s": dt, "ms_per_step": dt / n_steps * 1e3,
           "tokens_per_s": args.batch * args.gen_len / dt,
           "tokens": toks.tolist()}
    print(f"{cfg.name} on {dev}: generated {tuple(toks.shape)} in {dt:.2f} s "
          f"({rec['ms_per_step']:.1f} ms per step of {args.batch}, "
          f"{rec['tokens_per_s']:.1f} new tokens/s)")
    print("sample:", toks[0, :16].tolist())
    return rec


if __name__ == "__main__":
    main()
