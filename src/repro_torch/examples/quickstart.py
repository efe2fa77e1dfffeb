"""Quickstart: the paper's algorithm end to end; port of
``examples/quickstart.py``.

Trains the ``TOY_MLP`` score net on the 2-D 4-mode mixture (600 steps,
``benchmarks.common.train_mlp``) and samples 2048 points with
Euler–Maruyama at 1000 steps and with the adaptive solver at ε_rel 0.01
and 0.05, printing NFE and the x-axis W1 distance to data draws for
each: the paper's headline comparison.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import gmm_data, train_mlp
from repro_torch.core.sampling import sample
from repro_torch.device import resolve_device


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=600)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("training score network on 4-mode GMM ...")
    net = train_mlp("vp", args.steps, 0, dev)
    for step in range(0, args.steps, 150):
        print(f"  step {step:4d}  dsm loss {float(net.losses[step]):.3f}")

    print("\nsampling 2048 points:")
    data = gmm_data(2048, 9)
    out = []
    for method, kw in [("em", dict(n_steps=1000)),
                       ("adaptive", dict(eps_rel=0.01)),
                       ("adaptive", dict(eps_rel=0.05))]:
        res = sample(net.sde, net.score_fn, (2048, 2), seed=0, method=method,
                     device=dev, **kw)
        x = res.x.cpu().numpy()
        err = float(np.abs(np.sort(x[:, 0]) - np.sort(data[:, 0])).mean())
        tag = f"{method}({kw})"
        print(f"  {tag:35s} NFE {float(res.mean_nfe):6.0f}   W1(x-axis) {err:.4f}")
        out.append(dict(method=method, nfe=float(res.mean_nfe), w1=err, **kw))
    print("\nadaptive reaches EM-1000 quality at a fraction of the NFE — "
          "the paper's Figure 1.")
    return out


if __name__ == "__main__":
    main()
