"""Device resolution for the port's entry points (no reference counterpart:
JAX picks its backend globally, the port names the device per call).

The default is ``cuda``: the port is built to run on the card, and a
caller who wants the CPU says so with ``device="cpu"``. A request for
``cuda`` on a host without a card raises instead of quietly running on
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` | ``"cpu"`` | ``"meta"`` | ``torch.device`` →
    ``torch.device``. ``"meta"`` (shapes and dtypes, no storage) is for
    the dry run (``launch/dryrun.py``), which asks for it by name.

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (want 'cuda', 'cpu' or 'meta')")
    return dev
