"""The CUDA wrappers refuse autograd (no reference counterpart: a Pallas
call inside ``jax.grad`` fails loudly at trace time).

Every CUDA wrapper launches its kernel through ``ctypes`` into a fresh
output tensor, which has no ``grad_fn``. Under grad mode, a kernel given
an input that requires grad would hand back a result cut off from the
graph, and every parameter upstream of it would silently get no
gradient. Neither package has a backward kernel, so each wrapper's
launch path calls ``refuse_autograd`` first. The plain versions (the
CPU branch) are ordinary PyTorch and keep flowing gradients.
"""

from __future__ import annotations

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise ``ValueError`` when grad mode is on and any of ``tensors``
    (``None`` entries are skipped) requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            f"{kernel}: an input requires grad, and neither package has a backward "
            "kernel for it, so the gradient would be lost. Run the call under "
            "torch.no_grad(), or take the plain path (CPU tensors, or the model's "
            "use_flash=False / use_fused_norm=False / use_kernel_ssd=False, or the "
            "solver's use_fused_kernel=False)")
