"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Every module mirrors the reference module of the same path under
``repro`` (``repro_torch/core/sde.py`` answers to ``repro/core/sde.py``)
and names it in its docstring. The port imports ``torch`` and numpy only:
nothing of JAX and nothing of ``repro``.

Entry points (``core.sampling.sample``, ``core.solvers.adaptive.adaptive``,
``launch.sample``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no ``device="cpu"`` they raise.
"""
