"""Port of ``repro/kernels``: hand-written Hopper kernels, each with its
plain PyTorch version (``ref.py``) and its wrapper (``ops.py``)."""
