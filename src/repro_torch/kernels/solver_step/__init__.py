"""Fused adaptive-solver step; port of ``repro/kernels/solver_step``."""
