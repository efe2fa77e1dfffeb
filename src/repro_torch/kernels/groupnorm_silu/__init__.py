"""Fused GroupNorm → SiLU; port of ``repro/kernels/groupnorm_silu``."""
