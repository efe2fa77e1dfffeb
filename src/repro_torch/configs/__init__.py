"""Port of ``repro/configs``: the diffusion configurations."""
