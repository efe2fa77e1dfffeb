"""Port of ``repro/models``: the DiT score network and its layers."""
