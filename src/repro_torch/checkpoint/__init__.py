"""Port of ``repro/checkpoint``."""
