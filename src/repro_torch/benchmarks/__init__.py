"""Benchmarks of the port that run inside the package (``python -m``)."""
