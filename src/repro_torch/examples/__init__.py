"""Port of ``examples/``: runnable end-to-end programs (``quickstart``,
``train_diffusion``), kept inside the package."""
