"""Port of ``examples/``: runnable end-to-end programs (``quickstart``,
``train_diffusion``, ``sample_adaptive``, ``inpaint_adaptive``), kept
inside the package."""
