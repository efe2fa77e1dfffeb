"""The device-resident serve loop's driver: a CUDA-graph WHILE node over
a captured sync horizon, with P2 (``horizon_cond``) as its condition; the
counterpart of the ``lax.while_loop`` of the reference's
``solve_horizons`` (``repro/core/solvers/adaptive.py``)."""
