"""The WHILE-node driver of the graphed loops: a CUDA-graph WHILE node over
a captured unit of a loop (an iteration, an RK45 attempt, a step), with
P2 (``horizon_cond``) after every unit as its condition; the counterpart
of the nested ``lax.while_loop``s of the reference's ``solve_chunk`` and
``solve_horizons`` (``repro/core/solvers/adaptive.py``)."""
