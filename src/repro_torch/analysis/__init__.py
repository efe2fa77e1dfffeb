"""Port of ``repro/analysis``: the telemetry report (``telemetry.py``) and
the solver zoo's auto-selection (``solver_select.py``)."""
