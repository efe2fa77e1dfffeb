"""Port of ``repro/analysis``: the telemetry report (``telemetry.py``)."""
