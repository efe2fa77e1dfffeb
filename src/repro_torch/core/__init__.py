"""Port of ``repro/core``: SDEs, tolerances, precision, the adaptive solver."""
