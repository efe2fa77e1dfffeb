"""P1: per-row counter-based (Philox) normals, the port's per-slot noise draw."""
