"""Port of ``repro/kernels/ssd``: the chunked Mamba2 SSD scan (K7)."""
