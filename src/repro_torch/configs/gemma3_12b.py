"""gemma3-12b — dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family, 12B-scale per assignment]; port of
``repro/configs/gemma3_12b.py``.

head_dim 256 is decoupled from d_model/num_heads (Gemma convention).
Local layers use a 1024-token sliding window; every 6th layer is global
— this native sub-quadratic pattern is why gemma3 runs long_500k
without the SWA override (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    mixer_pattern=("L", "L", "L", "L", "L", "A"),
    mlp_pattern=("D",) * 6,
    sliding_window=1024,
    qk_norm=True,
    norm_type="rmsnorm",
    act="gelu",
    glu=True,
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt (12B-scale per assignment)",
)
