"""olmo-1b — dense, non-parametric LayerNorm [arXiv:2402.00838];
port of ``repro/configs/olmo_1b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    mixer_pattern=("A",),
    mlp_pattern=("D",),
    norm_type="layernorm_np",  # OLMo's non-parametric LN
    act="silu",
    glu=True,
    rope_theta=10_000.0,
    source="arXiv:2402.00838 (OLMo 1B)",
)
