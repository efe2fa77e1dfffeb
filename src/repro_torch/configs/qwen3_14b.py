"""qwen3-14b — dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B family];
port of ``repro/configs/qwen3_14b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    mixer_pattern=("A",),
    mlp_pattern=("D",),
    qk_norm=True,  # Qwen3's per-head RMS q/k norms
    norm_type="rmsnorm",
    act="silu",
    glu=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (14B-scale variant per assignment)",
)
