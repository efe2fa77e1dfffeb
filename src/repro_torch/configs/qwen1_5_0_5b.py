"""qwen1.5-0.5b — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B];
port of ``repro/configs/qwen1_5_0_5b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    mixer_pattern=("A",),
    mlp_pattern=("D",),
    qkv_bias=True,  # Qwen1.5's attention biases
    norm_type="rmsnorm",
    act="silu",
    glu=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
