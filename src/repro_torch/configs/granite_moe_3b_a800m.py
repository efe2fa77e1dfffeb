"""granite-moe-3b-a800m — MoE, 40 routed experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]; port of
``repro/configs/granite_moe_3b_a800m.py``.

The assignment's config line says 40 experts top-8 while its note says
32; we follow the explicit config numbers (40) — recorded in DESIGN.md §4.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    mixer_pattern=("A",),
    mlp_pattern=("E",),
    moe=MoEConfig(num_experts=40, top_k=8, expert_ffn=512),
    norm_type="rmsnorm",
    act="silu",
    glu=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (3b-a800m per assignment)",
)
