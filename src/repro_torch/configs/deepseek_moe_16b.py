"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066]; port of
``repro/configs/deepseek_moe_16b.py``.

Shared experts are fused into one 2·1408-wide always-on MLP. (The HF
checkpoint's first layer is a dense 10944-wide MLP; we keep the uniform
MoE pattern for the scanned stack — noted in DESIGN.md §6.)
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    mixer_pattern=("A",),
    mlp_pattern=("E",),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_ffn=1408,
        num_shared_experts=2,
        shared_ffn=2816,
    ),
    norm_type="rmsnorm",
    act="silu",
    glu=True,
    source="arXiv:2401.06066 (DeepSeekMoE 16B)",
)
