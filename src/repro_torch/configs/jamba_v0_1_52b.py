"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE 16e top-2 every other
layer [arXiv:2403.19887]; port of
``repro/configs/jamba_v0_1_52b.py``.

Period-8 super-block: attention at index 4, Mamba elsewhere; MoE MLP on
odd indices. Adaptation note (DESIGN.md §6): Jamba v0.1 uses Mamba-1
(d_state 16); we realize the SSM layers with the Mamba2/SSD formulation
(same d_state) because SSD is the TPU-native (MXU-friendly) form of the
selective scan.
"""

from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    mixer_pattern=("M", "M", "M", "M", "A", "M", "M", "M"),
    mlp_pattern=("D", "E", "D", "E", "D", "E", "D", "E"),
    moe=MoEConfig(num_experts=16, top_k=2, expert_ffn=14336),
    mamba=MambaConfig(d_state=16, head_dim=64, expand=2, n_groups=1),
    norm_type="rmsnorm",
    act="silu",
    glu=True,
    source="arXiv:2403.19887 (Jamba v0.1)",
)
