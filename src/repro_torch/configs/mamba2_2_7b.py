"""mamba2-2.7b — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060]; port of ``repro/configs/mamba2_2_7b.py``.

d_inner = 2·2560 = 5120 → 80 heads of dim 64, d_state 128, one group,
conv width 4. No MLP (mlp_pattern "N"): the Mamba2 block is the whole
layer. num_heads / num_kv_heads are placeholders (no attention layers
exist).
"""

from repro_torch.models.config import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    mixer_pattern=("M",),
    mlp_pattern=("N",),
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    norm_type="rmsnorm",
    source="arXiv:2405.21060 (Mamba2 2.7B)",
)
