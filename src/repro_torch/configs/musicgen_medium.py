"""musicgen-medium — decoder-only over EnCodec tokens, 4 codebooks
[arXiv:2306.05284].

The EnCodec frontend is the allowed stub: inputs are the 4 parallel
codebook token streams (B, S, 4); embedding = Σ_k embed_k(token_k),
output = 4 parallel vocab-2048 heads (the delay-pattern bookkeeping is a
data-pipeline concern, handled in repro_torch.data.tokens).

Port of ``repro/configs/musicgen_medium.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    mixer_pattern=("A",),
    mlp_pattern=("D",),
    norm_type="layernorm",
    act="gelu",
    glu=False,  # MusicGen uses a plain (non-gated) transformer MLP
    source="arXiv:2306.05284 (MusicGen medium)",
)
