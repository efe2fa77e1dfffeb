"""llama-3.2-vision-90b — VLM: cross-attention image layers every 5th
layer [hf:meta-llama/Llama-3.2-11B-Vision, 90B-scale per assignment].

The ViT vision tower is the reference's stub: callers pass precomputed
patch embeddings (B, num_patches, vision_dim) as ``cross_embeds``; the
decoder's cross-attention layers (k/v projected from vision_dim) are
implemented. The whole stack (87.6 B parameters, 326.5 GiB in fp32)
needs a mesh of several cards (``init_model(mesh=)``); one 5-layer
period (``replace(num_layers=5)``, 6.38 B) fits one card.

Port of ``repro/configs/llama3_2_vision_90b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    mixer_pattern=("A", "A", "A", "A", "X"),
    mlp_pattern=("D", "D", "D", "D", "D"),
    vision_dim=7680,
    num_patches=1601,
    norm_type="rmsnorm",
    act="silu",
    glu=True,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B-scale per assignment)",
)
