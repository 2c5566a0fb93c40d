"""pixtral-12b [vlm]: pixtral-ViT frontend STUB + mistral-nemo backbone.

Backbone: 40L, d_model=5120, 32H (GQA kv=8), d_ff=14336, vocab=131072.
The ViT is a stub: ``input_specs`` provides precomputed patch embeddings
(1024 patches at d_model). [hf:mistralai/Pixtral-12B-2409]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
    vision_patches=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, vision_patches=8,
    )
