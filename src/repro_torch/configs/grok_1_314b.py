"""grok-1-314b [moe]: 8 experts top-2, attention logit softcap.

64L, d_model=6144, 48H (GQA kv=8), d_ff=32768, vocab=131072, MoE 8e top-2.
[hf:xai-org/grok-1]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    attn_softcap=30.0,
    logit_softcap=30.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, n_experts=4, top_k=2,
    )
