"""mixtral-8x7b [moe]: 8 experts top-2 + sliding-window attention.

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=32000, SWA 4096.
[arXiv:2401.04088]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, n_experts=4, top_k=2, sliding_window=8,
    )
