"""qwen1.5-0.5b [dense]: QKV bias, MHA-as-GQA (kv=16).

24L, d_model=1024, 16H (kv=16), d_ff=2816, vocab=151936. [hf:Qwen/Qwen1.5-0.5B]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    )
