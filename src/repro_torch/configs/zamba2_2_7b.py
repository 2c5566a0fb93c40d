"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block.

54L Mamba2 (d_model=2560, ssm_state=64) with one SHARED attention+MLP block
(32H MHA, d_ff=10240) applied every 6 backbone layers. [arXiv:2411.15242]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    attn_every=6,
    local_window=4096,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, ssm_state=16, attn_every=2, ssm_chunk=8, local_window=8,
    )
