"""gemma2-2b [dense]: local+global alternating attention, logit softcaps.

26L, d_model=2304, 8H (GQA kv=4), head_dim=256, d_ff=9216, vocab=256000,
local window 4096, attn softcap 50, final logit softcap 30. [arXiv:2408.00118]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    mlp_act="gelu",
    glu=True,
    local_global_period=2,
    local_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, local_window=8,
    )
