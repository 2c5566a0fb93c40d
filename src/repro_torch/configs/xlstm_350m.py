"""xlstm-350m [ssm]: sLSTM + mLSTM blocks, no separate FFN (d_ff=0).

24L, d_model=1024, 4H, vocab=50304. sLSTM every 4th block (xLSTM[7:1]-style
mix), mLSTM elsewhere. [arXiv:2405.04517]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm_expand=2,
    slstm_every=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, vocab=256,
        slstm_every=3, ssm_chunk=8,
    )
