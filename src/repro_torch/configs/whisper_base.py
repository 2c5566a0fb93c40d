"""whisper-base [audio]: enc-dec, conv frontend STUBBED (precomputed frames).

6L (enc) + 6L (dec), d_model=512, 8H MHA (kv=8), d_ff=2048, vocab=51865.
[arXiv:2212.04356]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp_act="gelu",
    glu=False,
    qkv_bias=True,
    encoder_layers=6,
    encoder_seq=1500,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, encoder_seq=16,
    )
