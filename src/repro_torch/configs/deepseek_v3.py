"""deepseek-v3 [deepseek_v3]: latent attention in all 61 layers, 3 dense
layers, then 58 expert layers.

MLA with 128 heads: queries through a 1,536-wide low rank, keys and values
through a 512-wide latent, each head 128 + 64 (roped) query and key
channels and 128 value channels; YaRN (factor 40 over 4,096 positions,
β_fast 32, β_slow 1, mscale 1 and 1). Dense SwiGLU MLPs of 18,432; expert
layers of 256 SwiGLU experts of 2,048, top 8 by sigmoid score with a
correction bias from the best 4 of 8 groups, routed scale 2.5, and one
shared expert of 2,048. d_model 7,168, vocab 129,280, untied head, RMSNorm
eps 1e-6, embeddings unscaled.
[hf:deepseek-ai/DeepSeek-V3; arXiv:2412.19437]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3",
    family="deepseek_v3",
    n_layers=61,
    dense_layers=3,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    mla_q_rank=1536,
    mla_kv_rank=512,
    mla_nope_dim=128,
    mla_rope_dim=64,
    mla_v_dim=128,
    rope_theta=10000.0,
    yarn_factor=40.0,
    yarn_original=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=1.0,
    yarn_mscale_all_dim=1.0,
    d_ff=18432,
    moe_ff=2048,
    n_experts=256,
    top_k=8,
    n_group=8,
    topk_group=4,
    routed_scale=2.5,
    shared_expert_ff=2048,
    vocab=129280,
    norm_eps=1e-6,
    embed_scale=False,
)


def smoke_config() -> ModelConfig:
    """2 dense and 3 expert layers; 16 experts in 4 groups, the top 4 from
    the best 2 groups, experts 4-7 held; small MLA widths whose value width
    differs from the key's, and a YaRN ramp over 16 original positions that
    gives fast, ramped and slow rotary dimensions."""
    return dataclasses.replace(
        CONFIG, n_layers=5, dense_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        mla_q_rank=24, mla_kv_rank=16, mla_nope_dim=8, mla_rope_dim=8, mla_v_dim=12,
        yarn_original=64, d_ff=96, moe_ff=32, shared_expert_ff=32, n_experts=4,
        router_experts=16, expert_first=4, top_k=4, n_group=4, topk_group=2, vocab=512,
    )
