"""nemotron3-nano-30b-a3b [nemotron_h]: Mamba2, sparse-expert and attention
layers in one published order.

52 layers, ``MEMEM*EMEMEM*…``: 23 Mamba2 (64 heads of 64, B and C in 8
groups, state 128, conv bias, gated RMSNorm), 23 expert layers (128 experts,
top 6 by sigmoid score with a correction bias, routed scale 2.5, relu²
experts of 1,856 and a shared expert of 3,712) and 6 attention layers (32
query heads, 2 KV heads of 128, no position embedding); d_model 2,688,
vocab 131,072, untied head, RMSNorm eps 1e-5, embeddings unscaled.
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16; arXiv:2504.03624]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ModelConfig(
    name="nemotron3-nano-30b-a3b",
    family="nemotron_h",
    n_layers=52,
    layer_pattern=PATTERN,
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    use_rope=False,
    d_ff=1856,
    mlp_act="relu2",
    glu=False,
    n_experts=128,
    top_k=6,
    routed_scale=2.5,
    shared_expert_ff=3712,
    vocab=131072,
    ssm_state=128,
    ssm_conv=4,
    ssm_chunk=128,
    mamba_heads=64,
    mamba_head_dim=64,
    mamba_groups=8,
    ssm_conv_bias=True,
    ssm_gated_norm=True,
    norm_eps=1e-5,
    embed_scale=False,
)


def smoke_config() -> ModelConfig:
    """Every kind of layer, B and C in fewer groups than heads, and fewer
    experts held (experts 2-5) than the router scores."""
    return dataclasses.replace(
        CONFIG, n_layers=5, layer_pattern="ME*EM", d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, shared_expert_ff=48, n_experts=4, router_experts=8,
        expert_first=2, top_k=2, vocab=512, ssm_state=16, ssm_chunk=8, mamba_heads=4,
        mamba_head_dim=16, mamba_groups=2,
    )
