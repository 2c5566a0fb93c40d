"""Unified model configuration covering all 10 assigned architectures.

A copy of the reference package's ``repro/models/config.py`` (which imports
no JAX; the port keeps its own copy so it never imports the reference). One
frozen dataclass parameterizes every family (dense / moe / ssm / hybrid /
encdec / vlm); family-specific behavior keys off these fields inside the
model implementations. The port's per-arch instantiations live in
``repro_torch/configs/<id>.py`` and are registered in
:mod:`repro_torch.models.registry`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | nemotron_h | deepseek_v3
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # MLP
    mlp_act: str = "silu"  # silu | gelu | relu2 (relu(x)²)
    glu: bool = True
    # attention details
    qkv_bias: bool = False
    use_rope: bool = True  # False: no position embedding (NoPE)
    rope_theta: float = 10_000.0
    # YaRN-scaled RoPE of latent attention (deepseek_v3)
    yarn_factor: float = 0.0
    yarn_original: int = 0  # the context the unscaled frequencies were trained on
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    # multi-head latent attention (deepseek_v3): the queries' and the keys'
    # and values' low-rank widths, and each head's widths
    mla_q_rank: int = 0
    mla_kv_rank: int = 0
    mla_nope_dim: int = 0
    mla_rope_dim: int = 0
    mla_v_dim: int = 0
    sliding_window: int | None = None  # all layers SWA (mixtral)
    local_global_period: int | None = None  # gemma2: every other layer local
    local_window: int = 4096
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    # MoE
    n_experts: int = 0  # the experts held here (all of them, unless expert parallel)
    top_k: int = 2
    capacity_factor: float = 1.25
    router_experts: int = 0  # the router's width; 0: n_experts
    expert_first: int = 0  # the first expert held here
    routed_scale: float = 1.0  # the routed experts' weights times this
    shared_expert_ff: int = 0  # the shared expert's width (nemotron_h, deepseek_v3)
    moe_ff: int = 0  # the routed experts' width where the dense MLPs differ (0: d_ff)
    # group-limited routing: the router's experts in n_group groups, a
    # token's top_k taken from its topk_group best groups
    n_group: int = 1
    topk_group: int = 1
    dense_layers: int = 0  # deepseek_v3: the first layers have a dense MLP, the rest experts
    # SSM / recurrent
    ssm_state: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0  # xlstm: every j-th layer is an sLSTM block
    attn_every: int = 0  # zamba2: shared attention block every j layers
    # Mamba2's own sizes (0: the attention's n_heads, ssm_expand·d_model
    # wide, B and C per head) and its published extras
    mamba_heads: int = 0
    mamba_head_dim: int = 0
    mamba_groups: int = 0  # B, C shared by groups of heads
    ssm_conv_bias: bool = False
    ssm_gated_norm: bool = False  # grouped RMSNorm of y·silu(z) before w_out
    # nemotron_h: one character per layer, M Mamba2, E MoE, * attention
    layer_pattern: str = ""
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper-base 30 s → 1500 frames (stub frontend)
    # vlm (pixtral)
    vision_patches: int = 1024  # stub ViT output length
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6  # the nemotron_h family's RMSNorm eps
    embed_scale: bool = True  # embeddings times sqrt(d_model)
    # training-time knobs (hillclimbing levers; see EXPERIMENTS.md §Perf)
    remat_policy: str = "nothing"  # nothing | dots | full
    seq_shard_activations: bool = True  # Megatron-SP style residual sharding
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    ssm_chunk: int = 256
    # dry-run FLOPs pass: unroll scans so HLO cost_analysis counts every
    # loop iteration (XLA counts while-loop bodies once).
    scan_unroll: bool = False
    # §Perf lever: gather FSDP-sharded weights at the use site instead of
    # letting GSPMD all-reduce contraction outputs (MaxText-style).
    weight_gather: bool = False
    # §Perf lever: shard decode KV-cache sequence over "model" (256-way
    # caches) and update caches in-place through the layer-scan carry.
    decode_cache_seq_shard: bool = False
    # §Perf lever: "default" or "pure_dp" (replicate params, batch-only
    # sharding — right call for sub-1B models on 256 chips).
    sharding_profile: str = "default"
    # §Perf lever: gradient-accumulation microbatches per step (memory).
    grad_accum: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def expert_ff(self) -> int:
        return self.moe_ff or self.d_ff

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def ssm_heads(self) -> int:
        return self.mamba_heads or self.n_heads

    @property
    def ssm_head_dim(self) -> int:
        return self.mamba_head_dim or self.ssm_expand * self.d_model // self.ssm_heads

    @property
    def ssm_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def ssm_groups(self) -> int:
        return self.mamba_groups or self.ssm_heads

    @property
    def n_router(self) -> int:
        return self.router_experts or self.n_experts

    @property
    def is_recurrent(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode at 512k: SSM/hybrid state or bounded SWA."""
        if self.is_recurrent:
            return True
        return self.sliding_window is not None and self.local_global_period is None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def param_count_dense(self) -> int:
        """Analytic parameter estimate (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * 2  # embed + untied head
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.n_experts:
            ff_unit = self.n_experts * (3 if self.glu else 2) * d * self.d_ff
            router = d * self.n_experts
            mlp = ff_unit + router
        elif self.d_ff:
            mlp = (3 if self.glu else 2) * d * self.d_ff
        else:
            mlp = 0
        if self.family == "ssm":
            # mLSTM-ish block: in/out proj at expansion + gates
            di = self.ssm_expand * d
            mlp = 0
            attn = 2 * d * di * 2 + 3 * di  # up/gate + down, cheap gates
        per_layer = attn + mlp
        if self.family == "hybrid":
            # Mamba2 backbone layers + ONE shared attn+mlp block (weights
            # applied at multiple depths but stored once).
            di = self.ssm_expand * d
            dconv = di + 2 * self.n_heads * self.ssm_state
            mamba = (
                d * (2 * di + 2 * self.n_heads * self.ssm_state + self.n_heads)
                + self.ssm_conv * dconv
                + di * d
            )
            return int(emb + self.n_layers * mamba + per_layer)
        total = emb + self.n_layers * per_layer
        if self.encoder_layers:
            total += self.encoder_layers * per_layer
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count_dense()
        full = self.param_count_dense()
        d = self.d_model
        ff_unit = (3 if self.glu else 2) * d * self.d_ff
        moe_total = self.n_layers * self.n_experts * ff_unit
        moe_active = self.n_layers * self.top_k * ff_unit
        return int(full - moe_total + moe_active)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full attention at 512k ctx is quadratic — skipped per task spec"
    return True, ""
