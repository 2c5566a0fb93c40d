"""Model FLOPs of a Nemotron-H round, and the work of its grouped expert
product, worked out from shapes and the program's expert counts.

A matrix product of (m, k) by (k, n) counts 2mkn. Per token and Mamba2
layer: the joint input projection d × (2·d_in + 2·G·N + H), the output
projection d_in × d, the depthwise conv (2 per tap and channel) and the SSD
scan, in prefill its chunked form over chunks of c (2cN for C·Bᵀ and 2cP
for its product with x per head, then 2NP into and 2NP out of the carried
state), in decode 4NP per head. Per token and expert layer: the router
d × R, the shared expert's two products d × f_s, and the routed experts'
two products d × f for each of the token's choices that lands on a held
expert: K times the held share of the (token, choice) pairs. Per token and
attention layer: the q, k, v and o projections, and scores and values
against every earlier position (causal: position t sees t + 1). The head is
d × vocab, at the prefill's last position and at every decode step.
"""

from __future__ import annotations

from tofec_bench.harness import yardstick


def _count(model: dict, kind: str) -> int:
    return model["layer_pattern"].count(kind)


def held_share(model: dict) -> float:
    """The share of (token, choice) pairs on held experts where the router
    spreads them evenly: held experts over the router's width."""
    return model["n_experts"] / (model.get("router_experts") or model["n_experts"])


def round_flops(model: dict, batch: int, prompt: int, steps: int, share: float) -> float:
    """Model FLOPs of one closed-loop round at ``batch`` rows: a prefill of
    ``prompt`` tokens, then ``steps - 1`` decode steps, ``share`` of the
    routed pairs on held experts."""
    d, V = model["d_model"], model["vocab"]
    H, P, G, N = model["mamba_heads"], model["mamba_head_dim"], model["mamba_groups"], \
        model["ssm_state"]
    di, c = H * P, model["ssm_chunk"]
    Hq, Hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    R, K, f, fs = (model.get("router_experts") or model["n_experts"]), model["top_k"], \
        model["d_ff"], model["shared_expert_ff"]
    n_m, n_e, n_a = _count(model, "M"), _count(model, "E"), _count(model, "*")
    mamba = 2 * d * (2 * di + 2 * G * N + H) + 2 * di * d + 2 * model["ssm_conv"] * (di + 2 * G * N)
    expert = 2 * d * R + 2 * 2 * d * fs + share * K * 2 * 2 * d * f
    attn_proj = 2 * d * Hq * hd * 2 + 2 * d * Hkv * hd * 2
    head = 2 * d * V
    cc = min(c, prompt)
    pre_ssd = H * (2 * cc * N + 2 * cc * P + 4 * N * P)
    ctx_sum = prompt * (prompt + 1) // 2
    prefill = (prompt * (n_m * (mamba + pre_ssd) + n_e * expert + n_a * attn_proj)
               + n_a * 4 * Hq * hd * ctx_sum + head)
    decode = 0.0
    for s in range(1, steps):
        ctx = prompt + s  # the new token's position + 1
        decode += (n_m * (mamba + 4 * H * N * P) + n_e * expert + n_a * attn_proj
                   + n_a * 4 * Hq * hd * ctx + head)
    return float(batch) * (prefill + decode)


def expert_counts(model: dict, held_pairs: int, experts_hit: int) -> tuple[float, float]:
    """(operations, bytes) of the grouped expert product (both of its
    matrix products) over layer calls that put ``held_pairs`` pairs on held
    experts and hit ``experts_hit`` of them in all: 2·2·d·f a pair; the
    bfloat16 weights of each expert hit read once, and each pair's rows
    read and written once (d in and f out, then f in and d out)."""
    d, f = model["d_model"], model["d_ff"]
    ops = 2.0 * 2 * d * f * held_pairs
    nbytes = 2.0 * 2 * d * f * experts_hit + 2.0 * 2 * (d + f) * held_pairs
    return ops, nbytes


def expert_bound_s(model: dict, held_pairs: int, experts_hit: int) -> float:
    """The least time the grouped expert products of one phase (a prefill,
    or a round's decode steps) can take on the card, its layer calls taken
    alike: the larger of their bytes over the HBM rate and their
    operations over the bfloat16 peak."""
    ops, nbytes = expert_counts(model, held_pairs, experts_hit)
    return max(nbytes / yardstick.PEAK_HBM_BYTES, ops / yardstick.PEAK_BF16_FLOPS)
