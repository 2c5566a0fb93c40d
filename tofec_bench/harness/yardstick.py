"""The benchmark's yardsticks: the card's peaks, K1's work and a hybrid
model's FLOPs, worked out from shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, at the
700 W power limit): a run reports the card's limit beside every share.
"""

from __future__ import annotations

#: bfloat16 dense tensor-core FLOP/s
PEAK_BF16_FLOPS = 989.4e12
#: int8 dense tensor-core operations/s
PEAK_INT8_OPS = 1.979e15
#: HBM3 bytes/s
PEAK_HBM_BYTES = 3.35e12


def k1_counts(batch: int, m8: int, k8: int, B: int) -> tuple[float, int]:
    """(operations, bytes) of one K1 call on (batch, m8, k8) 0/1 bit-matrices
    and (batch, k8 / 8, B) byte strips, giving (batch, m8 / 8, B) bytes: the
    equivalent 0/1 int8 product's 2·batch·m8·k8·B operations, and each input
    byte read once and each output byte written once."""
    nbytes = batch * m8 * k8 + batch * (k8 // 8) * B + batch * (m8 // 8) * B
    return 2.0 * batch * m8 * k8 * B, nbytes


def k1_bound_s(batch: int, m8: int, k8: int, B: int) -> float:
    """The least time one K1 call can take on the card: the larger of its
    bytes over the HBM rate and its operations over the int8 peak."""
    ops, nbytes = k1_counts(batch, m8, k8, B)
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_INT8_OPS)


def _sites(model: dict) -> int:
    every = model.get("attn_every", 0)
    return model["n_layers"] // every if every else 0


def hybrid_flops(model: dict, batch: int, prompt: int, steps: int) -> float:
    """Model FLOPs of one closed-loop round of a Mamba2 + shared-attention
    hybrid at ``batch`` rows (the rows the round serves): a prefill of
    ``prompt`` tokens, whose logits are taken at the last position only,
    then ``steps - 1`` decode steps (the first token comes from the
    prefill's logits).

    A matrix product of (m, k) by (k, n) counts 2mkn. Per token and Mamba2
    layer: the joint input projection d × (2·di + 2·H·N + H), the output
    projection di × d, the depthwise conv (2 per tap and channel), and the
    SSD scan, in prefill its chunked form over chunks of c (2cN for C·Bᵀ and
    2cP for its product with x per head, then 2NP into and 2NP out of the
    carried state), in decode 4NP per head. Per token and shared-block
    site: q, k, v and o projections, scores and values against every
    earlier position inside the window (causal: position t sees t + 1),
    and the gated MLP (three d × d_ff products). The head is d × vocab.
    """
    d, H, N = model["d_model"], model["n_heads"], model["ssm_state"]
    di = model["ssm_expand"] * d
    P, hd = di // H, model.get("head_dim") or d // H
    L, sites, K, c = model["n_layers"], _sites(model), model["ssm_conv"], model["ssm_chunk"]
    window, d_ff, V = model["local_window"], model["d_ff"], model["vocab"]
    proj = 2 * d * (2 * di + 2 * H * N + H) + 2 * di * d + 2 * K * (di + 2 * H * N)
    attn_proj = 2 * d * (model["n_heads"] * hd) * 2 + 2 * d * (model["n_kv_heads"] * hd) * 2
    mlp = 3 * 2 * d * d_ff
    head = 2 * d * V

    def attn_ctx(pos: int) -> int:  # positions the token at ``pos`` attends to
        return min(pos + 1, window)

    cc = min(c, prompt)
    pre_ssd = H * (2 * cc * N + 2 * cc * P + 4 * N * P)
    ctx_sum = sum(attn_ctx(t) for t in range(prompt))
    prefill = (prompt * (L * (proj + pre_ssd) + sites * (attn_proj + mlp))
               + sites * 4 * model["n_heads"] * hd * ctx_sum + head)
    decode = 0.0
    for s in range(1, steps):
        pos = prompt + s - 1
        decode += (L * (proj + 4 * H * N * P) + sites * (attn_proj + mlp)
                   + sites * 4 * model["n_heads"] * hd * attn_ctx(pos) + head)
    return float(batch) * (prefill + decode)
