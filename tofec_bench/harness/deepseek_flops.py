"""Model FLOPs and bytes of a DeepSeek-V3 round, its decode steps' least
time on the card, and the work of its grouped expert product, worked out
from shapes and the program's expert counts.

A matrix product of (m, k) by (k, n) counts 2mkn. Per token and layer, with
H heads, a latent r wide (``mla_kv_rank``), queries through a q-rank:

* latent attention's projections: d × q_rank, q_rank × H(nope + rope),
  d × (r + rope), and H·v × d for W_o;
* prefill (decompressed): the latent's keys and values r × H(nope + v),
  scores H(nope + rope) and values H·v against every earlier position
  (causal: position t sees t + 1);
* decode (absorbed): q_lat H·nope × r, scores H(r + rope) and the latent
  sum H·r against every cached position up to its own, then W_UV H·r × v;
* a dense layer's SwiGLU, three products d × d_ff; an expert layer's router
  d × R, the shared SwiGLU expert's three products d × f_s, and the routed
  SwiGLU's three d × f for each of the token's choices that lands on a held
  expert: K times the held share of the (token, choice) pairs.

The head is d × vocab, at the prefill's last position and at every decode
step.
"""

from __future__ import annotations

from tofec_bench.harness import yardstick


def held_share(model: dict) -> float:
    """The share of (token, choice) pairs on held experts where the router
    spreads them evenly: held experts over the router's width."""
    return model["n_experts"] / (model.get("router_experts") or model["n_experts"])


def _mla(model: dict) -> tuple[float, float, float, float]:
    """(projections, prefill's per-token rest, prefill's per position seen,
    decode's per position seen) of one token in one layer."""
    d, H, qr, r = model["d_model"], model["n_heads"], model["mla_q_rank"], model["mla_kv_rank"]
    dn, dr, dv = model["mla_nope_dim"], model["mla_rope_dim"], model["mla_v_dim"]
    proj = 2 * d * qr + 2 * qr * H * (dn + dr) + 2 * d * (r + dr) + 2 * H * dv * d
    return proj, 2 * r * H * (dn + dv), 2 * H * (dn + dr) + 2 * H * dv, 2 * H * (r + dr) + 2 * H * r


def _absorb(model: dict) -> float:
    """A decode token's q_lat and W_UV products in one layer."""
    H, r = model["n_heads"], model["mla_kv_rank"]
    return 2 * H * model["mla_nope_dim"] * r + 2 * H * r * model["mla_v_dim"]


def _ffn(model: dict, share: float) -> float:
    """One token's dense and expert layers, the routed experts at ``share``
    of the pairs."""
    d = model["d_model"]
    R = model.get("router_experts") or model["n_experts"]
    n_dense = model["dense_layers"]
    expert = (2 * d * R + 3 * 2 * d * model["shared_expert_ff"]
              + share * model["top_k"] * 3 * 2 * d * model["moe_ff"])
    return n_dense * 3 * 2 * d * model["d_ff"] + (model["n_layers"] - n_dense) * expert


def round_flops(model: dict, batch: int, prompt: int, steps: int, share: float) -> float:
    """Model FLOPs of one closed-loop round at ``batch`` rows: a prefill of
    ``prompt`` tokens, then ``steps - 1`` decode steps, ``share`` of the
    routed pairs on held experts."""
    L, head = model["n_layers"], 2 * model["d_model"] * model["vocab"]
    proj, kv_up, per_seen, per_cached = _mla(model)
    ffn = _ffn(model, share)
    prefill = (prompt * (L * (proj + kv_up) + ffn)
               + L * per_seen * prompt * (prompt + 1) // 2 + head)
    decode = sum(L * (proj + _absorb(model) + per_cached * (prompt + s)) + ffn + head
                 for s in range(1, steps))
    return float(batch) * (prefill + decode)


def weight_bytes(model: dict) -> float:
    """Bytes of every weight a decode step reads whole: all but the routed
    experts and the embedding table (bfloat16; the router and its bias
    float32)."""
    d, H, qr, r = model["d_model"], model["n_heads"], model["mla_q_rank"], model["mla_kv_rank"]
    dn, dr, dv = model["mla_nope_dim"], model["mla_rope_dim"], model["mla_v_dim"]
    R = model.get("router_experts") or model["n_experts"]
    n_dense = model["dense_layers"]
    mla = d * qr + qr * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d + qr + r
    layer = 2 * (mla + 2 * d)
    dense = 2 * 3 * d * model["d_ff"]
    expert = 4 * (d * R + R) + 2 * 3 * d * model["shared_expert_ff"]
    return (model["n_layers"] * layer + n_dense * dense + (model["n_layers"] - n_dense) * expert
            + 2 * (d * model["vocab"] + d))


def expert_bytes(model: dict) -> float:
    """Bytes of one routed expert's three bfloat16 matrices."""
    return 2 * 3 * model["d_model"] * model["moe_ff"]


def decode_bound_s(model: dict, batch: int, prompt: int, steps: int, held_pairs: int,
                   experts_hit: int) -> float:
    """The least time ``steps`` decode steps after a prompt can take on the
    card, each the larger of its bytes over the HBM rate and its FLOPs over
    the bfloat16 peak. A step reads every weight but the routed experts
    once, each held expert hit once (``experts_hit`` over all the steps'
    layers, spread evenly), the embedding rows of its tokens, and the
    latent cache up to its position, and writes its token's latent; step s
    (from 1) attends to prompt + s positions. Its FLOPs are
    :func:`round_flops`'s decode step at ``batch`` rows, the routed experts
    at the counted pairs."""
    L, d = model["n_layers"], model["d_model"]
    width = model["mla_kv_rank"] + model["mla_rope_dim"]
    proj, _, _, per_cached = _mla(model)
    ffn = _ffn(model, 0.0)
    pair = 3 * 2 * d * model["moe_ff"]
    fixed = weight_bytes(model) + experts_hit / steps * expert_bytes(model) + 2 * batch * d
    total = 0.0
    for s in range(1, steps + 1):
        ctx = prompt + s
        nbytes = fixed + 2 * L * batch * width * (ctx + 1)
        flops = (batch * (L * (proj + _absorb(model) + per_cached * ctx) + ffn
                          + 2 * d * model["vocab"]) + held_pairs / steps * pair)
        total += max(nbytes / yardstick.PEAK_HBM_BYTES, flops / yardstick.PEAK_BF16_FLOPS)
    return total


def expert_counts(model: dict, held_pairs: int, experts_hit: int) -> tuple[float, float]:
    """(operations, bytes) of the grouped SwiGLU expert product (its three
    matrix products) over layer calls that put ``held_pairs`` pairs on held
    experts and hit ``experts_hit`` of them in all: 3·2·d·f a pair; the
    bfloat16 weights of each expert hit read once, and each pair's rows read
    and written once (d in, f out, by the gate and by the up product; f in,
    d out, by the down product)."""
    d, f = model["d_model"], model["moe_ff"]
    ops = 3 * 2.0 * d * f * held_pairs
    nbytes = expert_bytes(model) * experts_hit + 2.0 * 3 * (d + f) * held_pairs
    return ops, nbytes


def expert_bound_s(model: dict, held_pairs: int, experts_hit: int) -> float:
    """The least time the grouped expert products of one phase can take on
    the card, its layer calls taken alike: the larger of their bytes over
    the HBM rate and their operations over the bfloat16 peak."""
    ops, nbytes = expert_counts(model, held_pairs, experts_hit)
    return max(nbytes / yardstick.PEAK_HBM_BYTES, ops / yardstick.PEAK_BF16_FLOPS)
