"""Mixture-of-Experts MLP: token-choice top-k routing with per-row capacity.

Mirrors the reference package's ``repro/models/moe.py``, its slot dispatch
included:
  * tokens are grouped by batch row; each (token, choice) takes the next
    slot of its expert in its row (a cumsum over the row), and per-row
    expert capacity is C = ceil(cf · S · top_k / E) for training, C = S
    (dropless) for prefill and decode; a choice past C goes to a discarded
    slot and contributes nothing (its token keeps the residual path);
  * the router is float32 (``x.float() @ router``, softmax, top-k);
  * the expert FFNs are one batched product over (E, B·C) slots, summed in
    float32 with float32 outputs (the reference's
    ``preferred_element_type=float32``), and the combine gathers each
    choice's slot in float32, weights it by its renormalised top-k weight
    times ``keep``, and sums over the K choices.

The slots live in one flat (E·B·C + 1, d) buffer — expert-major, then row,
then slot — whose last row is the discarded slot, so the kept slots are a
contiguous (E, B·C, d) view for the products. Each kept slot is written
exactly once, so a copy gives the reference's scatter-add values.

Returns (output, aux load-balancing loss). Dropless dispatch materialises
every expert's S slots per row — (B, E, S, d) inputs and float32
(B, E, S, d_ff) hidden states — as the reference does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.products import bmm_f32
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _act, dt


def init_moe(gen: torch.Generator, cfg: ModelConfig, device):
    """The router (float32, as the reference's, whatever ``cfg.dtype``) and
    the (E, d_in, d_out) expert stacks, drawn in the reference's order on
    ``device``."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale = 1.0 / math.sqrt(d)

    def draw(shape, dtype):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    p = {
        "router": draw((d, E), torch.float32),
        "wi": draw((E, d, f), dt(cfg)),
        "wo": draw((E, f, d), dt(cfg)),
    }
    if cfg.glu:
        p["wg"] = draw((E, d, f), dt(cfg))
    return p


def moe_logical_axes(cfg: ModelConfig):
    p = {
        "router": ("embed", None),
        "wi": ("experts", "embed", "ff"),
        "wo": ("experts", "ff", "embed"),
    }
    if cfg.glu:
        p["wg"] = ("experts", "embed", "ff")
    return p


def route(params, cfg: ModelConfig, x: torch.Tensor, C: int):
    """The router's decisions for x: (B, S, d) at per-row capacity C:
    (probs (B, S, E) float32, top-k weights renormalised and ids (B, S, K),
    each choice's slot in its expert within its row (B, S·K), keep = slot
    < C)."""
    E, K = cfg.n_experts, cfg.top_k
    gates = x.to(torch.float32) @ params["router"]  # (B, S, E)
    probs = torch.softmax(gates, dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    flat_i = topi.reshape(x.shape[0], -1)  # (B, T'), T' = S·K
    onehot = torch.nn.functional.one_hot(flat_i, E).to(torch.int32)  # (B, T', E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos_in_e = torch.gather(pos, 2, flat_i[..., None])[..., 0]
    return probs, topw, topi, pos_in_e, pos_in_e < C


def moe_mlp(params, cfg: ModelConfig, x: torch.Tensor, *, dropless: bool = False):
    """x: (B, S, d) → ((B, S, d), float32 aux loss). ``dropless`` sizes the
    per-row capacity at C = S, so no choice is dropped (prefill and decode;
    a decode step can never drop, so prefill must not either)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = S if dropless else max(1, int(math.ceil(cfg.capacity_factor * S * K / E)))
    probs, topw, topi, pos_in_e, keep = route(params, cfg, x, C)

    # Aux load-balancing loss (GShard §2.2): E · Σ_e f_e · p̄_e.
    me = torch.mean(probs, dim=(0, 1))
    fe = torch.mean(torch.nn.functional.one_hot(topi[..., 0], E).to(torch.float32), dim=(0, 1))
    aux = E * torch.sum(fe * me)

    rows = torch.arange(B, device=x.device)[:, None]
    # Flat slot index: expert-major, then row, then slot; E·B·C is discarded.
    flat_i = topi.reshape(B, S * K)
    idx = torch.where(keep, (flat_i * B + rows) * C + pos_in_e, E * B * C).reshape(-1)

    xt = torch.repeat_interleave(x, K, dim=1).reshape(B * S * K, d)  # token per choice
    slots = torch.zeros((E * B * C + 1, d), dtype=x.dtype, device=x.device)
    slots = slots.index_copy(0, idx, xt)
    buf = slots[:-1].view(E, B * C, d)

    h = bmm_f32(buf, params["wi"])  # (E, B·C, f) float32
    if cfg.glu:
        h = _act(cfg, bmm_f32(buf, params["wg"])) * h
    else:
        h = _act(cfg, h)
    y = bmm_f32(h.to(x.dtype), params["wo"])  # (E, B·C, d) float32

    # Combine in float32: each choice's slot (the discarded one reads a zero
    # row), weighted, summed over K.
    y = torch.cat([y.reshape(E * B * C, d), y.new_zeros((1, d))])
    w = (topw.reshape(B * S * K) * keep.reshape(-1))[:, None]
    out = (y[idx] * w).reshape(B, S, K, d).sum(dim=2).to(x.dtype)
    return out, aux


# ---------------------------------------------------------------------------
# Expert-parallel layer with sort-based dispatch (nemotron_h, deepseek_v3)
# ---------------------------------------------------------------------------
#
# The router scores all ``cfg.n_router`` experts; this chip holds experts
# [expert_first, expert_first + n_experts) and computes their part of the
# result, plus the shared expert, which every chip computes alike. The
# (token, choice) pairs are sorted by held expert (pairs on experts held
# elsewhere last) and each held expert's rows run through one grouped
# product: B·S·K rows whatever the routing, per-expert ends kept on the
# device, so the shapes are static and the step can be captured.

#: what the layer counts into a ``counters`` tensor, in order: routed
#: (token, choice) pairs, pairs on held experts, held experts hit, the most
#: loaded held expert's pairs, and layer calls
COUNTERS = ("routed_pairs", "held_pairs", "held_experts_hit", "peak_expert_pairs",
            "layer_steps")


def init_routed_moe(gen: torch.Generator, cfg: ModelConfig, device):
    """The float32 router over all ``cfg.n_router`` experts and its zero
    correction bias ``b_corr``, the held experts' (E, d, f) and (E, f, d)
    stacks (f = ``cfg.expert_ff``; with ``cfg.glu`` a gate stack ``wg``
    beside ``wi``), and the shared expert (``cfg.shared_expert_ff`` wide,
    gated alike), drawn on ``device``."""
    E, R, d, f = cfg.n_experts, cfg.n_router, cfg.d_model, cfg.expert_ff

    def draw(shape, dtype):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w / math.sqrt(shape[-2])).to(dtype)

    fs = cfg.shared_expert_ff
    p = {
        "router": draw((d, R), torch.float32),
        "b_corr": torch.zeros((R,), dtype=torch.float32, device=device),
        "wi": draw((E, d, f), dt(cfg)),
        "wo": draw((E, f, d), dt(cfg)),
        "shared": {"wi": draw((d, fs), dt(cfg)), "wo": draw((fs, d), dt(cfg))},
    }
    if cfg.glu:
        p["wg"] = draw((E, d, f), dt(cfg))
        p["shared"]["wg"] = draw((d, fs), dt(cfg))
    return p


def route_sigmoid(params, cfg: ModelConfig, x: torch.Tensor):
    """x: (T, d) → (expert ids (T, K) over the router's width, weights (T, K)
    float32): the top K of sigmoid(x·router) + b_corr, weighted by their
    sigmoid scores over the scores' sum, times ``cfg.routed_scale``. With
    ``cfg.n_group`` > 1 the top K come from the token's ``cfg.topk_group``
    groups (of n_router / n_group consecutive experts) whose two best
    scores + b_corr sum highest; the other groups' experts are out of the
    choice (−inf)."""
    scores = torch.sigmoid(x.to(torch.float32) @ params["router"])
    choice = scores + params["b_corr"]
    if cfg.n_group > 1:
        T, R = choice.shape
        grouped = choice.view(T, cfg.n_group, R // cfg.n_group)
        best = grouped.topk(2, dim=-1).values.sum(-1)  # (T, n_group)
        keep = torch.zeros_like(best, dtype=torch.bool).scatter_(
            1, torch.topk(best, cfg.topk_group, dim=-1).indices, True)
        choice = grouped.masked_fill(~keep[..., None], -math.inf).view(T, R)
    ids = torch.topk(choice, cfg.top_k, dim=-1).indices
    w = torch.gather(scores, -1, ids)
    return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale


def grouped_mm(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Rows ``ends[e-1]:ends[e]`` of ``a`` (M, k) times ``b[e]`` (E, k, n),
    for each e; the rows past ``ends[-1]`` are left unwritten. On the card
    one grouped GEMM (``torch._grouped_mm``, bfloat16, float32 sums); on
    the CPU a product per expert (the ends come to the host)."""
    if a.is_cuda:
        return torch._grouped_mm(a, b, offs=ends)
    out = a.new_empty((a.shape[0], b.shape[-1]))
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        out[lo:hi] = a[lo:hi] @ b[e]
        lo = hi
    return out


def held_experts(params, cfg: ModelConfig, x: torch.Tensor, counters=None) -> torch.Tensor:
    """x: (T, d) → the held experts' part of the layer, (T, d) float32: the
    weighted sum over the token's choices that land on a held expert. Each
    layer call adds its :data:`COUNTERS` to ``counters`` (an int64 tensor
    of that length) on the device."""
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    ids, w = route_sigmoid(params, cfg, x)
    local = (ids - cfg.expert_first).reshape(-1)  # (T·K,) pairs, token-major
    key = torch.where((local >= 0) & (local < E), local, E)  # E: held elsewhere
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.int64, device=x.device).scatter_add_(
        0, key, torch.ones_like(key))
    ends = torch.cumsum(counts[:E], 0, dtype=torch.int32)
    rows = x.index_select(0, order // K)  # (T·K, d): each pair's token, by expert
    h = grouped_mm(rows, params["wi"], ends).to(torch.float32)
    if cfg.glu:
        h = _act(cfg, grouped_mm(rows, params["wg"], ends).to(torch.float32)) * h
    else:
        h = _act(cfg, h)
    h = h.to(x.dtype)
    y = grouped_mm(h, params["wo"], ends)
    held = (key.index_select(0, order) < E)[:, None]
    y = torch.where(held, y.to(torch.float32) * w.reshape(-1).index_select(0, order)[:, None],
                    0.0)
    # back to pair order (a permutation), then each token's K choices summed
    out = torch.empty_like(y).index_copy_(0, order, y).reshape(T, K, d).sum(dim=1)
    if counters is not None:
        c = counts[:E]
        counters.add_(torch.stack([counts.sum(), c.sum(), (c > 0).sum(), c.max(),
                                   torch.ones_like(c[0])]))
    return out


def shared_expert(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (T, d) → the shared expert's (T, d) float32 output."""
    p = params["shared"]
    h = (x @ p["wi"]).to(torch.float32)
    if cfg.glu:
        h = _act(cfg, (x @ p["wg"]).to(torch.float32)) * h
    else:
        h = _act(cfg, h)
    h = h.to(x.dtype)
    return (h @ p["wo"]).to(torch.float32)


def routed_moe(params, cfg: ModelConfig, x: torch.Tensor, counters=None) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d): the held experts' part plus the shared
    expert's, summed in float32 and cast once."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    out = held_experts(params, cfg, xt, counters) + shared_expert(params, cfg, xt)
    return out.to(x.dtype).reshape(B, S, d)
