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


class _BmmF32(torch.autograd.Function):
    """Batched product of low-precision CUDA operands with float32 outputs
    at tensor-core speed (``torch.bmm(..., out_dtype=torch.float32)``,
    which has no autograd formula of its own); the backward's products run
    in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2), g)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) → float32 (E, M, N), products summed in
    float32. On the card, bfloat16 operands stay bfloat16 (tensor cores);
    on the CPU they are widened first. ``meta`` tensors take the card's
    branch, so a work count on ``meta`` (:mod:`repro_torch.launch`) counts
    the card's operations."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda or a.is_meta:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


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
