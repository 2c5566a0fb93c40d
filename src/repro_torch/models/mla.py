"""Multi-head latent attention (MLA, DeepSeek-V2/V3: arXiv:2405.04434,
arXiv:2412.19437) over a per-token latent cache shared by all heads.

With H heads, each of ``mla_nope_dim`` + ``mla_rope_dim`` query and key
channels and ``mla_v_dim`` value channels, and the latent ``mla_kv_rank``
wide:

* q = RMSNorm(x W_qa) W_qb, per head [q_nope, q_pe];
* [c, k_pe] = x W_kva; c_kv = RMSNorm(c) is the latent, k_pe one roped key
  part shared by every head; per head [k_nope, v] = c_kv W_kvb;
* q_pe and k_pe roped with YaRN's frequencies
  (:func:`repro_torch.models.layers.yarn_inv_freq`), halves not pairs;
* softmax scale 1/√(nope + rope) · mscale², mscale YaRN's temperature
  factor at ``yarn_mscale_all_dim``; the output is o W_o.

Only [c_kv, k_pe] is cached: ``mla_kv_rank + mla_rope_dim`` values a token
and layer, whatever the heads. Prefill computes the attention in its
decompressed form, the per-head K = [c_kv W_UK, k_pe] and V = c_kv W_UV,
in one fused causal attention (:func:`attend`); a decode step in its
absorbed form, where W_UK and W_UV (W_kvb's key and value columns) move to
the query and the output: q_lat = q_nope W_UKᵀ, scores against the cached
[c_kv, k_pe], P c_kv, then W_UV and W_o. Scores and softmax are float32 in
both forms; the products take bfloat16 operands with float32 sums on the
card (:func:`repro_torch.kernels.products.bmm_f32`). The decode step's attention
body, from the scores through P c_kv, is one hand-written kernel on the card
(:func:`repro_torch.kernels.attention.latent_attention.latent_attention`),
which reads the bfloat16 cache in place, once, and writes no score tensor.

W_kvb is kept (kv_rank, H · (nope + v)): a plain product for the prefill,
and for the decode its per-head blocks are strided views the batched
products take as they are.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from repro_torch.kernels.attention.latent_attention import latent_attention
from repro_torch.kernels.products import bmm_f32
from repro_torch.models import layers as ly
from repro_torch.models.config import ModelConfig


def init_mla(gen: torch.Generator, cfg: ModelConfig, device):
    """The projections, each (d_in, d_out) normal / √d_in, and the two
    low-rank norms."""
    d, H, dtype = cfg.d_model, cfg.n_heads, ly.dt(cfg)
    qr, kvr = cfg.mla_q_rank, cfg.mla_kv_rank
    dn, dr, dv = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    return {
        "wq_a": ly.init_dense(gen, d, qr, dtype, device),
        "q_norm": ly.init_rmsnorm(qr, dtype, device or gen.device),
        "wq_b": ly.init_dense(gen, qr, H * (dn + dr), dtype, device),
        "wkv_a": ly.init_dense(gen, d, kvr + dr, dtype, device),
        "kv_norm": ly.init_rmsnorm(kvr, dtype, device or gen.device),
        "wkv_b": ly.init_dense(gen, kvr, H * (dn + dv), dtype, device),
        "wo": ly.init_dense(gen, H * dv, d, dtype, device),
    }


def latent_width(cfg: ModelConfig) -> int:
    """The cache's width a token and layer: [c_kv, k_pe]."""
    return cfg.mla_kv_rank + cfg.mla_rope_dim


def softmax_scale(cfg: ModelConfig) -> float:
    m = ly.yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return m * m / math.sqrt(cfg.mla_nope_dim + cfg.mla_rope_dim)


def _rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x (B, S, heads, rope_dim) roped at ``positions`` (B, S) with YaRN's
    frequencies, times YaRN's mscale / mscale_all_dim ratio."""
    out = ly.rope(x, positions, cfg.rope_theta, ly.yarn_inv_freq(cfg, x.shape[-1], x.device))
    ratio = (ly.yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
             / ly.yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    return out if ratio == 1.0 else (out.to(torch.float32) * ratio).to(x.dtype)


def project(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, d) at ``positions`` (B, S) → (q_nope (B, S, H, nope), roped
    q_pe (B, S, H, rope), the latent [RMSNorm(c), roped k_pe] (B, S,
    kv_rank + rope))."""
    B, S, _ = x.shape
    H, dn, kvr = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_kv_rank
    q = ly.rmsnorm(params["q_norm"], x @ params["wq_a"], eps=cfg.norm_eps) @ params["wq_b"]
    q = q.view(B, S, H, -1)
    kv = x @ params["wkv_a"]
    c_kv = ly.rmsnorm(params["kv_norm"], kv[..., :kvr], eps=cfg.norm_eps)
    k_pe = _rope(cfg, kv[..., None, kvr:], positions)[..., 0, :]
    return q[..., :dn], _rope(cfg, q[..., dn:], positions), torch.cat([c_kv, k_pe], dim=-1)


def prefill(params, cfg: ModelConfig, x: torch.Tensor):
    """Causal MLA over the prompt x (B, S, d), decompressed per head:
    (output (B, S, d), the latent to cache (B, S, kv_rank + rope))."""
    B, S, _ = x.shape
    H, dn, dv, kvr = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_v_dim, cfg.mla_kv_rank
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q_nope, q_pe, latent = project(params, cfg, x, positions)
    kv = (latent[..., :kvr] @ params["wkv_b"]).view(B, S, H, dn + dv)
    k_pe = latent[..., None, kvr:].expand(B, S, H, cfg.mla_rope_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    out = attend(q, k, kv[..., dn:], softmax_scale(cfg))
    return out.reshape(B, S, H * dv) @ params["wo"], latent


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal softmax(q kᵀ · scale) v, q and k (B, S, H, d), v (B, S, H, dv)
    narrower → (B, S, H, dv) in v's dtype, by ``scaled_dot_product_attention``.
    On the card only its fused kernels may take it (cuDNN's or the
    memory-efficient one: online softmax over tiles, scores and softmax
    float32, P rounded to v's dtype for P·V, as in ``chunked_attention``);
    its unfused fallback would hold every head's (S, S) scores at once, so
    the call fails instead. Elsewhere the library picks."""
    fused = (sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION])
             if q.is_cuda else contextlib.nullcontext())
    with fused:
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), is_causal=True, scale=scale)
    return out.transpose(1, 2)


def absorbed_attention(params, cfg: ModelConfig, q_nope: torch.Tensor, q_pe: torch.Tensor,
                       latent: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One query a row, absorbed: q_nope (B, H, nope) and roped q_pe (B, H,
    rope) against the cached latent (B, Smax, kv_rank + rope) at slots
    0..``pos`` (0-d int32, on the latent's device) → (B, H, v) float32,
    before W_o."""
    H, dn, kvr = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_kv_rank
    w = params["wkv_b"].view(kvr, H, -1)
    w_uk = w[:, :, :dn].permute(1, 2, 0)  # (H, nope, kv_rank)
    w_uv = w[:, :, dn:].transpose(0, 1)  # (H, kv_rank, v)
    q_lat = bmm_f32(q_nope.transpose(0, 1), w_uk).to(latent.dtype).transpose(0, 1)
    q = torch.cat([q_lat, q_pe.to(latent.dtype)], dim=-1)
    o_lat = latent_attention(q, latent, pos, softmax_scale(cfg), value_width=kvr)
    return bmm_f32(o_lat.transpose(0, 1), w_uv).transpose(0, 1)


def decode(params, cfg: ModelConfig, x: torch.Tensor, latent: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """One decode step: x (B, 1, d) at position ``pos`` (0-d int32, on the
    device) → the sublayer's (B, 1, d) output. The token's latent is
    written at slot ``pos`` of ``latent`` (B, Smax, kv_rank + rope) IN
    PLACE; the step attends to slots 0..pos. No host sync."""
    B = x.shape[0]
    positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
    q_nope, q_pe, new = project(params, cfg, x, positions)
    latent.index_copy_(1, pos.reshape(1).to(torch.int64), new)
    o = absorbed_attention(params, cfg, q_nope[:, 0], q_pe[:, 0], latent, pos)
    return o.reshape(B, 1, -1).to(x.dtype) @ params["wo"]
