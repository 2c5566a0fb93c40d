"""Shared neural building blocks: plain functions on tensors, mirroring the
reference package's ``repro/models/layers.py``.

Conventions:
  * params are nested dicts of tensors; init functions take a
    ``torch.Generator`` and shapes, and make the weights on ``device``
    (default: the generator's; ``"meta"`` gives shapes without storage,
    drawn from a CPU generator).
    Init keeps the reference's distributions, not its values: parameters
    that must equal the reference's are carried across through numpy
    (:func:`repro_torch.models.params_from_numpy`).
  * activations flow as (batch, seq, d_model) in ``cfg.dtype``; norms and
    softmax accumulate in float32, with the reference's casts at the same
    places.
  * attention is GQA with chunked online softmax for prefill (the
    reference's chunk sizes, so float32 sums run in the same order), and
    decode attention over a ring buffer through
    :func:`repro_torch.kernels.attention.decode_attention.decode_attention`
    (a hand-written kernel on a card, the plain version on the CPU).

The ``*_logical_axes`` functions give each parameter's logical axes, as
the reference's, for the sharding plan (:mod:`repro_torch.models.sharding`,
:mod:`repro_torch.launch`). The reference's sharding constraints are not
called in the forward passes: the port's models run on one card, where
they are identities (:func:`repro_torch.models.sharding.constrain`,
:func:`use_weight`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention import decode_attention as attn_kernel
from repro_torch.kernels.attention.decode_attention import MASKED, tanh_cap as _softcap
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import constrain

#: ``slot_pos`` of an empty cache slot and ``kpos`` of a padded key.
EMPTY_POS = -(2**30)


def dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype, device=None,
               scale: float | None = None):
    """A (d_in, d_out) normal draw times ``scale`` (default 1/√d_in)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    # gemma-style (1 + scale); scale initialized to zeros.
    return (normed * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         inv_freq: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). The head splits
    into halves (not interleaved pairs); angles are float32. ``inv_freq``
    (head_dim / 2 float32 frequencies, as :func:`yarn_inv_freq` gives them)
    replaces theta^(−2i / head_dim)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = inv_freq if inv_freq is not None else torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device) * (math.log(theta) / half))
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]  # (..., seq, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature factor: 0.1 · mscale · ln(factor) + 1, or
    1 where the context is not stretched."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(cfg: ModelConfig, dim: int, device) -> torch.Tensor:
    """YaRN's (dim / 2) float32 rotary frequencies (arXiv:2309.00071, as
    DeepSeek-V3 configures them): theta^(−2i / dim) for the fast dimensions
    (i below the correction range, those that turn more than beta_fast
    times over the original context), that divided by ``yarn_factor`` for
    the slow ones (above it, fewer than beta_slow turns), and a linear ramp
    between. Made on the device from ``arange``, so a captured step copies
    nothing from the host."""
    theta, orig = cfg.rope_theta, cfg.yarn_original

    def dim_of(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(dim_of(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(dim_of(cfg.yarn_beta_slow)), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    extra = torch.exp(i * (-2 * math.log(theta) / dim))
    ramp = ((i - low) / max(high - low, 1e-3)).clamp_(0.0, 1.0)
    return extra * (1.0 - ramp * (1.0 - 1.0 / cfg.yarn_factor))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, device=None):
    d, hd, dtype = cfg.d_model, cfg.hd, dt(cfg)
    p = {
        "wq": init_dense(gen, d, cfg.n_heads * hd, dtype, device),
        "wk": init_dense(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": init_dense(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": init_dense(gen, cfg.n_heads * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((width * hd,), dtype=dtype, device=device or gen.device)
    return p


def attention_logical_axes(cfg: ModelConfig):
    p = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        p.update({"bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)})
    return p


def use_weight(cfg: ModelConfig, w, *axes):
    """The reference's ``weight_gather`` lever constrains a stored
    (FSDP-sharded) weight to its compute layout right before the
    contraction; on one card that is the identity
    (:func:`repro_torch.models.sharding.constrain`)."""
    return constrain(w, *axes) if cfg.weight_gather else w


def project_q(params, cfg: ModelConfig, x, positions):
    """The (B, S, H, hd) queries of ``x``, roped unless ``cfg.use_rope`` is
    off."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    return rope(q, positions, cfg.rope_theta) if cfg.use_rope else q


def project_kv(params, cfg: ModelConfig, x, positions):
    """The (B, S, Hkv, hd) keys, roped unless ``cfg.use_rope`` is off, and
    the values of ``x``."""
    B, S, _ = x.shape
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return (rope(k, positions, cfg.rope_theta) if cfg.use_rope else k), v


def _project_qkv(params, cfg: ModelConfig, x, positions):
    return (project_q(params, cfg, x, positions), *project_kv(params, cfg, x, positions))


def _block_attn(q, k, v, qpos, kpos, scale, softcap, causal, window):
    """One (q-chunk × kv-chunk) block. q: (B,qc,Hkv,G,hd), k/v: (B,kc,Hkv,hd).

    Returns (o (B,qc,Hkv,G,hd) in v's dtype, row max, row sum), the block's
    terms of the online softmax. Scores are float32 (products of the inputs
    summed in float32, as the reference's ``preferred_element_type``).

    Without autograd (``inference_mode``, ``no_grad``) the score block is
    scaled, masked and exponentiated in place; with it, out of place, since
    autograd keeps the scores for the max's and exp's backward. The values
    are the same either way.
    """
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32), k.to(torch.float32))
    dqk = qpos[:, None] - kpos[None, :]  # (qc, kc)
    mask = (kpos >= 0)[None, :]  # padded kv positions carry kpos < 0
    if causal:
        mask = mask & (dqk >= 0)
    if window is not None:
        mask = mask & (dqk < window)
    if torch.is_grad_enabled():
        s = _softcap(s * scale, softcap).masked_fill(~mask, MASKED)
        m = torch.amax(s, dim=-1)  # (B,Hkv,G,qc)
        p = torch.exp(s - m[..., None])
    else:
        s = _softcap(s.mul_(scale), softcap).masked_fill_(~mask, MASKED)
        m = torch.amax(s, dim=-1)
        p = s.sub_(m[..., None]).exp_()
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o, m, l


def chunked_attention(
    cfg: ModelConfig,
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    *,
    window: int | None,
    softcap: float | None,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash-style online-softmax attention over q and kv chunks of
    ``cfg.attn_q_chunk`` × ``cfg.attn_kv_chunk``, in the reference's order;
    causal unless ``causal=False`` (the encoder, cross-attention), the
    queries at positions ``q_offset + i``.

    With ``window`` set, only the banded kv range [q_hi − window − qc, q_hi)
    is visited per q-chunk, making SWA linear in sequence length.
    """
    B, Sq, H, hd = q.shape
    Sq_real = Sq
    Skv = k.shape[1]
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qc = min(cfg.attn_q_chunk, Sq)
    kc = min(cfg.attn_kv_chunk, Skv)
    dev = q.device
    if Sq % qc != 0:  # pad queries; outputs trimmed at the end
        pad = qc * -(-Sq // qc) - Sq
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        Sq += pad
    kpos_all = torch.arange(Skv, device=dev)
    if Skv % kc != 0:  # pad keys; kpos < 0 masks them out in _block_attn
        pad = kc * -(-Skv // kc) - Skv
        k, v = F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos_all = torch.cat([kpos_all, torch.full((pad,), EMPTY_POS, device=dev)])
        Skv += pad
    nq = Sq // qc
    q = q.reshape(B, nq, qc, Hkv, G, hd)
    band = window is not None and window + qc < Skv
    # Banded SWA: slice [hi − (window + qc) … hi) of kv per q-chunk.
    span_k = -(-(window + qc) // kc) * kc if band else Skv

    outs = []
    for qi in range(nq):
        qblk = q[:, qi]
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        if band:
            hi = q_offset + (qi + 1) * qc
            start = min(max(hi - span_k, 0), Skv - span_k)
            kblk_all = k[:, start:start + span_k]
            vblk_all = v[:, start:start + span_k]
            kpos_band = start + torch.arange(span_k, device=dev)
        else:
            kblk_all, vblk_all, kpos_band = k, v, kpos_all

        o_acc = torch.zeros((B, qc, Hkv, G, hd), dtype=torch.float32, device=dev)
        m_acc = torch.full((B, Hkv, G, qc), MASKED, dtype=torch.float32, device=dev)
        l_acc = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=dev)
        for ki in range(span_k // kc):
            sl = slice(ki * kc, (ki + 1) * kc)
            o, m, l = _block_attn(qblk, kblk_all[:, sl], vblk_all[:, sl], qpos, kpos_band[sl],
                                  scale, softcap, causal, window)
            m_new = torch.maximum(m_acc, m)
            c_old = torch.exp(m_acc - m_new)
            c_new = torch.exp(m - m_new)
            l_acc = l_acc * c_old + l * c_new
            o_acc = (o_acc * c_old.permute(0, 3, 1, 2)[..., None]
                     + o * c_new.permute(0, 3, 1, 2)[..., None])
            m_acc = m_new
        out = o_acc / torch.clamp(l_acc.permute(0, 3, 1, 2)[..., None], min=1e-30)
        outs.append(out.to(v.dtype))
    # (B, nq, qc, Hkv, G, hd) → (B, Sq, H, hd), trimmed of q padding
    out = torch.stack(outs, dim=1).reshape(B, Sq, H, hd)
    return out[:, :Sq_real]


def attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    positions: torch.Tensor | None = None,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention sublayer for train and prefill. x: (B, S, d) → (out, k, v),
    with the (B, S, Hkv, hd) keys and values it attended to, for prefill
    to cache. ``kv_override`` gives cross-attention's keys and values (the
    whisper decoder's, over the encoder memory) in place of ``x``'s."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q = project_q(params, cfg, x, positions)
    k, v = kv_override if kv_override is not None else project_kv(params, cfg, x, positions)
    out = chunked_attention(cfg, q, k, v, window=window, softcap=cfg.attn_softcap,
                            causal=causal)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ params["wo"], k, v


def decode_attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (B, Smax, Hkv, hd) — ring buffer when Smax < ctx
    cache_v: torch.Tensor,
    slot_pos: torch.Tensor,  # (Smax,) int32 absolute position per slot (EMPTY_POS = empty)
    pos: torch.Tensor,  # 0-d int32: position of the new token
    *,
    window: int | None = None,
) -> torch.Tensor:
    """One decode step with a (possibly ring-buffer) KV cache: the
    sublayer's (B, 1, d) output.

    The new token is written at slot ``pos % Smax`` of ``cache_k``,
    ``cache_v`` and ``slot_pos`` IN PLACE (the reference returns updated
    copies; the values are the same); masking uses per-slot absolute positions, so a
    sliding-window cache of size ``window`` supports unbounded contexts.
    ``pos`` stays on the device: no host sync.
    """
    B = x.shape[0]
    hd = cfg.hd
    positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    Smax = cache_k.shape[1]
    slot = torch.remainder(pos, Smax).reshape(1).to(torch.int64)
    cache_k.index_copy_(1, slot, k_new)
    cache_v.index_copy_(1, slot, v_new)
    slot_pos.index_copy_(0, slot, pos.reshape(1).to(slot_pos.dtype))
    o = attn_kernel.decode_attention(q.reshape(B, cfg.n_heads, hd), cache_k, cache_v, slot_pos,
                                     pos, window=window, softcap=cfg.attn_softcap)
    return o.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]


def fill_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, sp: torch.Tensor):
    """Arrange the last Smax of (B, S, Hkv, hd) prefill K/V into the ring
    slots of an empty (B, Smax, Hkv, hd) cache (zeros, ``sp`` all EMPTY_POS,
    as :func:`repro_torch.models.lm.init_cache` makes it), in place."""
    S, Smax = k.shape[1], ck.shape[1]
    take = min(S, Smax)
    positions = torch.arange(S - take, S, device=k.device)
    slots = torch.remainder(positions, Smax)
    ck[:, slots] = k[:, S - take:]
    cv[:, slots] = v[:, S - take:]
    sp[slots] = positions.to(torch.int32)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device=None):
    d_ff = cfg.d_ff
    p = {
        "wi": init_dense(gen, cfg.d_model, d_ff, dt(cfg), device),
        "wo": init_dense(gen, d_ff, cfg.d_model, dt(cfg), device),
    }
    if cfg.glu:
        p["wg"] = init_dense(gen, cfg.d_model, d_ff, dt(cfg), device)
    return p


def mlp_logical_axes(cfg: ModelConfig):
    p = {"wi": ("embed", "ff"), "wo": ("ff", "embed")}
    if cfg.glu:
        p["wg"] = ("embed", "ff")
    return p


def _act(cfg: ModelConfig, x):
    if cfg.mlp_act == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form
    if cfg.mlp_act == "relu2":
        return torch.square(F.relu(x))
    return F.silu(x)


def mlp(params, cfg: ModelConfig, x):
    h = x @ params["wi"]
    if cfg.glu:
        h = _act(cfg, x @ params["wg"]) * h
    else:
        h = _act(cfg, h)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig, device=None):
    table = torch.randn((cfg.vocab, cfg.d_model), generator=gen, dtype=torch.float32,
                        device=device or gen.device)
    return {"embed": table.to(dt(cfg)),
            "head": init_dense(gen, cfg.d_model, cfg.vocab, dt(cfg), device)}


def embedding_logical_axes(cfg: ModelConfig):
    return {"embed": ("vocab", "embed"), "head": ("embed", "vocab")}


def embed(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens.to(torch.int64)].to(dt(cfg))
    return x * math.sqrt(cfg.d_model) if cfg.embed_scale else x


def logits(params, cfg: ModelConfig, x):
    out = x @ params["head"]
    return _softcap(out.to(torch.float32), cfg.logit_softcap)


def cross_entropy(logit, labels):
    """Mean next-token CE. logit: (B,S,V) float32, labels: (B,S) int32."""
    lse = torch.logsumexp(logit, dim=-1)
    gold = torch.gather(logit, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - gold)
