"""Recurrent sequence blocks: the xLSTM's mLSTM and sLSTM, and Mamba2.

Mirrors ``repro/models/ssm.py`` of the reference package. The
parallel-form mLSTM and Mamba2's SSD rest on one primitive, a chunked linear recurrence
(scalar per-(head, t) decay, rank-1 state updates):

    S_t = a_t · S_{t-1} + i_t · k_t v_tᵀ          (state: (dk, dv))
    n_t = a_t · n_{t-1} + i_t · k_t               (optional normalizer)
    y_t = qₜᵀ S_t   [ / max(|qₜᵀ n_t|, 1) ]

computed chunk-parallel: within a chunk through a (c × c) decay-masked
attention matrix, across chunks by a Python loop carrying (S, n) (the
reference's ``lax.scan``). Decays stay in log space and are ≤ 0, so every
exp() of a kept entry is ≤ 1. Every product is float32, as the reference's.
The sLSTM is a per-position recurrence with the xLSTM's max-stabilizer,
run as a Python loop over positions. Mamba2 is a causal depthwise conv
over its (x, B, C) streams and the recurrence without the normalizer, the
state's per-head decay set by dt. Decode forms are the exact O(1)
recurrences and return new states (the reference's copies).

Mamba2's sizes are its own where the config gives them (``mamba_heads``,
``mamba_head_dim``, B and C shared over ``mamba_groups``, a conv bias, the
gated RMSNorm of y·silu(z) before the output projection: the published
layer); by default they are zamba2's (the attention's head count,
``ssm_expand · d_model`` wide, B and C per head, neither extra), computed
as before.

Mamba2 keeps the reference's roundings: the prefill conv is a bfloat16
product and three bfloat16 adds in tap order (the reference's Python
``sum``), the decode conv float32 products summed and rounded once (its
``einsum``, which XLA accumulates in float32); silu is ``x · sigmoid(x)``
and softplus ``logaddexp(x, 0)``, the forms of ``jax.nn``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm.mamba2_step import mamba2_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dt, init_dense

# ---------------------------------------------------------------------------
# Chunked linear recurrence primitive
# ---------------------------------------------------------------------------


def chunk_linear_recurrence(
    q: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    log_a: torch.Tensor,  # (B, S, H) decay, ≤ 0
    gate_i: torch.Tensor,  # (B, S, H) input gate, ≥ 0
    *,
    chunk: int,
    init_state: tuple[torch.Tensor, torch.Tensor] | None = None,
    normalize: bool = False,
    unroll: bool = False,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (y: (B,S,H,dv) float32, final (S_state: (B,H,dk,dv), n: (B,H,dk))).

    ``unroll`` is the reference's ``lax.scan`` flag; the loop here is
    always unrolled, so it changes nothing."""
    del unroll
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, S)
    S_real = S
    if S % c != 0:
        # Pad to a chunk multiple: decay 1 (log_a = 0) and gate 0 make the
        # padded steps exact no-ops on the state; outputs are trimmed.
        pad = c - S % c
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_a, gate_i = (F.pad(t, (0, 0, 0, pad)) for t in (log_a, gate_i))
        S += pad
    f32 = torch.float32
    if init_state is None:
        S_prev = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
        n_prev = torch.zeros((B, H, dk), dtype=f32, device=q.device)
    else:
        S_prev, n_prev = init_state
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    ys = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        qc, kc, vc = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)  # (B, c, H, ·)
        la, gi = log_a[:, sl], gate_i[:, sl]
        cum = torch.cumsum(la, dim=1)  # (B, c, H) inclusive log-decay products
        # Decay from s to t (applying a_{s+1..t}) is exp(cum_t − cum_s), s ≤ t.
        # The entries above the diagonal are masked to −inf before the exp:
        # the reference's where(tri, exp(d), 0) gives the same values, but
        # its exp overflows there once a chunk's decay passes e^88 (Mamba2's
        # dt·A over 256 positions), and the backward's 0 · inf is NaN.
        d_ts = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s, H)
        D = torch.exp(d_ts.masked_fill(~tri, -math.inf)) * gi[:, None, :, :]
        scores = torch.einsum("bthd,bshd->btsh", qc, kc)
        w = scores * D  # (B, t, s, H)
        y_intra = torch.einsum("btsh,bshv->bthv", w, vc)
        carry_decay = torch.exp(cum)  # (B, c, H): decay from chunk start to t
        y_inter = torch.einsum("bthd,bhdv->bthv", qc * carry_decay[..., None], S_prev)
        y = y_intra + y_inter
        if normalize:
            n_intra = torch.einsum("btsh,bshd->bthd", D, kc)
            n_t = n_intra + carry_decay[..., None] * n_prev[:, None]
            denom = torch.abs(torch.einsum("bthd,bthd->bth", qc, n_t))
            y = y / torch.clamp(denom, min=1.0)[..., None]
        # State update to chunk end.
        total = cum[:, -1:, :]  # (B, 1, H)
        rem = torch.exp(total - cum) * gi  # (B, s, H): decay from s to chunk end
        S_prev = torch.exp(total[:, 0])[..., None, None] * S_prev + torch.einsum(
            "bshd,bshv->bhdv", kc * rem[..., None], vc)
        n_prev = torch.exp(total[:, 0])[..., None] * n_prev + torch.einsum(
            "bshd,bsh->bhd", kc, rem)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S_real]
    return y, (S_prev, n_prev)


def linear_recurrence_step(q, k, v, log_a, gate_i, state, n_state, *, normalize: bool = False):
    """Exact single-step decode. q/k: (B,H,dk), v: (B,H,dv), gates: (B,H)."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None]
    gi = gate_i.to(f32)
    kf = k.to(f32)
    kv = kf[..., :, None] * v.to(f32)[..., None, :]
    state = a[..., None] * state + gi[..., None, None] * kv
    n_state = a * n_state + gi[..., None] * kf
    qf = q.to(f32)
    y = torch.einsum("bhd,bhdv->bhv", qf, state)
    if normalize:
        denom = torch.abs(torch.einsum("bhd,bhd->bh", qf, n_state))
        y = y / torch.clamp(denom, min=1.0)[..., None]
    return y, state, n_state


def mamba2_recurrence_step(q, k, v, log_a, gate_i, state, n_state, out=None):
    """Mamba2's exact single-step decode (no normalizer) with q and k (C and
    B) by group: (B, G, N), head h reads group h // (H / G). On a CUDA
    state the hand-written kernel
    (:func:`~repro_torch.kernels.ssm.mamba2_step.mamba2_step`, one streaming
    pass that may update the state in place); on any other device
    :func:`linear_recurrence_step` on q and k repeated per head, which the
    kernel's S' and n' equal bit for bit. ``out``, where given, is an
    (S', n') pair of destinations, each the state's own tensor or apart
    from it; the new state is written there and returned."""
    if state.is_cuda:
        return mamba2_step(q, k, v, log_a, gate_i, state, n_state, out=out)
    rep = state.shape[1] // k.shape[1]
    y, state, n_state = linear_recurrence_step(q.repeat_interleave(rep, dim=1),
                                               k.repeat_interleave(rep, dim=1), v, log_a,
                                               gate_i, state, n_state)
    if out is not None:
        state, n_state = out[0].copy_(state), out[1].copy_(n_state)
    return y, state, n_state


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, device=None):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    dtype, dev = dt(cfg), device or gen.device
    return {
        "w_up": init_dense(gen, d, di, dtype, dev),
        "w_qkv": init_dense(gen, di, 3 * di, dtype, dev),
        "w_if": init_dense(gen, di, 2 * cfg.n_heads, dtype, dev),
        # Input-gate biases 0, forget-gate biases 3 (a forget gate near 0.95).
        "b_if": torch.cat([torch.zeros((cfg.n_heads,), device=dev),
                           torch.full((cfg.n_heads,), 3.0, device=dev)]).to(dtype),
        "w_og": init_dense(gen, d, di, dtype, dev),
        "w_down": init_dense(gen, di, d, dtype, dev),
    }


def mlstm_logical_axes(cfg: ModelConfig):
    return {
        "w_up": ("embed", "ff"),
        "w_qkv": ("ff", None),
        "w_if": ("ff", None),
        "b_if": (None,),
        "w_og": ("embed", "ff"),
        "w_down": ("ff", "embed"),
    }


def _mlstm_gates(params, cfg: ModelConfig, h):
    """(input gate, log forget gate), float32, from ``h @ w_if + b_if`` in
    the model's dtype."""
    H = cfg.n_heads
    gf = h @ params["w_if"] + params["b_if"]
    i_t = torch.sigmoid(gf[..., :H].to(torch.float32))
    log_f = F.logsigmoid(gf[..., H:].to(torch.float32))
    return i_t, log_f


def _query_scale(hd: int, dtype: torch.dtype) -> float:
    """√hd as the reference divides by it: a Python scalar in a JAX
    expression takes the array's dtype, so a bfloat16 model divides by √hd
    rounded to bfloat16 (22.625 for hd = 512)."""
    return float(torch.tensor(math.sqrt(hd), dtype=dtype))


def _mlstm_qkv(params, cfg: ModelConfig, h, lead: tuple[int, ...]):
    """q (scaled), k, v of the up-projected ``h``, each (*lead, H, hd)."""
    H = cfg.n_heads
    hd = cfg.ssm_expand * cfg.d_model // H
    q, k, v = torch.chunk(h @ params["w_qkv"], 3, dim=-1)
    q = q.reshape(*lead, H, hd) / _query_scale(hd, q.dtype)
    return q, k.reshape(*lead, H, hd), v.reshape(*lead, H, hd)


def mlstm_block(params, cfg: ModelConfig, x, state=None):
    """x: (B, S, d). Returns (y, new_state)."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    h = x @ params["w_up"]
    q, k, v = _mlstm_qkv(params, cfg, h, (B, S))
    i_t, log_f = _mlstm_gates(params, cfg, h)
    y, new_state = chunk_linear_recurrence(
        q, k, v, log_f, i_t, chunk=cfg.ssm_chunk, init_state=state, normalize=True,
        unroll=cfg.scan_unroll)
    og = torch.sigmoid((x @ params["w_og"]).to(torch.float32))
    out = (y.reshape(B, S, di) * og).to(x.dtype)
    return out @ params["w_down"], new_state


def mlstm_decode_step(params, cfg: ModelConfig, x, state):
    """x: (B, 1, d); state: (S_state, n_state)."""
    B, _, d = x.shape
    di = cfg.ssm_expand * d
    h = (x @ params["w_up"])[:, 0]
    q, k, v = _mlstm_qkv(params, cfg, h, (B,))
    i_t, log_f = _mlstm_gates(params, cfg, h)
    S_state, n_state = state
    y, S_state, n_state = linear_recurrence_step(q, k, v, log_f, i_t, S_state, n_state,
                                                 normalize=True)
    og = torch.sigmoid((x[:, 0] @ params["w_og"]).to(torch.float32))
    out = (y.reshape(B, di) * og).to(x.dtype) @ params["w_down"]
    return out[:, None], (S_state, n_state)


def mlstm_state_init(cfg: ModelConfig, B: int, device=None):
    H = cfg.n_heads
    hd = cfg.ssm_expand * cfg.d_model // H
    return (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((B, H, hd), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM) — sequential scalar-memory recurrence
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig, device=None):
    d = cfg.d_model
    dtype, dev = dt(cfg), device or gen.device
    return {
        "w_x": init_dense(gen, d, 4 * d, dtype, dev),  # z, i, f, o pre-acts
        "r_h": init_dense(gen, d, 4 * d, dtype, dev, scale=1.0 / math.sqrt(d) * 0.5),
        "b": torch.zeros((4 * d,), dtype=dtype, device=dev),
        "w_down": init_dense(gen, d, d, dtype, dev),
    }


def slstm_logical_axes(cfg: ModelConfig):
    return {
        "w_x": ("embed", None),
        "r_h": ("embed", None),
        "b": (None,),
        "w_down": ("embed", None),
    }


def _slstm_cell(params, xw_t, st):
    """One stabilized sLSTM step. xw_t: (B, 4d) precomputed x-projection.
    The pre-activation is two adds in the model's dtype, then float32; the
    carried ``h`` goes back to the model's dtype, the returned one stays
    float32."""
    h, c, n, m = st
    pre = xw_t + h @ params["r_h"] + params["b"]
    z, it, ft, ot = torch.chunk(pre.to(torch.float32), 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(ot)
    log_f_m = F.logsigmoid(ft) + m
    m_new = torch.maximum(log_f_m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f_m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h_new = o * c / torch.clamp(n, min=1.0)
    return (h_new.to(xw_t.dtype), c, n, m_new), h_new


def slstm_block(params, cfg: ModelConfig, x, state=None):
    """x: (B, S, d). Returns (y, new_state); one cell step per position."""
    B, S, _ = x.shape
    xw = x @ params["w_x"]  # (B, S, 4d)
    st = state if state is not None else slstm_state_init(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        st, h = _slstm_cell(params, xw[:, t], st)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)  # (B, S, d)
    return y @ params["w_down"], st


def slstm_decode_step(params, cfg: ModelConfig, x, state):
    xw = (x @ params["w_x"])[:, 0]
    st, h = _slstm_cell(params, xw, state)
    return (h.to(x.dtype) @ params["w_down"])[:, None], st


def slstm_state_init(cfg: ModelConfig, B: int, device=None):
    """(h, c, n, m): h in the model's dtype, the rest float32, the
    stabilizer m at −30."""
    def zeros(dtype=torch.float32):
        return torch.zeros((B, cfg.d_model), dtype=dtype, device=device)

    return (zeros(dt(cfg)), zeros(), zeros(), zeros() - 30.0)


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------


def _silu_f32(x):
    """``jax.nn.silu`` of ``x`` in float32, in its form ``x · sigmoid(x)``
    (``F.silu`` rounds otherwise in a quarter of float32 inputs)."""
    x = x.to(torch.float32)
    return x * torch.sigmoid(x)


def _softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, device=None):
    """w_in, conv (normal × 0.1 in the model's dtype), then w_out from
    ``gen``; A_log and dt_bias float32 zeros (A = −exp(A_log) = −1), D
    float32 ones; where the config has them, a zero conv bias ``b_conv``
    and the gated norm's zero ``norm`` scale, drawing nothing."""
    d = cfg.d_model
    di, N, H, G = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    dtype, dev = dt(cfg), device or gen.device
    # joint projection: [x (di), z (di), B (G·N), C (G·N), dt (H)]
    w_in = init_dense(gen, d, 2 * di + 2 * G * N + H, dtype, dev)
    conv = torch.randn((cfg.ssm_conv, di + 2 * G * N), generator=gen, dtype=torch.float32,
                       device=dev)
    p = {
        "w_in": w_in,
        "conv": (conv * 0.1).to(dtype),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "w_out": init_dense(gen, di, d, dtype, dev),
    }
    if cfg.ssm_conv_bias:
        p["b_conv"] = torch.zeros((di + 2 * G * N,), dtype=dtype, device=dev)
    if cfg.ssm_gated_norm:
        p["norm"] = {"scale": torch.zeros((di,), dtype=dtype, device=dev)}
    return p


def mamba2_logical_axes(cfg: ModelConfig):
    return {
        "w_in": ("embed", "ff"),
        "conv": (None, "ff"),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "w_out": ("ff", "embed"),
    }


def _mamba2_split(cfg: ModelConfig, proj):
    """(x, z, B, C, dt) of the joint input projection, along its last axis."""
    di, GN = cfg.ssm_inner, cfg.ssm_state * cfg.ssm_groups
    return torch.split(proj, [di, di, GN, GN, cfg.ssm_heads], dim=-1)


def causal_conv(xbc_pad, conv_w, S: int):
    """The prefill's causal depthwise conv, as the reference sums it:
    ``sum(xbc_pad[:, i:i+S] * conv_w[i] for i in taps)``, each product and
    each add rounded in the inputs' dtype, taps in order."""
    return sum(xbc_pad[:, i:i + S] * conv_w[i] for i in range(conv_w.shape[0]))


def decode_conv(window, conv_w, bias=None):
    """The decode step's conv over a (B, K, dconv) window, as the reference's
    ``einsum("bkc,kc->bc")`` computes it: float32 products summed over the
    taps (and the bias, where one is given), rounded once to the inputs'
    dtype."""
    out = (window.to(torch.float32) * conv_w.to(torch.float32)).sum(dim=1)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(window.dtype)


def _per_head(t, cfg: ModelConfig, lead: tuple[int, ...]):
    """B or C of (*lead, G·N) or (*lead, G, N) → (*lead, H, N): head i reads
    group i // (H / G)."""
    H, G = cfg.ssm_heads, cfg.ssm_groups
    t = t.reshape(*lead, G, cfg.ssm_state)
    return t if G == H else t.repeat_interleave(H // G, dim=-2)


def _mamba2_heads(params, cfg: ModelConfig, xbc_conv, dt_, lead: tuple[int, ...], dtype):
    """silu of the conv output → (x as v: (*lead, H, P), B, C by group:
    (*lead, G, N), log decay and dt: (*lead, H), float32)."""
    di, GN = cfg.ssm_inner, cfg.ssm_state * cfg.ssm_groups
    xbc_conv = _silu_f32(xbc_conv).to(dtype)
    x_c, B_c, C_c = torch.split(xbc_conv, [di, GN, GN], dim=-1)
    dt_v = _softplus(dt_.to(torch.float32) + params["dt_bias"])
    log_a = dt_v * -torch.exp(params["A_log"])  # ≤ 0
    G, N = cfg.ssm_groups, cfg.ssm_state
    return (x_c.reshape(*lead, cfg.ssm_heads, cfg.ssm_head_dim), B_c.unflatten(-1, (G, N)),
            C_c.unflatten(-1, (G, N)), log_a, dt_v)


def _mamba2_out(params, cfg: ModelConfig, y, v, z, dtype):
    """(y + v·D) · silu(z), float32, flattened over the heads, with the
    gated norm where the config has it (RMSNorm over each of G groups of
    channels, times 1 + scale), cast once to ``dtype``."""
    y = y + v.to(torch.float32) * params["D"][:, None]
    g = y.flatten(-2) * _silu_f32(z)
    if cfg.ssm_gated_norm:
        gs = g.unflatten(-1, (cfg.ssm_groups, -1))
        gs = gs * torch.rsqrt(torch.mean(gs * gs, dim=-1, keepdim=True) + cfg.norm_eps)
        g = gs.flatten(-2) * (1.0 + params["norm"]["scale"].to(torch.float32))
    return g.to(dtype)


def mamba2_block(params, cfg: ModelConfig, x, state=None):
    """x: (B, S, d); state: (conv_buf (B, conv − 1, dconv), S_state, n).
    Returns (y, new state); the new conv buffer is the last conv − 1
    positions of the raw (x, B, C) streams, ``None`` when S < conv − 1, as
    the reference's."""
    B, S, _ = x.shape
    K = cfg.ssm_conv
    x_in, z, Bv, Cv, dt_ = _mamba2_split(cfg, x @ params["w_in"])
    xbc = torch.cat([x_in, Bv, Cv], dim=-1)  # (B, S, dconv)
    if state is not None:
        xbc_pad = torch.cat([state[0], xbc], dim=1)
    else:
        xbc_pad = F.pad(xbc, (0, 0, K - 1, 0))
    xbc_conv = causal_conv(xbc_pad, params["conv"], S)
    if cfg.ssm_conv_bias:
        xbc_conv = xbc_conv + params["b_conv"]
    v, B_c, C_c, log_a, dt_v = _mamba2_heads(params, cfg, xbc_conv, dt_, (B, S), x.dtype)
    y, (S_new, n_new) = chunk_linear_recurrence(
        _per_head(C_c, cfg, (B, S)), _per_head(B_c, cfg, (B, S)), v, log_a, dt_v,
        chunk=cfg.ssm_chunk,
        init_state=None if state is None else (state[1], state[2]), normalize=False,
        unroll=cfg.scan_unroll)
    y = _mamba2_out(params, cfg, y, v, z, x.dtype)
    new_conv_buf = xbc[:, S - (K - 1):] if S >= K - 1 else None
    return y @ params["w_out"], (new_conv_buf, S_new, n_new)


def mamba2_decode_step(params, cfg: ModelConfig, x, state, out=None):
    """x: (B, 1, d); state: (conv_buf, S_state, n). Returns ((B, 1, d), new
    state). Raises ``ValueError`` for a ``None`` conv buffer (a prefill of
    fewer than conv − 1 positions), where the reference fails in its
    concatenate.

    The recurrence is :func:`mamba2_recurrence_step`: on a card one
    hand-written kernel that streams the float32 state once, elsewhere
    :func:`linear_recurrence_step`. ``out``, where given, is a (conv_buf,
    S_state, n) of destinations of the state's shapes (a layer's slots of a
    cache stack, say), each the state's own tensor or apart from it; the
    new state is written there (S and n, on a card, by the kernel itself)
    and returned."""
    B = x.shape[0]
    conv_buf, S_state, n_state = state
    if conv_buf is None:
        raise ValueError(
            f"Mamba2 decode needs a conv buffer of {cfg.ssm_conv - 1} positions; a prefill "
            f"of fewer than ssm_conv - 1 = {cfg.ssm_conv - 1} tokens leaves none")
    x_in, z, Bv, Cv, dt_ = _mamba2_split(cfg, (x @ params["w_in"])[:, 0])
    xbc = torch.cat([x_in, Bv, Cv], dim=-1)[:, None]  # (B, 1, dconv)
    window = torch.cat([conv_buf, xbc], dim=1)  # (B, K, dconv)
    conv = decode_conv(window, params["conv"], params["b_conv"] if cfg.ssm_conv_bias else None)
    v, B_c, C_c, log_a, dt_v = _mamba2_heads(params, cfg, conv, dt_, (B,), x.dtype)
    y, S_state, n_state = mamba2_recurrence_step(C_c, B_c, v, log_a, dt_v, S_state, n_state,
                                                 out=None if out is None else out[1:])
    y = _mamba2_out(params, cfg, y, v, z, x.dtype)
    conv_buf = window[:, 1:]
    if out is not None:
        conv_buf = out[0].copy_(conv_buf)
    return (y @ params["w_out"])[:, None], (conv_buf, S_state, n_state)


def mamba2_state_init(cfg: ModelConfig, B: int, device=None):
    """(conv buffer in the model's dtype, S state, n state float32), zeros."""
    di, N, H = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    return (torch.zeros((B, cfg.ssm_conv - 1, di + 2 * cfg.ssm_groups * N), dtype=dt(cfg),
                        device=device),
            torch.zeros((B, H, N, cfg.ssm_head_dim), dtype=torch.float32, device=device),
            torch.zeros((B, H, N), dtype=torch.float32, device=device))
