"""A plain float32 PyTorch zamba2: the reference the served tokens are
judged against.

Written from the published description (Zamba2, arXiv:2411.15242; Mamba2's
SSD, arXiv:2405.21060) with the departures the configuration file lists
under ``departures`` and nothing else. It imports neither the port nor JAX:
only ``torch``. It runs the whole sequence at once (no cache, no chunking,
no batching tricks), every product and sum in float32 with TF32 off, layer
by layer, each layer's weights read from the shared bf16 tensors and
widened to float32 as the layer runs.

Per layer i (x is the residual stream, d wide):

* h = RMSNorm(x) · (1 + scale);  [x_in, z, B, C, dt] = h W_in;
* xBC = silu(causal depthwise conv(concat(x_in, B, C))) over ``ssm_conv``
  taps, no bias;
* per head: Δ = softplus(dt + dt_bias), A = −exp(A_log), and the SSD
  y_t = Σ_{s≤t} exp(A·Σ_{r=s+1..t} Δ_r) · Δ_s · (C_t · B_s) · x_s + D · x_t,
  its decay sums taken as segment sums (never as differences of one long
  cumulative sum, which lose digits over a long sequence);
* x += (y · silu(z)) W_out;
* after every ``attn_every``-th layer, the one shared block:
  x += Attn(RMSNorm(x)) with RoPE (halves, θ = ``rope_theta``), causal
  within ``local_window``; x += (silu(h W_g) ⊙ h W_i) W_o on h = RMSNorm(x).

The logits are RMSNorm(x) W_head. ``precision="fp8"`` is the control, the
reference computed a step below the model's bfloat16 where a faster
program would take it: every matrix product's operands rounded to float8
e4m3 (per row of the activations and per column of the weights, scaled to
the format's largest value), as float8 GEMMs would take them; the rest
stays float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

F8_MAX = 448.0


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        if self.fp8:
            return _q8(x, -1) @ _q8(w, 0)
        return x @ w


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def _silu(x):
    return x * torch.sigmoid(x)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) → (..., T, T): [t, s] = Σ_{r=s+1..t} a_r for s ≤ t, −inf above."""
    T = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, T)  # [r, s] = a_r
    strict = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~strict, 0.0), dim=-2)
    return x.masked_fill(~torch.ones_like(strict).tril(), -math.inf)


def _mamba2(p, m: dict, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    Bsz, T, d = h.shape
    H, N, K = m["n_heads"], m["ssm_state"], m["ssm_conv"]
    di = m["ssm_expand"] * d
    P = di // H
    x_in, z, Bm, Cm, dt = torch.split(ops.mm(h, p["w_in"]), [di, di, H * N, H * N, H], -1)
    xbc = torch.cat([x_in, Bm, Cm], -1)
    w = p["conv"].float()  # (K, channels)
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = _silu(sum(pad[:, j:j + T] * w[j] for j in range(K)))
    xs, Bm, Cm = torch.split(xbc, [di, H * N, H * N], -1)
    xs, Bm, Cm = xs.view(Bsz, T, H, P), Bm.view(Bsz, T, H, N), Cm.view(Bsz, T, H, N)
    delta = F.softplus(dt + p["dt_bias"].float())  # (B, T, H)
    la = (delta * -torch.exp(p["A_log"].float())).transpose(1, 2)  # (B, H, T)
    W = torch.einsum("bthn,bshn->bhts", Cm, Bm) * torch.exp(_segsum(la))
    W = W * delta.transpose(1, 2)[:, :, None, :]
    y = torch.einsum("bhts,bshp->bthp", W, xs) + xs * p["D"].float()[:, None]
    return ops.mm((y.reshape(Bsz, T, di) * _silu(z)), p["w_out"])


def _rope(x, theta: float):
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _shared(p, m: dict, x, ops: _Ops, eps: float):
    Bsz, T, d = x.shape
    Hq, Hkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // Hq
    h = _rmsnorm(x, p["ln1"]["scale"], eps)
    a = p["attn"]
    q = _rope(ops.mm(h, a["wq"]).view(Bsz, T, Hq, hd), m["rope_theta"])
    k = _rope(ops.mm(h, a["wk"]).view(Bsz, T, Hkv, hd), m["rope_theta"])
    v = ops.mm(h, a["wv"]).view(Bsz, T, Hkv, hd)
    k = k.repeat_interleave(Hq // Hkv, dim=2)
    v = v.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    t = torch.arange(T, device=x.device)
    lag = t[:, None] - t[None, :]
    s = s.masked_fill(~((lag >= 0) & (lag < m["local_window"])), -math.inf)
    o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v).reshape(Bsz, T, Hq * hd)
    x = x + ops.mm(o, a["wo"])
    h = _rmsnorm(x, p["ln2"]["scale"], eps)
    mlp = p["mlp"]
    act = _silu(ops.mm(h, mlp["wg"])) if m.get("mlp_act", "silu") == "silu" else \
        F.gelu(ops.mm(h, mlp["wg"]), approximate="tanh")
    return x + ops.mm(act * ops.mm(h, mlp["wi"]), mlp["wo"])


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def logits(params, config: dict, tokens: torch.Tensor, positions: list[int], *,
           precision: str = "fp32") -> torch.Tensor:
    """(B, len(positions), vocab) float32 logits of ``tokens`` (B, T) at the
    given positions, each predicting the token after it."""
    m, eps = config["model"], config["norm_eps"]
    ops = _Ops(precision)
    with _no_tf32():
        emb = params["embedding"]
        x = emb["embed"][tokens.long()].float() * math.sqrt(m["d_model"])
        lay = params["layers"]
        for i in range(m["n_layers"]):
            p = {name: t[i] for name, t in lay["mamba"].items()}
            x = x + _mamba2(p, m, _rmsnorm(x, lay["ln"]["scale"][i], eps), ops)
            if m.get("attn_every") and (i + 1) % m["attn_every"] == 0:
                x = _shared(params["shared"], m, x, ops, eps)
        x = _rmsnorm(x[:, positions], params["ln_f"]["scale"], eps)
        return ops.mm(x, emb["head"])
