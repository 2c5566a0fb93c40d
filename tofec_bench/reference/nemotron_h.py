"""A plain float32 PyTorch Nemotron-H (NVIDIA Nemotron-3-Nano): the reference
the served tokens are judged against.

Written from the published description (Nemotron-H, arXiv:2504.03624; the
model's config.json; Mamba2's SSD, arXiv:2405.21060) with the departures
the configuration file lists under ``departures`` and nothing else. It
imports neither the port nor JAX: only ``torch``. It runs the whole
sequence at once (no cache, no chunking, no batching tricks), every product
and sum in float32 with TF32 off, layer by layer, each layer's weights read
from the shared bf16 tensors and widened to float32 as the layer runs.

x is the residual stream, d wide; in every layer h = RMSNorm(x) · (1 +
scale) and, by ``layer_pattern``:

* M: [x_in (d_in), z (d_in), B (G·N), C (G·N), dt (H)] = h W_in, d_in =
  H·P; xBC = silu(causal depthwise conv(concat(x_in, B, C)) + b_conv); head
  i reads B and C of group i // (H / G); Δ = softplus(dt + dt_bias), A =
  −exp(A_log), y_t = Σ_{s≤t} exp(A·Σ_{r=s+1..t} Δ_r) · Δ_s · (C_t · B_s) ·
  x_s + D · x_t (decay sums as segment sums); g = y · silu(z), RMSNorm over
  each of G groups of d_in / G channels, times 1 + scale; x += g W_out;
* E: s = sigmoid(h W_r) over all the router's experts; the chosen are the
  top K of s + b_corr, weighted by s over the sum of the chosen s, times
  ``routed_scale``; x += Σ over the chosen that this chip holds (experts
  ``expert_first`` .. + ``n_experts``) of w_e · relu(h U_e)² D_e, plus the
  shared expert relu(h U_s)² D_s: the same share of the layer the program
  computes;
* ``*``: causal GQA over the whole prefix, no position embedding.

The logits are RMSNorm(x) W_head; the embedding is not scaled.
``precision="fp8"`` is the control, the reference computed a step below the
model's bfloat16 where a faster program would take it: every matrix
product's operands rounded to float8 e4m3 (per row of the activations and
per column of the weights, scaled to the format's largest value), as
float8 GEMMs would take them; the rest stays float32.
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


def _relu2(x):
    return torch.relu(x) ** 2


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) → (..., T, T): [t, s] = Σ_{r=s+1..t} a_r for s ≤ t, −inf above."""
    T = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, T)  # [r, s] = a_r
    strict = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~strict, 0.0), dim=-2)
    return x.masked_fill(~torch.ones_like(strict).tril(), -math.inf)


def _mamba2(p, m: dict, h: torch.Tensor, ops: _Ops, eps: float) -> torch.Tensor:
    Bsz, T, _ = h.shape
    H, P, G, N, K = (m["mamba_heads"], m["mamba_head_dim"], m["mamba_groups"], m["ssm_state"],
                     m["ssm_conv"])
    di = H * P
    x_in, z, Bm, Cm, dt = torch.split(ops.mm(h, p["w_in"]), [di, di, G * N, G * N, H], -1)
    xbc = torch.cat([x_in, Bm, Cm], -1)
    w = p["conv"].float()  # (K, channels)
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = _silu(sum(pad[:, j:j + T] * w[j] for j in range(K)) + p["b_conv"].float())
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], -1)
    xs = xs.view(Bsz, T, H, P)
    Bm = Bm.view(Bsz, T, G, N).repeat_interleave(H // G, dim=2)
    Cm = Cm.view(Bsz, T, G, N).repeat_interleave(H // G, dim=2)
    delta = F.softplus(dt + p["dt_bias"].float())  # (B, T, H)
    la = (delta * -torch.exp(p["A_log"].float())).transpose(1, 2)  # (B, H, T)
    W = torch.einsum("bthn,bshn->bhts", Cm, Bm) * torch.exp(_segsum(la))
    W = W * delta.transpose(1, 2)[:, :, None, :]
    y = torch.einsum("bhts,bshp->bthp", W, xs) + xs * p["D"].float()[:, None]
    g = (y.reshape(Bsz, T, di) * _silu(z)).view(Bsz, T, G, di // G)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + eps)
    g = g.reshape(Bsz, T, di) * (1.0 + p["norm"]["scale"].float())
    return ops.mm(g, p["w_out"])


def _moe(p, m: dict, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    Bsz, T, d = h.shape
    hf = h.reshape(Bsz * T, d)
    s = torch.sigmoid(ops.mm(hf, p["router"]))
    ids = torch.topk(s + p["b_corr"].float(), m["top_k"], dim=-1).indices
    w = torch.gather(s, -1, ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * m["routed_scale"]
    out = ops.mm(_relu2(ops.mm(hf, p["shared"]["wi"])), p["shared"]["wo"])
    for e in range(m["n_experts"]):
        tok, choice = torch.nonzero(ids == m.get("expert_first", 0) + e, as_tuple=True)
        if tok.numel():
            y = ops.mm(_relu2(ops.mm(hf[tok], p["wi"][e])), p["wo"][e])
            out = out.index_add(0, tok, y * w[tok, choice, None])
    return out.view(Bsz, T, d)


def _attention(p, m: dict, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    Bsz, T, _ = h.shape
    Hq, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = ops.mm(h, p["wq"]).view(Bsz, T, Hq, hd)
    k = ops.mm(h, p["wk"]).view(Bsz, T, Hkv, hd).repeat_interleave(Hq // Hkv, dim=2)
    v = ops.mm(h, p["wv"]).view(Bsz, T, Hkv, hd).repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, -math.inf)
    o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v).reshape(Bsz, T, Hq * hd)
    return ops.mm(o, p["wo"])


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _layer(stack: dict, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


@torch.no_grad()
def logits(params, config: dict, tokens: torch.Tensor, positions: list[int], *,
           precision: str = "fp32") -> torch.Tensor:
    """(B, len(positions), vocab) float32 logits of ``tokens`` (B, T) at the
    given positions, each predicting the token after it."""
    m = config["model"]
    eps = m["norm_eps"]
    ops = _Ops(precision)
    kinds = {"M": ("mamba", "mixer"), "E": ("moe", "moe"), "*": ("attn", "attn")}
    seen = dict.fromkeys(kinds, 0)
    with _no_tf32():
        emb = params["embedding"]
        x = emb["embed"][tokens.long()].float()
        for c in m["layer_pattern"]:
            stack, body = kinds[c]
            p = _layer(params[stack], seen[c])
            seen[c] += 1
            h = _rmsnorm(x, p["ln"]["scale"], eps)
            if c == "M":
                x = x + _mamba2(p[body], m, h, ops, eps)
            elif c == "E":
                x = x + _moe(p[body], m, h, ops)
            else:
                x = x + _attention(p[body], m, h, ops)
        x = _rmsnorm(x[:, positions], params["ln_f"]["scale"], eps)
        return ops.mm(x, emb["head"])
