"""A plain float32 PyTorch DeepSeek-V3: the reference the served tokens are
judged against.

Written from the published description (DeepSeek-V3, arXiv:2412.19437;
DeepSeek-V2's MLA, arXiv:2405.04434; YaRN, arXiv:2309.00071; the model's
config.json) with the departures the configuration file lists under
``departures`` and nothing else. It imports neither the port nor JAX: only
``torch``. It runs the whole sequence at once, with no cache: attention in
MLA's decompressed form, per head, over every earlier position, the
queries taken in blocks so that a long row fits; every product and sum in
float32 with TF32 off, layer by layer, each layer's weights read from the
shared bf16 tensors and widened to float32 as the layer runs.

x is the residual stream, d wide; every layer is x += MLA(RMSNorm(x)),
then x += FFN(RMSNorm(x)), RMSNorm(x) = x / rms(x) · (1 + scale):

* MLA: q = RMSNorm(h W_qa) W_qb, per head [q_nope (nope), q_pe (rope)];
  [c, k_pe] = h W_kva, c_kv = RMSNorm(c); per head [k_nope, v] = c_kv W_kvb;
  q_pe and k_pe (one for all heads) rotated by YaRN's frequencies (the
  published ``DeepseekV3YarnRotaryEmbedding``, its dimensions in halves);
  scores q·k over nope + rope channels times mscale² / √(nope + rope),
  mscale = 0.1 · mscale_all_dim · ln(factor) + 1; causal softmax; the
  heads' P v through W_o;
* FFN in the first ``dense_layers`` layers: silu(h W_g) · (h W_i) W_o, d_ff
  wide;
* FFN in the others: s = sigmoid(h W_r) over all the router's experts; a
  group's score is the sum of its two best s + b_corr; the top
  ``topk_group`` of ``n_group`` groups stay, and the chosen are the top K
  of s + b_corr within them; each weighted by s over the sum of the chosen
  s, times ``routed_scale``; x += Σ over the chosen that this chip holds
  (experts ``expert_first`` .. + ``n_experts``) of w_e · SwiGLU_e(h), plus
  the shared SwiGLU expert: the same share of the layer the program
  computes.

The logits are RMSNorm(x) W_head; the embedding is not scaled.
``precision="fp8"`` is the control, the reference computed a step below the
model's bfloat16 where a faster program would take it: every product with a
weight matrix takes its operands rounded to float8 e4m3 (per row of the
activations and per column of the weights, scaled to the format's largest
value), as float8 GEMMs would take them; the rest stays float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

F8_MAX = 448.0
#: queries a block of the attention: (rows, heads, block, T) float32 scores
Q_BLOCK = 256


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


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def _inv_freq(m: dict, device) -> torch.Tensor:
    """The published YaRN frequencies of the rope_dim rotary channels."""
    dim, base = m["mla_rope_dim"], m["rope_theta"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / base ** exps
    factor = m.get("yarn_factor") or 0.0
    if not factor:
        return freq_extra
    freq_inter = 1.0 / (factor * base ** exps)

    def correction_dim(rotations):
        return (dim * math.log(m["yarn_original"] / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(m["yarn_beta_fast"])), 0)
    high = min(math.ceil(correction_dim(m["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extrapolate = 1.0 - ramp
    return freq_inter * (1 - extrapolate) + freq_extra * extrapolate


def _rotate(x: torch.Tensor, m: dict) -> torch.Tensor:
    """x (B, T, ..., rope) rotated at positions 0..T−1, halves as pairs."""
    T, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * _inv_freq(m, x.device)
    factor = m.get("yarn_factor") or 0.0
    ms = _yarn_mscale(factor, m.get("yarn_mscale", 1.0)) / _yarn_mscale(
        factor, m.get("yarn_mscale_all_dim", 0.0))
    shape = (1, T) + (1,) * (x.dim() - 3) + (half,)
    cos, sin = (torch.cos(ang) * ms).view(shape), (torch.sin(ang) * ms).view(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _mla(p, m: dict, h: torch.Tensor, ops: _Ops, eps: float) -> torch.Tensor:
    Bsz, T, _ = h.shape
    H, dn, dr, dv, kvr = (m["n_heads"], m["mla_nope_dim"], m["mla_rope_dim"], m["mla_v_dim"],
                          m["mla_kv_rank"])
    q = ops.mm(_rmsnorm(ops.mm(h, p["wq_a"]), p["q_norm"]["scale"], eps), p["wq_b"])
    q = q.view(Bsz, T, H, dn + dr)
    ckv = ops.mm(h, p["wkv_a"])
    c_kv = _rmsnorm(ckv[..., :kvr], p["kv_norm"]["scale"], eps)
    k_pe = _rotate(ckv[..., kvr:], m)  # (B, T, rope), one for all heads
    kv = ops.mm(c_kv, p["wkv_b"]).view(Bsz, T, H, dn + dv)
    q = torch.cat([q[..., :dn], _rotate(q[..., dn:], m)], -1)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(Bsz, T, H, dr)], -1)
    v = kv[..., dn:]
    ms = _yarn_mscale(m.get("yarn_factor") or 0.0, m.get("yarn_mscale_all_dim", 0.0))
    scale = ms * ms / math.sqrt(dn + dr)
    out = torch.empty((Bsz, T, H, dv), dtype=torch.float32, device=h.device)
    for lo in range(0, T, Q_BLOCK):
        hi = min(lo + Q_BLOCK, T)
        s = torch.einsum("bthd,bshd->bhts", q[:, lo:hi], k) * scale
        future = torch.arange(T, device=h.device)[None, :] > torch.arange(
            lo, hi, device=h.device)[:, None]
        s = s.masked_fill(future, -math.inf)
        out[:, lo:hi] = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    return ops.mm(out.reshape(Bsz, T, H * dv), p["wo"])


def _swiglu(p, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    g = ops.mm(h, p["wg"])
    return ops.mm(g * torch.sigmoid(g) * ops.mm(h, p["wi"]), p["wo"])


def _route(p, m: dict, hf: torch.Tensor, ops: _Ops):
    """(chosen expert ids (T, K), their weights (T, K))."""
    s = torch.sigmoid(ops.mm(hf, p["router"]))
    choice = s + p["b_corr"].float()
    G = m.get("n_group", 1)
    if G > 1:
        T, R = choice.shape
        grouped = choice.view(T, G, R // G)
        group_score = grouped.topk(2, dim=-1).values.sum(-1)
        top = group_score.topk(m["topk_group"], dim=-1).indices
        keep = torch.zeros((T, G), dtype=torch.bool, device=hf.device).scatter(1, top, True)
        choice = grouped.masked_fill(~keep[..., None], -math.inf).view(T, R)
    ids = torch.topk(choice, m["top_k"], dim=-1).indices
    w = torch.gather(s, -1, ids)
    return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * m["routed_scale"]


def _moe(p, m: dict, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    Bsz, T, d = h.shape
    hf = h.reshape(Bsz * T, d)
    ids, w = _route(p, m, hf, ops)
    out = _swiglu(p["shared"], hf, ops)
    for e in range(m["n_experts"]):
        tok, choice = torch.nonzero(ids == m.get("expert_first", 0) + e, as_tuple=True)
        if tok.numel():
            y = _swiglu({"wg": p["wg"][e], "wi": p["wi"][e], "wo": p["wo"][e]}, hf[tok], ops)
            out = out.index_add(0, tok, y * w[tok, choice, None])
    return out.view(Bsz, T, d)


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
    n_dense = m["dense_layers"]
    with _no_tf32():
        emb = params["embedding"]
        x = emb["embed"][tokens.long()].float()
        for i in range(m["n_layers"]):
            dense = i < n_dense
            p = _layer(params["dense"] if dense else params["moe"], i if dense else i - n_dense)
            x = x + _mla(p["attn"], m, _rmsnorm(x, p["ln1"]["scale"], eps), ops, eps)
            h = _rmsnorm(x, p["ln2"]["scale"], eps)
            x = x + (_swiglu(p["mlp"], h, ops) if dense else _moe(p["moe"], m, h, ops))
        x = _rmsnorm(x[:, positions], params["ln_f"]["scale"], eps)
        return ops.mm(x, emb["head"])
