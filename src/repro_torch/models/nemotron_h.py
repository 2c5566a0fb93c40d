"""Nemotron-H hybrid (NVIDIA Nemotron-3-Nano): Mamba2, expert and attention
layers in one published order, each a pre-norm residual block.

``cfg.layer_pattern`` gives one character per layer: ``M`` a Mamba2 layer
(:func:`repro_torch.models.ssm.mamba2_block` at the config's own heads,
groups of B and C, conv bias and gated norm), ``E`` an expert layer
(:func:`repro_torch.models.moe.routed_moe`: sigmoid routing over the
router's width, the held experts' part by sort-based dispatch, and a shared
expert), ``*`` causal GQA over the whole prefix with no position embedding.
In every layer x += layer(RMSNorm(x)); the logits are RMSNorm(x) W_head.

The parameters are stacked by kind, in each kind's order of appearance:
``{"embedding", "mamba": {"ln", "mixer"}, "moe": {"ln", "moe"}, "attn":
{"ln", "attn"}, "ln_f"}``. The serving cache holds both kinds of state side
by side: ``{"mamba": (conv_buf, S, n)`` stacked over the Mamba2 layers,
``"k", "v", "slot_pos"`` over the attention layers only (``max_seq``
positions each), ``"pos"``, and ``"counters"``, an int64 tensor of
:data:`COUNTERS` that the expert layers add to on the device in prefill and
in every decode step}. The decode step meets :mod:`~repro_torch.models.
hybrid`'s capture contract (:data:`CUDA_GRAPH_DECODE`). Prefill takes
``marks``, a list to which it appends a point on the device's stream after
each layer (:data:`PREFILL_MARKS`), so a caller can read each kind's device
time once the work is done, with no sync of its own. Serving only: the
family has no training loss and no sharding plan.
"""

from __future__ import annotations

import time

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _init_layers, _unstack, init_generator

#: The decode step may be captured as a CUDA graph and replayed (see
#: :data:`repro_torch.models.hybrid.CUDA_GRAPH_DECODE`).
CUDA_GRAPH_DECODE = True
#: ``prefill`` takes ``marks`` (see the module's docstring).
PREFILL_MARKS = True
#: The names of the cache's ``"counters"``, in order.
COUNTERS = moe.COUNTERS
#: The hand-written kernels its decode step launches (see
#: :data:`repro_torch.models.hybrid.DECODE_KERNELS`).
DECODE_KERNELS = ssm.DECODE_KERNELS
#: layer kinds by their pattern character
KINDS = {"M": "mamba", "E": "moe", "*": "attn"}


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(kind, index among the layers of that kind) of each layer, in
    order."""
    if len(cfg.layer_pattern) != cfg.n_layers or set(cfg.layer_pattern) - set(KINDS):
        raise ValueError(f"{cfg.name}: layer_pattern {cfg.layer_pattern!r} must give one of "
                         f"{''.join(KINDS)} for each of the {cfg.n_layers} layers")
    seen = dict.fromkeys(KINDS.values(), 0)
    out = []
    for c in cfg.layer_pattern:
        kind = KINDS[c]
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def _count(cfg: ModelConfig, kind: str) -> int:
    return sum(k == kind for k, _ in layer_kinds(cfg))


def _norm(p, cfg: ModelConfig, x):
    return ly.rmsnorm(p, x, eps=cfg.norm_eps)


#: each kind's block beside its norm: (its key in the block, its init)
_BODIES = {"mamba": ("mixer", ssm.init_mamba2), "moe": ("moe", moe.init_routed_moe),
           "attn": ("attn", ly.init_attention)}


def _init_kind(kind: str):
    key, init_body = _BODIES[kind]

    def block(gen, cfg, dev):
        return {"ln": ly.init_rmsnorm(cfg.d_model, ly.dt(cfg), dev), key: init_body(gen, cfg, dev)}
    return block


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """Random parameters from ``generator`` on its device; without one, from
    seed 0 on ``device`` (default: the card; ``"meta"`` gives shapes and
    dtypes without storage): the embedding, then each kind's stack."""
    generator, dev = init_generator(generator, device)
    params = {"embedding": ly.init_embedding(generator, cfg, dev)}
    for kind in KINDS.values():
        params[kind] = _init_layers(generator, cfg, dev, init_block=_init_kind(kind),
                                    n=_count(cfg, kind))
    params["ln_f"] = ly.init_rmsnorm(cfg.d_model, ly.dt(cfg), dev)
    return params


def train_loss(params, cfg: ModelConfig, batch):
    raise NotImplementedError(f"{cfg.name}: the nemotron_h family is served only")


# -- serving ------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None):
    """Zero Mamba2 states for every Mamba2 layer, an empty KV cache of
    ``max_seq`` positions for every attention layer, zero counters."""
    n_attn = _count(cfg, "attn")
    dev = resolve_device(device)
    state = ssm.mamba2_state_init(cfg, B, device="meta")
    kv = (n_attn, B, max_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "mamba": tuple(torch.zeros((_count(cfg, "mamba"), *t.shape), dtype=t.dtype, device=dev)
                       for t in state),
        "k": torch.zeros(kv, dtype=ly.dt(cfg), device=dev),
        "v": torch.zeros(kv, dtype=ly.dt(cfg), device=dev),
        "slot_pos": torch.full((n_attn, max_seq), ly.EMPTY_POS, dtype=torch.int32, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "counters": torch.zeros((len(COUNTERS),), dtype=torch.int64, device=dev),
    }


def _mark(device: torch.device):
    """A point on the device's stream (a recorded CUDA event), or the host
    clock on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _stacks(params, cfg: ModelConfig) -> dict:
    return {kind: _unstack(params[kind], _count(cfg, kind)) for kind in KINDS.values()}


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int | None = None, marks=None):
    """Run the prompt through every layer from empty states: (last-token
    logits, primed cache). A prompt shorter than ssm_conv − 1 leaves the
    cache's conv buffer ``None`` and a decode step from it raises, as in
    :mod:`~repro_torch.models.hybrid`. With ``marks`` (a list), appends
    ``("start", mark)`` and then ``(kind, mark)`` after each layer."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or S, device=tokens.device)
    x = ly.embed(params["embedding"], cfg, tokens)
    stacks = _stacks(params, cfg)
    conv_buf = cache["mamba"][0]
    if marks is not None:
        marks.append(("start", _mark(x.device)))
    for kind, j in layer_kinds(cfg):
        p = stacks[kind][j]
        h = _norm(p["ln"], cfg, x)
        if kind == "mamba":
            out, st = ssm.mamba2_block(p["mixer"], cfg, h)
            for dst, src in zip(cache["mamba"], st):
                if src is not None:
                    dst[j].copy_(src)
            if st[0] is None:
                conv_buf = None
        elif kind == "moe":
            out = moe.routed_moe(p["moe"], cfg, h, cache["counters"])
        else:
            out, k, v = ly.attention(p["attn"], cfg, h)
            ly.fill_cache_from_prefill(k, v, cache["k"][j], cache["v"][j], cache["slot_pos"][j])
        x = x + out
        if marks is not None:
            marks.append((kind, _mark(x.device)))
    x = _norm(params["ln_f"], cfg, x)
    last = ly.logits(params["embedding"], cfg, x[:, -1:])
    cache["mamba"] = (conv_buf, *cache["mamba"][1:])
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
    return last, cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache, into=None):
    """token: (B, 1) int32 → (logits (B, 1, V) float32, cache): new Mamba2
    states (in a fresh stack, or in ``into``, a stack of the cache's layout
    that may be the cache's own), each attention layer's k, v and slot_pos
    updated in place, the counters added to in place, ``pos`` advanced on
    the device."""
    if cache["mamba"][0] is None:
        raise ValueError(
            f"{cfg.name}: the cache has no Mamba2 conv buffer (its prefill had fewer than "
            f"ssm_conv - 1 = {cfg.ssm_conv - 1} tokens), so no decode step can follow it")
    x = ly.embed(params["embedding"], cfg, token)
    stacks = _stacks(params, cfg)
    pos = cache["pos"]
    new = tuple(torch.empty_like(t) for t in cache["mamba"]) if into is None else into
    for kind, j in layer_kinds(cfg):
        p = stacks[kind][j]
        h = _norm(p["ln"], cfg, x)
        if kind == "mamba":
            out, _ = ssm.mamba2_decode_step(p["mixer"], cfg, h,
                                            tuple(t[j] for t in cache["mamba"]),
                                            out=tuple(t[j] for t in new))
        elif kind == "moe":
            out = moe.routed_moe(p["moe"], cfg, h, cache["counters"])
        else:
            out = ly.decode_attention(p["attn"], cfg, h, cache["k"][j], cache["v"][j],
                                      cache["slot_pos"][j], pos)
        x = x + out
    x = _norm(params["ln_f"], cfg, x)
    lg = ly.logits(params["embedding"], cfg, x)
    return lg, {"mamba": new, "k": cache["k"], "v": cache["v"], "slot_pos": cache["slot_pos"],
                "pos": pos + 1, "counters": cache["counters"]}
