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
in every decode step}. The family serves through :mod:`~repro_torch.models.
hybrid`'s prefill and decode walks over its own layer plan, so its decode
step advances the cache in place and may be captured
(:data:`CUDA_GRAPH_DECODE`). Prefill takes ``marks``, a list to which it
appends a point on the device's stream after each layer
(:data:`PREFILL_MARKS`), so a caller can read each kind's device time once
the work is done, with no sync of its own. Serving only: the family has no
training loss and no sharding plan.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import hybrid, moe, ssm
from repro_torch.models import layers as ly
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _init_layers, _unstack, init_generator

#: The decode step may be captured as a CUDA graph and replayed (see
#: :data:`repro_torch.models.hybrid.CUDA_GRAPH_DECODE`).
CUDA_GRAPH_DECODE = True
#: ``prefill`` takes ``marks`` (see the module's docstring).
PREFILL_MARKS = True
#: The names of the cache's ``"counters"``, in order.
COUNTERS = moe.COUNTERS
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
    kv = (n_attn, B, max_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "mamba": hybrid.mamba2_stack(cfg, _count(cfg, "mamba"), B, dev),
        "k": torch.zeros(kv, dtype=ly.dt(cfg), device=dev),
        "v": torch.zeros(kv, dtype=ly.dt(cfg), device=dev),
        "slot_pos": torch.full((n_attn, max_seq), ly.EMPTY_POS, dtype=torch.int32, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "counters": torch.zeros((len(COUNTERS),), dtype=torch.int64, device=dev),
    }


def _plan(params, cfg: ModelConfig) -> list[hybrid.Step]:
    """Each layer's step in the published order: a Mamba2 layer's at its
    slot of the Mamba2 states, an expert layer's, an attention layer's at
    its KV slot over the whole prefix."""
    stacks = {kind: _unstack(params[kind], _count(cfg, kind)) for kind in KINDS.values()}
    plan = []
    for kind, j in layer_kinds(cfg):
        p = stacks[kind][j]
        plan.append(hybrid.Step(kind, p["ln"], p[_BODIES[kind][0]],
                                None if kind == "moe" else j, None))
    return plan


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int | None = None, marks=None):
    """Run the prompt through every layer from empty states: (last-token
    logits, primed cache); see :func:`repro_torch.models.hybrid.prefill_walk`,
    which appends to ``marks`` (a list) after each layer."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or S, device=tokens.device)
    return hybrid.prefill_walk(params, cfg, _plan(params, cfg), tokens, cache, marks)


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache):
    """One decode step, advancing ``cache`` in place (the counters added
    to); see :func:`repro_torch.models.hybrid.decode_walk`."""
    return hybrid.decode_walk(params, cfg, _plan(params, cfg), token, cache)
