"""Zamba2-style hybrid: a Mamba2 backbone with one SHARED attention+MLP
block (a single weight copy) applied after every ``attn_every``-th backbone
layer.

Mirrors the reference package's ``repro/models/hybrid.py``. The parameters
keep the reference's tree, ``{"embedding", "layers": {"ln", "mamba"},
"shared": {"ln1", "attn", "ln2", "mlp"}, "ln_f"}``, the backbone's leaves
stacked along a leading ``n_layers`` axis as :mod:`repro_torch.models.lm`
keeps them. The layers run as a Python loop, each under the config's remat
policy; the shared block runs at a layer where the reference's ``lax.cond``
takes it, a static branch here. Its gradient is the sum over its sites.

Each application site keeps its own KV cache (weights are shared,
activations are not); the shared attention uses the sliding window
``local_window`` and its cache holds min(max_seq, local_window) positions.
The serving cache is ``{"mamba": (conv_buf, S, n), "k", "v", "slot_pos",
"pos"}``, the Mamba2 states stacked along the layers. Prefill fills a
preallocated cache layer by layer; the decode step advances the cache it
is given in place, each Mamba2 layer's states in their slot and each site's
K/V (as :func:`repro_torch.models.layers.decode_attention` does), where the
reference returns new states (:data:`CUDA_GRAPH_DECODE`). Serving runs under
``torch.inference_mode()``. :func:`logical_axes` and
:func:`cache_logical_axes` give the sharding plan's logical axes
(:mod:`repro_torch.models.sharding`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import obs, resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import mla, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (
    _init_layers,
    _remat,
    _unstack,
    chunked_ce_loss,
    init_generator,
    kv_cache_axes,
)
from repro_torch.models.sharding import stacked

#: The decode step may be captured as a CUDA graph and replayed: it makes no
#: host sync and no data-dependent shape, keeps ``pos`` on the device, and
#: writes its new states into the cache's own buffers.
CUDA_GRAPH_DECODE = True


def _attn_flags(cfg: ModelConfig) -> tuple[list[bool], list[int], int]:
    """(apply the shared block after layer i, its site index (0 where it
    does not apply), number of sites): layer i hits when (i + 1) %
    attn_every == 0, the sites numbered in order."""
    flags, slots = [], []
    site = 0
    for i in range(cfg.n_layers):
        hit = cfg.attn_every > 0 and (i + 1) % cfg.attn_every == 0
        flags.append(hit)
        slots.append(site if hit else 0)
        site += hit
    return flags, slots, site


def _init_backbone_layer(gen: torch.Generator, cfg: ModelConfig, device):
    return {"ln": ly.init_rmsnorm(cfg.d_model, ly.dt(cfg), device),
            "mamba": ssm.init_mamba2(gen, cfg, device)}


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """Random parameters from ``generator`` on its device; without one, from
    seed 0 on ``device`` (default: the card; ``"meta"`` gives shapes and
    dtypes without storage). Drawn in the reference's order: the
    embedding, the backbone layer after layer, the shared attention, the
    shared MLP."""
    generator, dev = init_generator(generator, device)
    dtype = ly.dt(cfg)
    return {
        "embedding": ly.init_embedding(generator, cfg, dev),
        "layers": _init_layers(generator, cfg, dev, init_block=_init_backbone_layer),
        "shared": {
            "ln1": ly.init_rmsnorm(cfg.d_model, dtype, dev),
            "attn": ly.init_attention(generator, cfg, dev),
            "ln2": ly.init_rmsnorm(cfg.d_model, dtype, dev),
            "mlp": ly.init_mlp(generator, cfg, dev),
        },
        "ln_f": ly.init_rmsnorm(cfg.d_model, dtype, dev),
    }


def logical_axes(cfg: ModelConfig):
    norm = {"scale": (None,)}
    return {
        "embedding": ly.embedding_logical_axes(cfg),
        "layers": {"ln": {"scale": (None, None)},
                   "mamba": stacked(ssm.mamba2_logical_axes(cfg))},
        "shared": {
            "ln1": norm,
            "attn": ly.attention_logical_axes(cfg),
            "ln2": norm,
            "mlp": ly.mlp_logical_axes(cfg),
        },
        "ln_f": norm,
    }


def _shared_block(shared, cfg: ModelConfig, x):
    h = ly.rmsnorm(shared["ln1"], x)
    x = x + ly.attention(shared["attn"], cfg, h, window=cfg.local_window)[0]
    h = ly.rmsnorm(shared["ln2"], x)
    return x + ly.mlp(shared["mlp"], cfg, h)


def _layer_apply(cfg: ModelConfig, hit: bool, p, shared, x):
    """One backbone layer, then the shared block where ``hit``."""
    out, _ = ssm.mamba2_block(p["mamba"], cfg, ly.rmsnorm(p["ln"], x))
    x = x + out
    return _shared_block(shared, cfg, x) if hit else x


def backbone(params, cfg: ModelConfig, x):
    flags, _, _ = _attn_flags(cfg)
    for p, hit in zip(_unstack(params["layers"], cfg.n_layers), flags):
        x = _remat(cfg, functools.partial(_layer_apply, cfg, hit))(p, params["shared"], x)
    return ly.rmsnorm(params["ln_f"], x)


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    x = ly.embed(params["embedding"], cfg, batch["tokens"])
    x = backbone(params, cfg, x)
    return chunked_ce_loss(params, cfg, x, batch["labels"])


# -- serving ------------------------------------------------------------------
#
# Both Mamba2 hybrids (this family and :mod:`~repro_torch.models.nemotron_h`)
# and :mod:`~repro_torch.models.deepseek_v3` serve through one prefill walk and
# one decode walk over a layer plan: the model's steps in order, each a
# :class:`Step`. Every step is a pre-norm residual block, x += block(RMSNorm(x)).


class Step(NamedTuple):
    """One step of a layer plan."""

    kind: str  # "mamba", "attn", "mla", "mlp" or "moe"
    ln: dict  # its RMSNorm's parameters
    block: dict  # the block's parameters
    # its slot in the cache: a Mamba2 layer's states, an attention's KV, a
    # latent attention's latents
    slot: int | None
    window: int | None  # an attention's sliding window (None: the whole prefix)


def _plan(params, cfg: ModelConfig) -> list[Step]:
    """Each backbone layer's Mamba2 step, and after a layer where the shared
    block applies, its attention (over the window, at the site's KV slot)
    and its MLP."""
    flags, slots, _ = _attn_flags(cfg)
    shared = params["shared"]
    plan = []
    for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
        plan.append(Step("mamba", p["ln"], p["mamba"], i, None))
        if flags[i]:
            plan += [Step("attn", shared["ln1"], shared["attn"], slots[i], cfg.local_window),
                     Step("mlp", shared["ln2"], shared["mlp"], None, None)]
    return plan


def mamba2_stack(cfg: ModelConfig, n: int, B: int, device) -> tuple:
    """Zero Mamba2 states (conv_buf, S, n) of ``n`` layers, stacked along a
    leading axis: the cache's ``"mamba"``."""
    state = ssm.mamba2_state_init(cfg, B, device="meta")
    return tuple(torch.zeros((n, *t.shape), dtype=t.dtype, device=device) for t in state)


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None):
    """Zero Mamba2 states for every layer and an empty KV ring of
    min(max_seq, local_window) positions for every site."""
    _, _, n_sites = _attn_flags(cfg)
    Smax = min(max_seq, cfg.local_window)
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    dev = resolve_device(device)
    return {
        "mamba": mamba2_stack(cfg, cfg.n_layers, B, dev),
        "k": torch.zeros((n_sites, B, Smax, Hkv, hd), dtype=ly.dt(cfg), device=dev),
        "v": torch.zeros((n_sites, B, Smax, Hkv, hd), dtype=ly.dt(cfg), device=dev),
        "slot_pos": torch.full((n_sites, Smax), ly.EMPTY_POS, dtype=torch.int32, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def cache_logical_axes(cfg: ModelConfig, B: int):
    kv = kv_cache_axes(cfg, B)
    return {
        "mamba": (
            (None, "batch", None, "ff"),          # conv buffer (L, B, K-1, dconv)
            (None, "batch", "heads", None, None),  # S state (L, B, H, N, P)
            (None, "batch", "heads", None),        # n state (L, B, H, N)
        ),
        "k": kv, "v": kv, "slot_pos": (None, None), "pos": (),
    }


def prefill_walk(params, cfg: ModelConfig, plan: list[Step], tokens, cache, marks):
    """Run the prompt through ``plan`` from the empty ``cache`` (the
    family's ``init_cache``), filling it: (last-token logits, cache). A
    prompt shorter than ssm_conv − 1 leaves the cache's Mamba2 conv buffer
    ``None``, as the reference's, and a decode step from it raises. With
    ``marks`` (a list), appends ``("start", mark)`` where the list is empty
    and then ``(kind, mark)`` after each step
    (:func:`repro_torch.obs.device_mark`), so walks over row groups of one
    batch mark one run of steps."""
    x = ly.embed(params["embedding"], cfg, tokens)
    if marks is not None and not marks:
        marks.append(("start", obs.device_mark(x.device)))
    for kind, ln, p, j, window in plan:
        h = ly.rmsnorm(ln, x, eps=cfg.norm_eps)
        if kind == "mamba":
            out, st = ssm.mamba2_block(p, cfg, h)
            for dst, src in zip(cache["mamba"], st):
                if src is not None:
                    dst[j].copy_(src)
        elif kind == "attn":
            out, k, v = ly.attention(p, cfg, h, window=window)
            ly.fill_cache_from_prefill(k, v, cache["k"][j], cache["v"][j], cache["slot_pos"][j])
        elif kind == "mla":
            out, latent = mla.prefill(p, cfg, h)
            cache["latent"][j][:, :latent.shape[1]] = latent
        elif kind == "mlp":
            out = ly.mlp(p, cfg, h)
        else:
            out = moe.routed_moe(p, cfg, h, cache["counters"])
        x = x + out
        if marks is not None:
            marks.append((kind, obs.device_mark(x.device)))
    x = ly.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    S = tokens.shape[1]
    if "mamba" in cache and S < cfg.ssm_conv - 1:
        cache["mamba"] = (None, *cache["mamba"][1:])
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
    return ly.logits(params["embedding"], cfg, x[:, -1:]), cache


def decode_walk(params, cfg: ModelConfig, plan: list[Step], token, cache):
    """token: (B, 1) int32 → (logits (B, 1, V) float32, cache), advancing
    ``cache`` in place: each Mamba2 layer's (conv_buf, S, n) written into
    its own slot (on a card the recurrent state element by element, in one
    kernel), each attention's k, v and slot_pos, each latent attention's
    latent, the counters added to; only ``pos`` is new, advanced on the
    device. No host sync and no data-dependent shape, so it may be
    captured as a CUDA graph."""
    if "mamba" in cache and cache["mamba"][0] is None:
        raise ValueError(
            f"{cfg.name}: the cache has no Mamba2 conv buffer (its prefill had fewer than "
            f"ssm_conv - 1 = {cfg.ssm_conv - 1} tokens), so no decode step can follow it")
    x = ly.embed(params["embedding"], cfg, token)
    pos = cache["pos"]
    for kind, ln, p, j, window in plan:
        h = ly.rmsnorm(ln, x, eps=cfg.norm_eps)
        if kind == "mamba":
            slots = tuple(t[j] for t in cache["mamba"])
            out, _ = ssm.mamba2_decode_step(p, cfg, h, slots, out=slots)
        elif kind == "attn":
            out = ly.decode_attention(p, cfg, h, cache["k"][j], cache["v"][j],
                                      cache["slot_pos"][j], pos, window=window)
        elif kind == "mla":
            out = mla.decode(p, cfg, h, cache["latent"][j], pos)
        elif kind == "mlp":
            out = ly.mlp(p, cfg, h)
        else:
            out = moe.routed_moe(p, cfg, h, cache["counters"])
        x = x + out
    x = ly.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    return ly.logits(params["embedding"], cfg, x), {**cache, "pos": pos + 1}


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int | None = None):
    """Run the prompt through every layer from empty states: (last-token
    logits, primed cache); see :func:`prefill_walk`."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or S, device=tokens.device)
    return prefill_walk(params, cfg, _plan(params, cfg), tokens, cache, None)


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache):
    """One decode step, advancing ``cache`` in place; see
    :func:`decode_walk`."""
    return decode_walk(params, cfg, _plan(params, cfg), token, cache)
