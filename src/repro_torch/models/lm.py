"""Decoder-only LM for the dense, moe and vlm families: init, training
loss, prefill and cached decode.

Mirrors the reference package's ``repro/models/lm.py``. The parameters keep
the reference's stacked layout — ``params["layers"][...]`` leaves carry a
leading ``n_layers`` axis — so a parameter tree moves between the packages
as a plain tree map (:func:`repro_torch.models.params_from_numpy`). The
layer stack is a Python loop over the stacked leaves, unbound once per
forward (so the backward stacks each leaf's gradient once, instead of
adding one zero-padded full-size gradient per layer). Per-layer attention
patterns (gemma2's local/global alternation) are static per layer, so a
local layer runs only its windowed attention, which gives the values the
reference selects with ``where``/``cond`` from both. The moe family puts
:mod:`repro_torch.models.moe` in place of the MLP (capacity routing in
training, dropless in prefill and decode; its auxiliary loss summed in
float32 in layer order); the vlm family puts the projected patch
embeddings in front of the tokens.

Training wraps each block in ``torch.utils.checkpoint`` as the reference
wraps it in ``jax.checkpoint`` (:func:`_remat`), and the LM head + cross
entropy run over 512-token chunks, each checkpointed, so one chunk's
(B, 512, V) float32 logits is live at a time. Inference runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import stacked
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

AUX_LOSS_WEIGHT = 0.01
LOSS_CHUNK = 512


#: The families this module runs; the registry maps each of them here.
FAMILIES = ("dense", "moe", "vlm")


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        # imported here: the registry imports this module
        from repro_torch.models.registry import _FAMILY_MODULES

        module = _FAMILY_MODULES.get(cfg.family)
        where = module.__name__ if module else "no module of the port"
        raise NotImplementedError(
            f"{cfg.name}: this module runs the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r}, which {where} runs")


def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full causal)."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.sliding_window is not None:
            out.append(cfg.sliding_window)
        elif cfg.local_global_period and i % cfg.local_global_period == 0:
            out.append(cfg.local_window)
        else:
            out.append(0)
    return out


def _unstack(stacked, n: int) -> list:
    """The per-layer parameter trees of a stacked tree: each leaf unbound
    once along its layer axis."""
    parts = [torch.unbind(t) for t in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [p[i] for p in parts]) for i in range(n)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, device):
    dtype = ly.dt(cfg)
    p = {
        "ln1": ly.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": ly.init_attention(gen, cfg, device),
        "ln2": ly.init_rmsnorm(cfg.d_model, dtype, device),
    }
    if cfg.n_experts:
        p["moe"] = moe_mod.init_moe(gen, cfg, device)
    else:
        p["mlp"] = ly.init_mlp(gen, cfg, device)
    return p


def block_logical_axes(cfg: ModelConfig):
    p = {
        "ln1": {"scale": (None,)},
        "attn": ly.attention_logical_axes(cfg),
        "ln2": {"scale": (None,)},
    }
    if cfg.n_experts:
        p["moe"] = moe_mod.moe_logical_axes(cfg)
    else:
        p["mlp"] = ly.mlp_logical_axes(cfg)
    return p


def _init_layers(gen: torch.Generator, cfg: ModelConfig, device, init_block=init_block,
                 n: int | None = None):
    """The blocks' parameters (``init_block(gen, cfg, device)`` each) in the
    stacked layout: each (n, ...) leaf (n defaults to ``cfg.n_layers``)
    allocated once and filled a block at a time, drawn block after block,
    so only one block is ever held twice."""
    n = cfg.n_layers if n is None else n
    stacked = None
    for i in range(n):
        block = init_block(gen, cfg, device)
        if stacked is None:
            stacked = tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                                     device=t.device), block)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, block)
    return stacked


def init_generator(generator: torch.Generator | None, device):
    """(generator, device) of a family's ``init``: ``generator`` on its own
    device, or a seed-0 one for ``device`` (default: the card; a CPU one
    for ``"meta"``, which allocates nothing)."""
    if generator is not None:
        return generator, generator.device
    dev = resolve_device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(0), dev


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """Random parameters from ``generator`` on its device; without one, from
    seed 0 on ``device`` (default: the card), where ``"meta"`` gives the
    parameters' shapes and dtypes without allocating them. The vlm family
    adds ``vision_proj``, drawn last."""
    _require_family(cfg)
    generator, dev = init_generator(generator, device)
    params = {
        "embedding": ly.init_embedding(generator, cfg, dev),
        "layers": _init_layers(generator, cfg, dev),
        "ln_f": ly.init_rmsnorm(cfg.d_model, ly.dt(cfg), dev),
    }
    if cfg.family == "vlm":
        params["vision_proj"] = ly.init_dense(generator, cfg.d_model, cfg.d_model, ly.dt(cfg),
                                              dev)
    return params


# ---------------------------------------------------------------------------
# forward + training loss
# ---------------------------------------------------------------------------


def logical_axes(cfg: ModelConfig):
    """Tree of logical-axis tuples matching init(); stacked layers get a
    leading None (layer axis unsharded)."""
    p = {
        "embedding": ly.embedding_logical_axes(cfg),
        "layers": stacked(block_logical_axes(cfg)),
        "ln_f": {"scale": (None,)},
    }
    if cfg.family == "vlm":
        p["vision_proj"] = ("embed", None)
    return p


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the products without batch dimensions
    (``x @ w`` lowers to ``mm``/``addmm``; attention's batched ``bmm`` is
    recomputed), as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the config's remat policy, the reference's
    ``jax.checkpoint(fn, policy=_remat_policy(cfg))``: ``"nothing"`` saves
    only the inputs and recomputes the rest in the backward, ``"full"``
    saves everything (no checkpoint), ``"dots"`` saves the matmuls."""
    if cfg.remat_policy == "full":
        return fn
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_matmuls))
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _ffn(cfg: ModelConfig, p, h, *, dropless: bool):
    """The block's MLP or MoE on ``h``: (out, the MoE's aux loss or None)."""
    if cfg.n_experts:
        return moe_mod.moe_mlp(p["moe"], cfg, h, dropless=dropless)
    return ly.mlp(p["mlp"], cfg, h), None


def _block_apply(cfg: ModelConfig, window: int, p, x):
    """One transformer block; ``window`` 0 = full causal attention. Returns
    (x, aux): the MoE's capacity-routed aux loss, None without experts."""
    h = ly.rmsnorm(p["ln1"], x)
    x = x + ly.attention(p["attn"], cfg, h, window=window or None)[0]
    h = ly.rmsnorm(p["ln2"], x)
    out, aux = _ffn(cfg, p, h, dropless=False)
    return x + out, aux


def backbone(params, cfg: ModelConfig, x):
    """(B, S, d) → ((B, S, d), aux loss) through the layer stack, each block
    under :func:`_remat`. The aux loss is the blocks' float32 sum in layer
    order (a float32 zero without experts, as the reference's)."""
    _require_family(cfg)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, window in zip(_unstack(params["layers"], cfg.n_layers), _layer_windows(cfg)):
        x, aux = _remat(cfg, functools.partial(_block_apply, cfg, window))(p, x)
        if aux is not None:
            aux_sum = aux_sum + aux
    return ly.rmsnorm(params["ln_f"], x), aux_sum


def _inputs_to_embeddings(params, cfg: ModelConfig, batch):
    """tokens (behind the projected patch embeddings for vlm) → (B, S, d)."""
    x = ly.embed(params["embedding"], cfg, batch["tokens"])
    if cfg.family == "vlm":
        vis = batch["patches"].to(ly.dt(cfg)) @ params["vision_proj"]
        x = torch.cat([vis, x], dim=1)
    return x


def _chunk_ce_sum(cfg: ModelConfig, params, xc, lc):
    lg = ly.logits(params, cfg, xc)  # (B, c, V) float32
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, lc.to(torch.int64)[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_ce_loss(params, cfg: ModelConfig, x, labels):
    """The LM head + CE over ``LOSS_CHUNK``-token chunks, each recomputed in
    the backward; the chunks' float32 sums are added in order and divided by
    B·S (mean CE)."""
    B, S, _ = x.shape
    c = min(LOSS_CHUNK, S)
    assert S % c == 0
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    body = functools.partial(checkpoint, functools.partial(_chunk_ce_sum, cfg),
                             use_reentrant=False)
    for i in range(S // c):
        chunk = slice(i * c, (i + 1) * c)
        tot = tot + body(params["embedding"], x[:, chunk], labels[:, chunk])
    return tot / (B * S)


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean CE against pre-aligned next-token labels over the token
    positions only (vlm: not the patch prefix), + the MoE's aux loss."""
    _require_family(cfg)
    x = _inputs_to_embeddings(params, cfg, batch)
    x, aux = backbone(params, cfg, x)
    loss = chunked_ce_loss(params, cfg, x[:, -batch["tokens"].shape[1]:], batch["labels"])
    return loss + AUX_LOSS_WEIGHT * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None):
    Smax = cache_len(cfg, max_seq)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    dev = resolve_device(device)
    return {
        "k": torch.zeros((L, B, Smax, Hkv, hd), dtype=ly.dt(cfg), device=dev),
        "v": torch.zeros((L, B, Smax, Hkv, hd), dtype=ly.dt(cfg), device=dev),
        "slot_pos": torch.full((L, Smax), ly.EMPTY_POS, dtype=torch.int32, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def kv_cache_axes(cfg: ModelConfig, B: int) -> tuple:
    """Logical axes of a stacked (L, B, S, Hkv, hd) KV cache. B==1
    (long-context) shards the cache sequence over 'model'; otherwise
    batch+kv-heads."""
    if B == 1:  # long-context: shard the cache sequence, not heads
        return (None, None, "kv_seq", None, None)
    if cfg.decode_cache_seq_shard:
        # Batch × sequence sharding = the full 256-way cache split (kv_heads
        # rarely divide the model axis; the sequence always does).
        return (None, "batch", "kv_seq", None, None)
    return (None, "batch", None, "kv_heads", None)


def cache_logical_axes(cfg: ModelConfig, B: int):
    """Logical axes matching init_cache's structure."""
    kv = kv_cache_axes(cfg, B)
    return {"k": kv, "v": kv, "slot_pos": (None, None), "pos": ()}


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache):
    """token: (B, 1) int32 → (logits (B, 1, V) float32, cache).

    The cache's k, v and slot_pos are updated in place and returned in a
    new dict with ``pos`` advanced; ``pos`` stays on the device. MoE
    routes dropless.
    """
    _require_family(cfg)
    x = ly.embed(params["embedding"], cfg, token)
    pos = cache["pos"]
    layers = _unstack(params["layers"], cfg.n_layers)
    for i, (p, window) in enumerate(zip(layers, _layer_windows(cfg))):
        h = ly.rmsnorm(p["ln1"], x)
        x = x + ly.decode_attention(
            p["attn"], cfg, h, cache["k"][i], cache["v"][i], cache["slot_pos"][i], pos,
            window=window or None)
        h = ly.rmsnorm(p["ln2"], x)
        x = x + _ffn(cfg, p, h, dropless=True)[0]
    x = ly.rmsnorm(params["ln_f"], x)
    lg = ly.logits(params["embedding"], cfg, x)
    return lg, {"k": cache["k"], "v": cache["v"], "slot_pos": cache["slot_pos"],
                "pos": pos + 1}


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int | None = None):
    """Run the full prompt (behind the patch prefix for vlm, whose
    positions the cache counts too), return (last-token logits, primed
    cache). MoE routes dropless, so decode continues it exactly."""
    _require_family(cfg)
    x = _inputs_to_embeddings(params, cfg, batch)
    B, S, _ = x.shape
    max_seq = max_seq or S
    cache = init_cache(cfg, B, max_seq, device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    for i, (p, window) in enumerate(zip(layers, _layer_windows(cfg))):
        attn, k, v = ly.attention(p["attn"], cfg, ly.rmsnorm(p["ln1"], x),
                                  window=window or None)
        x = x + attn
        h = ly.rmsnorm(p["ln2"], x)
        x = x + _ffn(cfg, p, h, dropless=True)[0]
        ly.fill_cache_from_prefill(k, v, cache["k"][i], cache["v"][i], cache["slot_pos"][i])
    x = ly.rmsnorm(params["ln_f"], x)
    last = ly.logits(params["embedding"], cfg, x[:, -1:])
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
    return last, cache

