"""Decoder-only LM for the dense family: init, prefill and cached decode.

Mirrors the reference package's ``repro/models/lm.py``. The parameters keep
the reference's stacked layout — ``params["layers"][...]`` leaves carry a
leading ``n_layers`` axis — so a parameter tree moves between the packages
as a plain tree map (:func:`repro_torch.models.params_from_numpy`). The
layer stack is a Python loop that indexes each leaf per layer; per-layer
attention patterns (gemma2's local/global alternation) are static per layer,
so a local layer runs only its windowed attention, which gives the values
the reference selects with ``where`` from both.

Inference runs under ``torch.inference_mode()``; there is no remat. The
MoE and VLM branches, ``backbone``, ``train_loss`` and the chunked loss
wait for ROADMAP item 13.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as ly
from repro_torch.models.config import ModelConfig


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (n_experts={cfg.n_experts}) is not ported "
            "yet; only the dense decoder is (MoE and VLM wait for ROADMAP.md item 13)")


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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(stacked, i: int):
    """Layer ``i``'s parameters: a view of every stacked leaf."""
    return _tree_map(lambda t: t[i], stacked)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig):
    dtype = ly.dt(cfg)
    return {
        "ln1": ly.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": ly.init_attention(gen, cfg),
        "ln2": ly.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mlp": ly.init_mlp(gen, cfg),
    }


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """Random parameters from ``generator`` (default: seed 0 on ``device``,
    which defaults to the card)."""
    _require_dense(cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    return {
        "embedding": ly.init_embedding(generator, cfg),
        "layers": _stack([init_block(generator, cfg) for _ in range(cfg.n_layers)]),
        "ln_f": ly.init_rmsnorm(cfg.d_model, ly.dt(cfg), generator.device),
    }


def _stack(trees):
    """Trees of the same structure → one tree of leaves stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


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


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache):
    """token: (B, 1) int32 → (logits (B, 1, V) float32, cache).

    The cache's k, v and slot_pos are updated in place and returned in a
    new dict with ``pos`` advanced; ``pos`` stays on the device.
    """
    _require_dense(cfg)
    x = ly.embed(params["embedding"], cfg, token)
    pos = cache["pos"]
    for i, window in enumerate(_layer_windows(cfg)):
        p = _layer(params["layers"], i)
        h = ly.rmsnorm(p["ln1"], x)
        x = x + ly.decode_attention(
            p["attn"], cfg, h, cache["k"][i], cache["v"][i], cache["slot_pos"][i], pos,
            window=window or None)
        h = ly.rmsnorm(p["ln2"], x)
        x = x + ly.mlp(p["mlp"], cfg, h)
    x = ly.rmsnorm(params["ln_f"], x)
    lg = ly.logits(params["embedding"], cfg, x)
    return lg, {"k": cache["k"], "v": cache["v"], "slot_pos": cache["slot_pos"],
                "pos": pos + 1}


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int | None = None):
    """Run the full prompt, return (last-token logits, primed cache)."""
    _require_dense(cfg)
    x = ly.embed(params["embedding"], cfg, batch["tokens"])
    B, S, _ = x.shape
    max_seq = max_seq or S
    cache = init_cache(cfg, B, max_seq, device=x.device)
    for i, window in enumerate(_layer_windows(cfg)):
        p = _layer(params["layers"], i)
        attn, k, v = ly.attention(p["attn"], cfg, ly.rmsnorm(p["ln1"], x),
                                  window=window or None)
        x = x + attn
        h = ly.rmsnorm(p["ln2"], x)
        x = x + ly.mlp(p["mlp"], cfg, h)
        ly.fill_cache_from_prefill(k, v, cache["k"][i], cache["v"][i], cache["slot_pos"][i])
    x = ly.rmsnorm(params["ln_f"], x)
    last = ly.logits(params["embedding"], cfg, x[:, -1:])
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
    return last, cache


def prefill_tokens(params, cfg: ModelConfig, tokens, max_seq: int | None = None):
    """Tokens-only prefill contract of the fused serving tower: a plain
    (B, S) int32 tensor on the parameters' device in, (logits, cache) out."""
    return prefill(params, cfg, {"tokens": tokens}, max_seq)
