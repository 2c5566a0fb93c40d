"""Encoder-decoder model (whisper-base backbone).

Mirrors the reference package's ``repro/models/encdec.py``. The audio conv
frontend is a stub: the batch carries precomputed frame embeddings
(B, encoder_seq, d_model). Encoder blocks are bidirectional; decoder blocks
are causal self-attention, cross-attention over the encoder memory (its
keys roped over the memory positions) and an MLP. The blocks live in
Python lists, as the reference's (``params["decoder"][0]["cross_attn"]``;
a checkpoint names that leaf ``params/decoder/0/cross_attn/wq``), and run
as a Python loop. Training runs each block under the config's remat
policy (:func:`repro_torch.models.lm._remat`; the same values, the encoder's
score blocks recomputed in the backward instead of kept).

Entry points run under ``torch.inference_mode()`` for serving; the decode
step updates the self-attention cache in place, as
:func:`repro_torch.models.lm.decode_step` does.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as ly
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _remat, chunked_ce_loss, init_generator, kv_cache_axes


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig, device):
    dtype = ly.dt(cfg)
    return {
        "ln1": ly.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": ly.init_attention(gen, cfg, device),
        "ln2": ly.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": ly.init_mlp(gen, cfg, device),
    }


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig, device):
    dtype = ly.dt(cfg)
    return {
        "ln1": ly.init_rmsnorm(cfg.d_model, dtype, device),
        "self_attn": ly.init_attention(gen, cfg, device),
        "ln_x": ly.init_rmsnorm(cfg.d_model, dtype, device),
        "cross_attn": ly.init_attention(gen, cfg, device),
        "ln2": ly.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": ly.init_mlp(gen, cfg, device),
    }


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """Random parameters from ``generator`` on its device; without one, from
    seed 0 on ``device`` (default: the card; ``"meta"`` gives shapes and
    dtypes without storage)."""
    generator, dev = init_generator(generator, device)
    dtype = ly.dt(cfg)
    return {
        "embedding": ly.init_embedding(generator, cfg, dev),
        "encoder": [_init_enc_block(generator, cfg, dev) for _ in range(cfg.encoder_layers)],
        "decoder": [_init_dec_block(generator, cfg, dev) for _ in range(cfg.n_layers)],
        "ln_enc": ly.init_rmsnorm(cfg.d_model, dtype, dev),
        "ln_f": ly.init_rmsnorm(cfg.d_model, dtype, dev),
    }


def logical_axes(cfg: ModelConfig):
    attn = ly.attention_logical_axes(cfg)
    mlp = ly.mlp_logical_axes(cfg)
    norm = {"scale": (None,)}
    enc = {"ln1": norm, "attn": attn, "ln2": norm, "mlp": mlp}
    dec = {
        "ln1": norm, "self_attn": attn, "ln_x": norm,
        "cross_attn": attn, "ln2": norm, "mlp": mlp,
    }
    return {
        "embedding": ly.embedding_logical_axes(cfg),
        "encoder": [enc for _ in range(cfg.encoder_layers)],
        "decoder": [dec for _ in range(cfg.n_layers)],
        "ln_enc": norm,
        "ln_f": norm,
    }


def _enc_block(cfg: ModelConfig, blk, x):
    h = ly.rmsnorm(blk["ln1"], x)
    x = x + ly.attention(blk["attn"], cfg, h, causal=False)[0]
    h = ly.rmsnorm(blk["ln2"], x)
    return x + ly.mlp(blk["mlp"], cfg, h)


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, T, d) stub embeddings → encoder memory (B, T, d)."""
    x = frames.to(ly.dt(cfg))
    for blk in params["encoder"]:
        x = _remat(cfg, functools.partial(_enc_block, cfg))(blk, x)
    return ly.rmsnorm(params["ln_enc"], x)


def _mem_positions(memory):
    return torch.arange(memory.shape[1], dtype=torch.int32, device=memory.device)[None, :]


def _dec_block(cfg: ModelConfig, blk, x, memory, mem_pos):
    h = ly.rmsnorm(blk["ln1"], x)
    x = x + ly.attention(blk["self_attn"], cfg, h, causal=True)[0]
    h = ly.rmsnorm(blk["ln_x"], x)
    mk, mv = ly.project_kv(blk["cross_attn"], cfg, memory, mem_pos)  # roped over memory
    x = x + ly.attention(blk["cross_attn"], cfg, h, causal=False, kv_override=(mk, mv))[0]
    h = ly.rmsnorm(blk["ln2"], x)
    return x + ly.mlp(blk["mlp"], cfg, h)


def _decoder_stack(params, cfg: ModelConfig, x, memory):
    mem_pos = _mem_positions(memory)
    for blk in params["decoder"]:
        x = _remat(cfg, functools.partial(_dec_block, cfg))(blk, x, memory, mem_pos)
    return ly.rmsnorm(params["ln_f"], x)


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean next-token CE of the decoder over the encoded frames."""
    memory = encode(params, cfg, batch["frames"])
    x = ly.embed(params["embedding"], cfg, batch["tokens"])
    x = _decoder_stack(params, cfg, x, memory)
    return chunked_ce_loss(params, cfg, x, batch["labels"])


# -- serving ----------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None):
    L, Hkv, hd, T = cfg.n_layers, cfg.n_kv_heads, cfg.hd, cfg.encoder_seq
    dev = resolve_device(device)
    zeros = functools.partial(torch.zeros, dtype=ly.dt(cfg), device=dev)
    return {
        "k": zeros((L, B, max_seq, Hkv, hd)),
        "v": zeros((L, B, max_seq, Hkv, hd)),
        "slot_pos": torch.full((L, max_seq), ly.EMPTY_POS, dtype=torch.int32, device=dev),
        "cross_k": zeros((L, B, T, Hkv, hd)),
        "cross_v": zeros((L, B, T, Hkv, hd)),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def cache_logical_axes(cfg: ModelConfig, B: int):
    kv = kv_cache_axes(cfg, B)
    xkv = (None, "batch", None, "kv_heads", None)
    return {
        "k": kv, "v": kv, "slot_pos": (None, None),
        "cross_k": xkv, "cross_v": xkv, "pos": (),
    }


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int | None = None):
    """Encode the frames, run the prompt tokens, prime the self- and
    cross-attention caches: (last-token logits, cache)."""
    memory = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_seq = max_seq or S
    x = ly.embed(params["embedding"], cfg, tokens)
    mem_pos = _mem_positions(memory)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    cache = init_cache(cfg, B, max_seq, device=x.device)
    for i, blk in enumerate(params["decoder"]):
        h = ly.rmsnorm(blk["ln1"], x)
        q, k, v = ly._project_qkv(blk["self_attn"], cfg, h, positions)
        attn = ly.chunked_attention(cfg, q, k, v, window=None, softcap=None)
        x = x + attn.reshape(B, S, -1) @ blk["self_attn"]["wo"]
        ly.fill_cache_from_prefill(k, v, cache["k"][i], cache["v"][i], cache["slot_pos"][i])
        h = ly.rmsnorm(blk["ln_x"], x)
        mk, mv = ly.project_kv(blk["cross_attn"], cfg, memory, mem_pos)
        cache["cross_k"][i].copy_(mk)
        cache["cross_v"][i].copy_(mv)
        x = x + ly.attention(blk["cross_attn"], cfg, h, causal=False, kv_override=(mk, mv))[0]
        h = ly.rmsnorm(blk["ln2"], x)
        x = x + ly.mlp(blk["mlp"], cfg, h)
    x = ly.rmsnorm(params["ln_f"], x)
    last = ly.logits(params["embedding"], cfg, x[:, -1:])
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
    return last, cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache):
    """token: (B, 1) int32 → (logits (B, 1, V) float32, cache). The
    self-attention cache is updated in place; the cross query is roped at
    position 0 and attends to every memory position (no mask)."""
    x = ly.embed(params["embedding"], cfg, token)
    pos = cache["pos"]
    B, hd = x.shape[0], cfg.hd
    zero_pos = torch.zeros((B, 1), dtype=torch.int32, device=x.device)
    for i, blk in enumerate(params["decoder"]):
        h = ly.rmsnorm(blk["ln1"], x)
        x = x + ly.decode_attention(blk["self_attn"], cfg, h, cache["k"][i], cache["v"][i],
                                    cache["slot_pos"][i], pos)
        h = ly.rmsnorm(blk["ln_x"], x)
        q = ly.project_q(blk["cross_attn"], cfg, h, zero_pos)
        mk, mv = cache["cross_k"][i], cache["cross_v"][i]
        qh = q.reshape(B, 1, cfg.n_kv_heads, cfg.q_per_kv, hd)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh.to(torch.float32), mk.to(torch.float32))
        p = torch.softmax(s / (hd ** 0.5), dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(mv.dtype), mv)
        x = x + o.reshape(B, 1, -1) @ blk["cross_attn"]["wo"]
        h = ly.rmsnorm(blk["ln2"], x)
        x = x + ly.mlp(blk["mlp"], cfg, h)
    x = ly.rmsnorm(params["ln_f"], x)
    lg = ly.logits(params["embedding"], cfg, x)
    return lg, {**cache, "pos": pos + 1}
