"""xLSTM LM: alternating mLSTM (parallel/chunked) and sLSTM (sequential)
blocks, pre-norm residual, no separate FFN (d_ff=0 in the xlstm-350m
config — the blocks carry their own up/down projections).

Mirrors the reference package's ``repro/models/xlstm.py``. The parameters
keep the reference's tree, ``{"embedding", "blocks": [{"ln", "cell"}, ...],
"ln_f"}``, whose block list holds cells of two kinds (a checkpoint names a
leaf ``params/blocks/3/cell/r_h``); the blocks run as a Python loop, without
remat, as the reference's. The serving cache is ``{"states": [per-block
state], "pos"}``: an sLSTM's ``(h, c, n, m)`` and an mLSTM's ``(S, n)``
tuples, of no sequence length (``max_seq`` is accepted and unused).

Entry points run under ``torch.inference_mode()`` for serving; the decode
step returns new states, as the reference's. :func:`logical_axes` and
:func:`cache_logical_axes` give the sharding plan's logical axes
(:mod:`repro_torch.models.sharding`).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import chunked_ce_loss, init_generator


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return cfg.slstm_every > 0 and (i + 1) % cfg.slstm_every == 0


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """Random parameters from ``generator`` on its device; without one, from
    seed 0 on ``device`` (default: the card; ``"meta"`` gives shapes and
    dtypes without storage)."""
    generator, dev = init_generator(generator, device)
    dtype = ly.dt(cfg)
    embedding = ly.init_embedding(generator, cfg, dev)
    blocks = []
    for i in range(cfg.n_layers):
        init_cell = ssm.init_slstm if _is_slstm(cfg, i) else ssm.init_mlstm
        blocks.append({"ln": ly.init_rmsnorm(cfg.d_model, dtype, dev),
                       "cell": init_cell(generator, cfg, dev)})
    return {"embedding": embedding, "blocks": blocks,
            "ln_f": ly.init_rmsnorm(cfg.d_model, dtype, dev)}


def logical_axes(cfg: ModelConfig):
    norm = {"scale": (None,)}
    blocks = []
    for i in range(cfg.n_layers):
        cell = ssm.slstm_logical_axes(cfg) if _is_slstm(cfg, i) else ssm.mlstm_logical_axes(cfg)
        blocks.append({"ln": norm, "cell": cell})
    return {
        "embedding": ly.embedding_logical_axes(cfg),
        "blocks": blocks,
        "ln_f": norm,
    }


def _apply_block(cfg: ModelConfig, i: int, blk, x, state=None):
    h = ly.rmsnorm(blk["ln"], x)
    block = ssm.slstm_block if _is_slstm(cfg, i) else ssm.mlstm_block
    out, new_state = block(blk["cell"], cfg, h, state)
    return x + out, new_state


def backbone(params, cfg: ModelConfig, x):
    for i, blk in enumerate(params["blocks"]):
        x, _ = _apply_block(cfg, i, blk, x)
    return ly.rmsnorm(params["ln_f"], x)


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    x = ly.embed(params["embedding"], cfg, batch["tokens"])
    x = backbone(params, cfg, x)
    return chunked_ce_loss(params, cfg, x, batch["labels"])


# -- serving ------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None):
    dev = resolve_device(device)
    states = [ssm.slstm_state_init(cfg, B, dev) if _is_slstm(cfg, i)
              else ssm.mlstm_state_init(cfg, B, dev) for i in range(cfg.n_layers)]
    return {"states": states, "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def cache_logical_axes(cfg: ModelConfig, B: int):
    states = []
    for i in range(cfg.n_layers):
        if _is_slstm(cfg, i):
            states.append((("batch", None),) * 4)  # h, c, n, m: (B, d)
        else:
            states.append((("batch", "heads", None, None), ("batch", "heads", None)))
    return {"states": states, "pos": ()}


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int | None = None):
    """Run the prompt through every block from empty states: (last-token
    logits, cache of the blocks' final states)."""
    tokens = batch["tokens"]
    x = ly.embed(params["embedding"], cfg, tokens)
    states = []
    for i, blk in enumerate(params["blocks"]):
        x, st = _apply_block(cfg, i, blk, x)
        states.append(st)
    x = ly.rmsnorm(params["ln_f"], x)
    last = ly.logits(params["embedding"], cfg, x[:, -1:])
    pos = torch.full((), tokens.shape[1], dtype=torch.int32, device=x.device)
    return last, {"states": states, "pos": pos}


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache):
    """token: (B, 1) int32 → (logits (B, 1, V) float32, new cache)."""
    x = ly.embed(params["embedding"], cfg, token)
    new_states = []
    for i, (blk, st) in enumerate(zip(params["blocks"], cache["states"])):
        h = ly.rmsnorm(blk["ln"], x)
        step = ssm.slstm_decode_step if _is_slstm(cfg, i) else ssm.mlstm_decode_step
        out, st2 = step(blk["cell"], cfg, h, st)
        x = x + out
        new_states.append(st2)
    x = ly.rmsnorm(params["ln_f"], x)
    lg = ly.logits(params["embedding"], cfg, x)
    return lg, {"states": new_states, "pos": cache["pos"] + 1}
