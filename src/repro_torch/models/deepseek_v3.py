"""DeepSeek-V3 (arXiv:2412.19437): latent attention in every layer, a dense
SwiGLU MLP in the first ``cfg.dense_layers`` layers and an expert layer in
the rest, each sublayer a pre-norm residual block.

Every layer is x += MLA(RMSNorm(x)) (:mod:`repro_torch.models.mla`), then
x += FFN(RMSNorm(x)): :func:`repro_torch.models.layers.mlp` (SwiGLU,
``cfg.d_ff`` wide) in a dense layer, :func:`repro_torch.models.moe.
routed_moe` in an expert layer: sigmoid scores plus a correction bias over
the router's width, top ``cfg.top_k`` of the token's ``cfg.topk_group``
best of ``cfg.n_group`` groups, the held experts' part (SwiGLU,
``cfg.moe_ff`` wide) by sort-based dispatch, and a shared SwiGLU expert.
The logits are RMSNorm(x) W_head; the embedding is not scaled.

The parameters are stacked by kind: ``{"embedding", "dense": {"ln1",
"attn", "ln2", "mlp"}, "moe": {"ln1", "attn", "ln2", "moe"}, "ln_f"}``. The
serving cache is ``{"latent"}`` (layers, B, max_seq, kv_rank + rope), every
layer's [c_kv, k_pe] in the model's dtype, ``"pos"``, and ``"counters"``,
an int64 tensor of :data:`COUNTERS` that the expert layers add to on the
device in prefill and in every decode step. The family serves through
:mod:`~repro_torch.models.hybrid`'s walks over its own layer plan, so its
decode step advances the cache in place and may be captured
(:data:`CUDA_GRAPH_DECODE`). Prefill walks the batch in row groups of
about :data:`PREFILL_TOKENS` prompt tokens, so the per-head queries, keys
and values of its decompressed attention, and the expert layers' per-pair
rows, are those of one group at a time; it takes ``marks`` as
the Mamba2 hybrids' does (:data:`PREFILL_MARKS`). Serving only: the family
has no training loss and no sharding plan.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import hybrid, mla, moe
from repro_torch.models import layers as ly
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _init_layers, _unstack, init_generator

#: The decode step may be captured as a CUDA graph and replayed (see
#: :data:`repro_torch.models.hybrid.CUDA_GRAPH_DECODE`).
CUDA_GRAPH_DECODE = True
#: ``prefill`` takes ``marks`` (see :func:`repro_torch.models.hybrid.prefill_walk`).
PREFILL_MARKS = True
#: The names of the cache's ``"counters"``, in order.
COUNTERS = moe.COUNTERS
#: Prompt tokens a prefill row group holds (at least one row): at 4,096
#: tokens a row, 4 rows, whose per-head Q, K and V and per-pair expert rows
#: take a few GB at published widths.
PREFILL_TOKENS = 16384


def _init_block(ffn: str):
    body = {"mlp": ly.init_mlp, "moe": moe.init_routed_moe}[ffn]

    def block(gen, cfg, dev):
        return {"ln1": ly.init_rmsnorm(cfg.d_model, ly.dt(cfg), dev),
                "attn": mla.init_mla(gen, cfg, dev),
                "ln2": ly.init_rmsnorm(cfg.d_model, ly.dt(cfg), dev),
                ffn: body(gen, cfg, dev)}
    return block


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """Random parameters from ``generator`` on its device; without one, from
    seed 0 on ``device`` (default: the card; ``"meta"`` gives shapes and
    dtypes without storage): the embedding, the dense layers, the expert
    layers."""
    generator, dev = init_generator(generator, device)
    return {
        "embedding": ly.init_embedding(generator, cfg, dev),
        "dense": _init_layers(generator, cfg, dev, init_block=_init_block("mlp"),
                              n=cfg.dense_layers),
        "moe": _init_layers(generator, cfg, dev, init_block=_init_block("moe"),
                            n=cfg.n_layers - cfg.dense_layers),
        "ln_f": ly.init_rmsnorm(cfg.d_model, ly.dt(cfg), dev),
    }


def train_loss(params, cfg: ModelConfig, batch):
    raise NotImplementedError(f"{cfg.name}: the deepseek_v3 family is served only")


# -- serving ------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None):
    """An empty latent cache of ``max_seq`` positions for every layer, zero
    counters."""
    dev = resolve_device(device)
    return {
        "latent": torch.zeros((cfg.n_layers, B, max_seq, mla.latent_width(cfg)),
                              dtype=ly.dt(cfg), device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "counters": torch.zeros((len(COUNTERS),), dtype=torch.int64, device=dev),
    }


def _plan(params, cfg: ModelConfig) -> list[hybrid.Step]:
    """Each layer's latent attention at its slot of the latent cache, then
    its dense MLP or expert layer."""
    layers = [("mlp", p) for p in _unstack(params["dense"], cfg.dense_layers)]
    layers += [("moe", p) for p in _unstack(params["moe"], cfg.n_layers - cfg.dense_layers)]
    plan = []
    for i, (ffn, p) in enumerate(layers):
        plan += [hybrid.Step("mla", p["ln1"], p["attn"], i, None),
                 hybrid.Step(ffn, p["ln2"], p[ffn], None, None)]
    return plan


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, max_seq: int | None = None, marks=None):
    """Run the prompt through every layer, row group by row group (see the
    module's docstring): (last-token logits, primed cache); see
    :func:`repro_torch.models.hybrid.prefill_walk`, which appends to
    ``marks`` (a list) after each layer."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or S, device=tokens.device)
    plan = _plan(params, cfg)
    rows = max(1, PREFILL_TOKENS // S)
    logits = []
    for lo in range(0, B, rows):
        part = {**cache, "latent": cache["latent"][:, lo:lo + rows]}
        lg, part = hybrid.prefill_walk(params, cfg, plan, tokens[lo:lo + rows], part, marks)
        logits.append(lg)
    cache["pos"] = part["pos"]
    return torch.cat(logits), cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache):
    """One decode step, advancing ``cache`` in place (the counters added
    to); see :func:`repro_torch.models.hybrid.decode_walk`."""
    return hybrid.decode_walk(params, cfg, _plan(params, cfg), token, cache)
