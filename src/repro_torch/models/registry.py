"""Architecture registry: one API over the port's model families.

Mirrors the reference package's ``repro/models/registry.py`` for all six
families: dense, moe and vlm (:mod:`~repro_torch.models.lm`), encdec, ssm
(:mod:`~repro_torch.models.xlstm`) and hybrid; and serves the port's own
nemotron_h and deepseek_v3 families (:mod:`~repro_torch.models.nemotron_h`,
:mod:`~repro_torch.models.deepseek_v3`), which :func:`arch_names` leaves
out. Every entry exposes
``init(generator, device)``, ``train_loss(params, batch)``,
``prefill(params, batch, max_seq)``,
``decode_step(params, token, cache)``, ``init_cache(B, max_seq, device)``,
``prefill_tokens(params, tokens, max_seq)`` and ``logical_axes()`` (the
sharding plan's, :mod:`repro_torch.models.sharding`), plus batch builders for
tests and examples and :func:`params_from_numpy`, which carries the
reference's parameters across.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import deepseek_v3, encdec, hybrid, lm, nemotron_h, xlstm
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec, cell_is_runnable
from repro_torch.tree import tree_map

_FAMILY_MODULES = {**{family: lm for family in lm.FAMILIES}, "encdec": encdec, "ssm": xlstm,
                   "hybrid": hybrid, "nemotron_h": nemotron_h, "deepseek_v3": deepseek_v3}


def zero_extras(cfg: ModelConfig, tokens: torch.Tensor) -> dict:
    """``{"tokens": tokens}`` plus the all-zero float32 frames (encdec) or
    patches (vlm) that the serving paths feed a family with a non-token
    input, as the reference's do (the serving tower has no audio or image
    side), on the tokens' device."""
    batch = {"tokens": tokens}
    extra = {"encdec": ("frames", cfg.encoder_seq), "vlm": ("patches", cfg.vision_patches)}
    if cfg.family in extra:
        name, length = extra[cfg.family]
        batch[name] = torch.zeros((tokens.shape[0], length, cfg.d_model), dtype=torch.float32,
                                  device=tokens.device)
    return batch


@dataclasses.dataclass(frozen=True)
class Arch:
    cfg: ModelConfig
    module: types.ModuleType

    @property
    def name(self) -> str:
        return self.cfg.name

    def init(self, generator: torch.Generator | None = None, device=None):
        """Random parameters from ``generator`` (its device), or from seed 0 on
        ``device`` (default: the card; ``"meta"`` gives shapes without
        storage)."""
        return self.module.init(self.cfg, generator=generator, device=device)

    def train_loss(self, params, batch):
        return self.module.train_loss(params, self.cfg, batch)

    def prefill(self, params, batch, max_seq=None):
        return self.module.prefill(params, self.cfg, batch, max_seq)

    def decode_step(self, params, token, cache):
        return self.module.decode_step(params, self.cfg, token, cache)

    def init_cache(self, B, max_seq, device=None):
        return self.module.init_cache(self.cfg, B, max_seq, device=device)

    def prefill_tokens(self, params, tokens, max_seq=None, **kw):
        """Tokens-only prefill (fused-serving contract): (B, S) int32 tensor
        in, (logits, cache) out; the batch gets the zero non-token extras
        (vlm patches, encdec frames) on the tokens' device. ``kw`` goes to
        the family's own (nemotron_h's and deepseek_v3's ``marks``)."""
        return self.module.prefill(params, self.cfg, zero_extras(self.cfg, tokens), max_seq,
                                   **kw)

    def logical_axes(self):
        return self.module.logical_axes(self.cfg)


def _configs(smoke: bool):
    """The architectures the port shares with the reference package."""
    # Imported lazily: repro_torch.configs modules import
    # repro_torch.models.config, which would otherwise make this circular.
    from repro_torch.configs import ALL_CONFIGS, SMOKE_CONFIGS

    return SMOKE_CONFIGS if smoke else ALL_CONFIGS


def _port_configs(smoke: bool):
    """The architectures only the port has."""
    from repro_torch.configs import PORT_CONFIGS, PORT_SMOKE_CONFIGS

    return PORT_SMOKE_CONFIGS if smoke else PORT_CONFIGS


def get(name: str, smoke: bool = False) -> Arch:
    cfgs = {**_configs(smoke), **_port_configs(smoke)}
    if name not in cfgs:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(cfgs)}")
    cfg = cfgs[name]
    return Arch(cfg=cfg, module=_FAMILY_MODULES[cfg.family])


def arch_names() -> list[str]:
    """The architectures the port shares with the reference package, in its
    order."""
    return list(_configs(False))



def make_batch(cfg: ModelConfig, shape: ShapeSpec, rng: np.random.Generator | None = None,
               *, device=None):
    """Concrete batch for prefill (and train shapes' labels), drawn with numpy
    as the reference's ``make_batch`` draws it, on ``device`` (default: the
    card)."""
    rng = rng or np.random.default_rng(0)
    dev = resolve_device(device)
    B, S = shape.batch, shape.seq

    def ids():
        return torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)).to(dev)

    def normal(length):
        return torch.from_numpy(rng.normal(size=(B, length, cfg.d_model)).astype(np.float32)).to(dev)

    batch = {"tokens": ids()}
    if shape.kind == "train":
        batch["labels"] = ids()
    if cfg.family == "encdec":
        batch["frames"] = normal(cfg.encoder_seq)
    if cfg.family == "vlm":
        batch["patches"] = normal(cfg.vision_patches)
    return batch


def params_from_numpy(tree, device=None):
    """A parameter tree of numpy arrays (nested dicts and lists, as the
    reference's ``jax.tree.map(np.asarray, params)`` gives them) → the
    port's tensors with the same structure, on ``device`` (default: the
    card). Each leaf keeps its own dtype: a bfloat16 model's float32 MoE
    router stays float32. bfloat16 arrays pass through float32 (exact),
    since ``torch.from_numpy`` refuses that dtype."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a)  # a writable copy: the reference's arrays are read-only
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
        return torch.from_numpy(a).to(dev)

    return tree_map(leaf, tree)


def runnable_cells(arch: str) -> list[tuple[str, bool, str]]:
    """[(shape_name, runnable, reason)] for the given architecture."""
    cfg = _configs(False)[arch]
    return [(s.name, *cell_is_runnable(cfg, s)) for s in SHAPES.values()]
