"""Architecture registry: one API over the port's model families.

Mirrors the reference package's ``repro/models/registry.py`` for the dense
family (the others wait for ROADMAP item 13). Every entry exposes
``init(generator, device)``, ``train_loss(params, batch)``,
``prefill(params, batch, max_seq)``,
``decode_step(params, token, cache)``, ``init_cache(B, max_seq, device)``
and ``prefill_tokens(params, tokens, max_seq)``, plus batch builders for
tests and examples and :func:`params_from_numpy`, which carries the
reference's parameters across.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import layers, lm
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.tree import tree_map

_FAMILY_MODULES = {"dense": lm}


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

    def prefill_tokens(self, params, tokens, max_seq=None):
        """Tokens-only prefill (fused-serving contract): (B, S) int32 tensor
        in, (logits, cache) out."""
        return self.module.prefill_tokens(params, self.cfg, tokens, max_seq)


def _configs(smoke: bool):
    # Imported lazily: repro_torch.configs modules import
    # repro_torch.models.config, which would otherwise make this circular.
    from repro_torch.configs import ALL_CONFIGS, SMOKE_CONFIGS

    return SMOKE_CONFIGS if smoke else ALL_CONFIGS


def get(name: str, smoke: bool = False) -> Arch:
    cfgs = _configs(smoke)
    if name not in cfgs:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(cfgs)} (the other "
                       "families wait for ROADMAP.md item 13)")
    cfg = cfgs[name]
    return Arch(cfg=cfg, module=_FAMILY_MODULES[cfg.family])


def arch_names() -> list[str]:
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

    batch = {"tokens": ids()}
    if shape.kind == "train":
        batch["labels"] = ids()
    return batch


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """A parameter tree of numpy arrays (nested dicts, as the reference's
    ``jax.tree.map(np.asarray, params)`` gives them) → the port's tensors
    with the same keys, floating leaves in ``cfg.dtype``, on ``device``
    (default: the card). bfloat16 arrays pass through float32 (exact), since
    ``torch.from_numpy`` refuses that dtype."""
    dev = resolve_device(device)
    dtype = layers.dt(cfg)

    def leaf(a):
        a = np.array(a)  # a writable copy: the reference's arrays are read-only
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        t = torch.from_numpy(a).to(dev)
        return t.to(dtype) if t.is_floating_point() else t

    return tree_map(leaf, tree)
