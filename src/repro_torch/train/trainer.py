"""Fault-tolerant training loop: checkpoint/restart, async erasure-coded
checkpoints, deterministic data — the port of the reference package's
``repro/train/trainer.py``.

Runs on one device (the card unless ``device="cpu"``). Restart from failure
is exercised by rebuilding the trainer mid-run from its store: state comes
back from any k of n checkpoint strips and the data pipeline resumes at the
recorded step with bit-identical batches.

Fresh parameters come from a ``torch.Generator`` seeded with ``cfg.seed``
(JAX's PRNG streams cannot be reproduced in torch); tests that need the
reference's parameters set ``params`` and ``opt_state`` before ``run``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.core.controller import Policy
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.config import ShapeSpec
from repro_torch.models.registry import Arch
from repro_torch.storage.backend import ObjectStore
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    seed: int = 0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class Trainer:
    def __init__(
        self,
        arch: Arch,
        shape: ShapeSpec,
        store: ObjectStore,
        *,
        cfg: TrainerConfig | None = None,
        ckpt_prefix: str = "ckpt",
        ckpt_policy: Policy | None = None,
        device=None,
    ):
        self.arch = arch
        self.shape = shape
        self.store = store
        self.cfg = cfg or TrainerConfig()
        self.ckpt_prefix = ckpt_prefix
        self.device = resolve_device(device)
        self.data = SyntheticTokens(arch.cfg, shape, seed=self.cfg.seed)
        self.step_fn = make_train_step(arch, self.cfg.opt)
        self.ckpt = AsyncCheckpointer(store, ckpt_prefix, policy=ckpt_policy, device=self.device)
        self.metrics_log: list[dict] = []

        resume = latest_step(store, ckpt_prefix)
        if resume is not None:
            params_like = arch.init(device="meta")
            opt_like = {"m": params_like, "v": params_like,
                        "step": torch.empty((), dtype=torch.int32, device="meta")}
            state = restore_checkpoint(store, ckpt_prefix, resume,
                                       {"params": params_like, "opt": opt_like},
                                       device=self.device)
            self.params = state["params"]
            self.opt_state = state["opt"]
            self.start_step = resume
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
            self.params = arch.init(gen)
            self.opt_state = init_opt_state(self.params)
            self.start_step = 0

    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps if steps is not None else self.cfg.total_steps
        t0 = time.monotonic()
        end = min(self.start_step + steps, self.cfg.total_steps)
        for step in range(self.start_step, end):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch_at(step).items()}
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            if (step + 1) % self.cfg.log_every == 0 or step == end - 1:
                rec = {
                    "step": step + 1,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "wall_s": time.monotonic() - t0,
                }
                self.metrics_log.append(rec)
            if (step + 1) % self.cfg.ckpt_every == 0 or step == end - 1:
                self.ckpt.submit(step + 1, {"params": self.params, "opt": self.opt_state})
        self.ckpt.wait()
        self.start_step = end
        return self.metrics_log
