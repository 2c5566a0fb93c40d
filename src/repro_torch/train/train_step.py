"""Train and eval steps, as the reference package's ``repro/train/train_step.py``.

``make_train_step(arch)`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and its gradients by autograd,
optionally accumulated over ``cfg.grad_accum`` microbatches, then AdamW.
The AdamW math runs in float32 against float32 moments.

``batch_logical_axes``, ``param_specs`` and ``opt_state_specs`` give the
sharding plan's specs (:mod:`repro_torch.models.sharding`); the port's
step runs on one card whatever they say.
"""

from __future__ import annotations

import torch

from repro_torch.models.registry import Arch
from repro_torch.models.sharding import tree_specs
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def batch_logical_axes(cfg):
    axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.family == "encdec":
        axes["frames"] = ("batch", None, None)
    if cfg.family == "vlm":
        axes["patches"] = ("batch", None, None)
    return axes


def param_specs(arch: Arch, params_shapes):
    """Spec tree for params (needs an active ``axis_rules`` context; every
    spec is ``()`` outside one). ``params_shapes``: tensors (``meta`` ones
    will do) or shapes."""
    return tree_specs(params_shapes, arch.logical_axes())


def opt_state_specs(p_specs):
    return {"m": p_specs, "v": p_specs, "step": ()}


def value_and_grad(arch: Arch, params, batch):
    """(loss, grads) of ``arch.train_loss`` at ``params``: the loss detached,
    the gradients in a tree of ``params``' structure."""
    leaves = [leaf for _, leaf in tree_flatten(params)]
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss = arch.train_loss(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(arch: Arch, opt_cfg: AdamWConfig | None = None):
    opt_cfg = opt_cfg or AdamWConfig()
    accum = max(1, arch.cfg.grad_accum)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = value_and_grad(arch, params, batch)
        else:
            # Microbatching: one microbatch's activations live at a time.
            # Gradients accumulate in the parameter dtype, in order, as the
            # reference's scan does.
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(torch.zeros_like, params)
            loss = torch.zeros((), dtype=torch.float32, device=micro["tokens"].device)
            for i in range(accum):
                mb_loss, mb_grads = value_and_grad(arch, params, {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, g: a + g.to(a.dtype), grads, mb_grads)
                loss = loss + mb_loss
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(arch: Arch):
    @torch.no_grad()
    def eval_step(params, batch):
        return arch.train_loss(params, batch)

    return eval_step


def abstract_state(arch: Arch):
    """(params, opt_state) trees of ``meta`` tensors: shapes and dtypes
    without allocation."""
    params = arch.init(device="meta")
    return params, init_opt_state(params)
