"""AdamW, hand-rolled, as the reference package's ``repro/train/optimizer.py``.

Parameters live in the model dtype (bf16); first and second moments are
float32. The update follows the reference's operation order — global norm
from float32 squares, clip scale ``min(1, clip / max(norm, 1e-9))``,
``b ** step`` in float32, the parameter updated in float32 and cast back —
which ``torch.optim.AdamW`` does not (its eps and bias corrections differ,
and it has no global-norm clip).

:func:`adamw_update` updates the parameters and moments IN PLACE (the
reference returns new arrays; the values are the same) and returns them,
so a full-size step allocates no second copy of the state. Keep a copy of
a tree that is needed from before the update.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params):
    """Zero float32 moments shaped like ``params`` and a 0-d int32 step, on
    the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves in
    the reference's (sorted-key) order."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics); updates in place (see the
    module docstring)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step_f = step.to(torch.float32)
    c1 = 1 - cfg.b1 ** step_f
    c2 = 1 - cfg.b2 ** step_f

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = p.to(torch.float32)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - cfg.lr * delta)

    leaves = [tree_leaves(t) for t in (params, grads, state["m"], state["v"])]
    if len({len(part) for part in leaves}) != 1:
        raise ValueError("params, grads and moments must have one structure")
    for p, g, m, v in zip(*leaves):
        upd(p, g, m, v)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gnorm}
