"""The benchmark's seeded weights, made on the device in the port's tree.

The tree's shapes and dtypes come from the model's own ``init`` on
``meta`` (no storage); each leaf is then drawn whole, in its own dtype, by
one call of a ``torch.Generator`` on the device, stacked layers and all.
Each leaf's law, by its name:

* matrices: normal / √fan-in (fan-in is the second-to-last axis);
* ``embed``: standard normal;
* ``scale`` (RMSNorm, applied as 1 + scale): normal × 0.1;
* ``conv``: uniform in ±1/√taps (a depthwise conv's fan-in);
* Mamba2's ``A_log``: log of uniform [1, 16]; ``dt_bias``: softplus⁻¹ of
  dt, with log dt uniform in [log 0.001, log 0.1]; ``D``: ones (the
  published Mamba2 initialisation);
* biases: zeros.

The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def _fill(name: str, like: torch.Tensor, gen: torch.Generator, device) -> torch.Tensor:
    shape, dtype = like.shape, like.dtype

    def uniform(lo, hi):
        return torch.rand(shape, dtype=dtype, device=device, generator=gen).mul_(hi - lo).add_(lo)

    if name == "A_log":
        return uniform(1.0, 16.0).log_()
    if name == "dt_bias":
        dt = uniform(math.log(1e-3), math.log(1e-1)).exp_()
        return dt + torch.log(-torch.expm1(-dt))
    if name == "D":
        return torch.ones(shape, dtype=dtype, device=device)
    if name.startswith("b") and len(shape) <= 2:
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "conv":
        bound = 1.0 / math.sqrt(shape[-2])
        return uniform(-bound, bound)
    x = torch.randn(shape, dtype=dtype, device=device, generator=gen)
    if name == "embed":
        return x
    if name == "scale":
        return x.mul_(0.1)
    return x.mul_(1.0 / math.sqrt(shape[-2]))


def seeded_params(arch, seed: int, device) -> dict:
    """``arch``'s parameters, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = tree_flatten(arch.init(device="meta"))
    leaves = [_fill(str(path[-1]), like, gen, device) for path, like in flat]
    return tree_unflatten(arch.init(device="meta"), leaves)
