"""Code-selection policies for the exact task engine, on tensors.

The port of the reference package's ``repro/taskq/policies.py``. The engine
observes the *exact* proxy state at each arrival — the FIFO backlog length
``q`` and the idle-thread count ``idle`` — so policies here see what
:class:`repro_torch.core.controller.Policy` implementations see on the
host, not the fluid waiting-work proxy of :mod:`repro_torch.core.fluid_scan`.
Two policy families ride every grid row as data and are selected with
``torch.where`` on a per-row id, so a grid mixing threshold and greedy rows
runs in one scan:

* ``POL_TABLE`` — the threshold form ``1 + #{h > q̄}`` shared with the fleet
  (:func:`repro_torch.core.controller.tofec_threshold_step`), covering
  TOFEC, static codes and fixed-k via
  :func:`repro_torch.fleet.sweep.policy_tables`.
* ``POL_GREEDY`` — §V-A's Greedy heuristic, which needs the instantaneous
  idle-thread count the fluid scan cannot provide. :func:`greedy_select`
  is its tensor form, held select for select against
  :class:`repro_torch.core.controller.GreedyPolicy` in
  ``tests/test_torch_taskq.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.fleet.sweep import PolicySpec, policy_tables

#: Per-row policy ids (data, never a Python branch).
POL_TABLE = 0
POL_GREEDY = 1


def greedy_select(q, idle: torch.Tensor, k_max, r_max) -> tuple[torch.Tensor, torch.Tensor]:
    """§V-A Greedy on (G,) tensors: (n, k) from the idle-thread count.

    Chunk as much as idle threads allow (k = min(k_max, idle)), then add
    redundancy as long as idle threads remain (n = min(⌊r_max·k⌋, idle));
    fall back to the basic (1, 1) code when no thread is idle. ``q`` is
    accepted (and ignored) to mirror the host :meth:`Policy.select`
    observation. ``k_max`` and ``r_max`` may be (G,) tensors or numbers.
    Matches :class:`repro_torch.core.controller.GreedyPolicy` decision for
    decision, including the float32 truncation of ``int(r_max · k)``.
    """
    del q  # greedy keys on idle threads only (host parity)
    idle = torch.as_tensor(idle, dtype=torch.int32)
    dev = idle.device
    k = torch.minimum(torch.as_tensor(k_max, dtype=torch.int32, device=dev), idle)
    r = torch.as_tensor(r_max, dtype=torch.float32, device=dev)
    n = torch.minimum((r * k.to(torch.float32)).to(torch.int32), torch.clamp_min(idle, 1))
    n = torch.maximum(n, k)
    one = torch.ones_like(k)
    busy = idle <= 0
    return torch.where(busy, one, n), torch.where(busy, one, k)


@dataclasses.dataclass(frozen=True)
class EncodedPolicy:
    """One grid row's policy as data (tables zeroed for greedy — trailing
    zero thresholds are inert, the fleet's padding convention)."""

    pol: int          # POL_TABLE | POL_GREEDY
    h_k: np.ndarray   # (hk_len,) float32
    h_n: np.ndarray   # (hn_len,) float32
    r_max: float
    alpha: float
    gk_max: int       # greedy k_max (1 for table policies; inert)


def encode_policy(spec: PolicySpec, cls, L: int, hk_len: int, hn_len: int,
                  plan=None) -> EncodedPolicy:
    """Resolve a :class:`repro_torch.fleet.sweep.PolicySpec` for the task engine."""
    h_k = np.zeros(hk_len, np.float32)
    h_n = np.zeros(hn_len, np.float32)
    if spec.kind == "greedy":
        return EncodedPolicy(
            pol=POL_GREEDY, h_k=h_k, h_n=h_n, r_max=float(cls.r_max),
            alpha=spec.alpha, gk_max=int(cls.k_max),
        )
    hk, hn, r_max = policy_tables(spec, cls, L, plan)
    h_k[: len(hk)] = hk
    h_n[: len(hn)] = hn
    return EncodedPolicy(
        pol=POL_TABLE, h_k=h_k, h_n=h_n, r_max=float(r_max),
        alpha=spec.alpha, gk_max=1,
    )
