"""Policies as threshold tables — the part of the fleet sweep the serving
step needs.

The scan's controller is the threshold form ``1 + #{h > q̄}``;
:func:`static_tables` and :func:`fixedk_tables` encode static (n, k) codes
and the fixed-k adaptive strategy of [3] into the same (h_k, h_n, r_max)
triple (sentinel-``BIG``/0 thresholds pin the choice), so
:class:`repro_torch.serve.engine.ServePolicy` runs every threshold policy
through one controller. These helpers are numpy-only copies of the reference
package's ``repro/fleet/sweep.py``; its sweep engine is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.controller import BIG, FixedKAdaptivePolicy
from repro_torch.core.delay_model import RequestClass
from repro_torch.core.static_optimizer import ClassPlan, build_class_plan


# ---------------------------------------------------------------------------
# Policies as threshold tables
# ---------------------------------------------------------------------------


def static_tables(n: int, k: int, k_max: int, n_max: int):
    """(h_k, h_n, r_max) pinning the controller to the static code (n, k).

    With the threshold rule ``k = 1 + #{h[1:] > q̄}``, k-1 leading ``BIG``
    entries and trailing zeros select k for every q̄ ≥ 0; same for n. The
    half-chunk slack in r_max keeps the float cap ``int(r_max·k)`` == n.
    """
    if not 1 <= k <= n <= n_max or k > k_max:
        raise ValueError(f"invalid static code ({n},{k}) for k_max={k_max}, n_max={n_max}")
    h_k = np.zeros(k_max + 1, np.float32)
    h_k[:k] = BIG
    h_n = np.zeros(n_max + 1, np.float32)
    h_n[:n] = BIG
    return h_k, h_n, (n + 0.5) / k


def fixedk_tables(cls: RequestClass, L: int, k: int, *, eq7_factor: float = 2.0):
    """(h_k, h_n, r_max) for the fixed-k, adaptive-n strategy of [3].

    Reuses :class:`repro_torch.core.controller.FixedKAdaptivePolicy`'s Q→n table,
    re-indexed into the scan's 1-based threshold form: k-1 ``BIG`` entries
    shift the count so ``1 + #{h_n > q̄}`` lands on n ∈ [k, n_max].
    """
    pol = FixedKAdaptivePolicy(cls, L, k=k, eq7_factor=eq7_factor)
    h_k = np.zeros(cls.k_max + 1, np.float32)
    h_k[:k] = BIG
    h_n = np.concatenate([[BIG] * k, pol.h_n[1:]]).astype(np.float32)
    h_n = np.where(np.isinf(h_n), BIG, h_n)
    assert h_n.shape == (cls.n_max + 1,)
    return h_k, h_n, (cls.n_max + 0.5) / k


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Declarative policy for a grid point: tofec | static | fixedk | greedy.

    ``greedy`` (§V-A idle-thread heuristic) is NOT table-expressible — it
    observes the instantaneous idle-thread count, which the fluid scan does
    not model. Greedy grid points only run on the exact task-level engine
    (the reference package's ``repro.taskq.TaskqSweep``, not yet ported);
    :func:`policy_tables` raises for them.
    """

    kind: str
    n: int = 0
    k: int = 0
    alpha: float = 0.99
    eq7_factor: float = 2.0

    @classmethod
    def tofec(cls, alpha: float = 0.99, eq7_factor: float = 2.0) -> "PolicySpec":
        return cls("tofec", alpha=alpha, eq7_factor=eq7_factor)

    @classmethod
    def static(cls, n: int, k: int) -> "PolicySpec":
        return cls("static", n=n, k=k)

    @classmethod
    def fixedk(cls, k: int, eq7_factor: float = 2.0) -> "PolicySpec":
        return cls("fixedk", k=k, eq7_factor=eq7_factor)

    @classmethod
    def greedy(cls) -> "PolicySpec":
        return cls("greedy")

    @property
    def name(self) -> str:
        if self.kind == "static":
            return f"static({self.n},{self.k})"
        if self.kind == "fixedk":
            return f"fixedk(k={self.k})"
        if self.kind == "greedy":
            return "greedy"
        return "tofec"


def policy_tables(spec: PolicySpec, cls: RequestClass, L: int, plan: ClassPlan | None = None):
    """Resolve a :class:`PolicySpec` to (h_k, h_n, r_max) numpy tables."""
    if spec.kind == "static":
        return static_tables(spec.n, spec.k, cls.k_max, cls.n_max)
    if spec.kind == "fixedk":
        return fixedk_tables(cls, L, spec.k, eq7_factor=spec.eq7_factor)
    if spec.kind == "tofec":
        plan = plan or build_class_plan(cls, L, eq7_factor=spec.eq7_factor)
        h_k = np.where(np.isinf(plan.h_k), BIG, plan.h_k).astype(np.float32)
        h_n = np.where(np.isinf(plan.h_n), BIG, plan.h_n).astype(np.float32)
        return h_k, h_n, float(cls.r_max)
    if spec.kind == "greedy":
        raise ValueError(
            "greedy is not table-expressible (it observes idle threads, not "
            "backlog); run it on the exact task engine: repro.taskq.TaskqSweep"
        )
    raise ValueError(f"unknown policy kind {spec.kind!r}")

