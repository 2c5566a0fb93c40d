"""Theorem-1 solver (§IV-B): optimal static codes and their Q-mapping.

Eq.6 (per class, workload independent — links k and r along the optimal
curve):

    k(Ψ̄k + Ψ̃J) / (Δ̄k + Δ̃J)
        = J·r(r−1)·(Δ̃ + Ψ̃·ln(r/(r−1))) / (Δ̄r + Ψ̄)

Eq.7 (workload coupling; the paper's printed form):

    (L/(L−λ̄))² − 1 = 2L(Ψ̄k + Ψ̃J) / (k·r(r−1)·(Δ̄k + Δ̃J))

NOTE on the factor 2: differentiating D_q = λŪ²/(L(L−λŪ)) by hand gives a
factor L (not 2L) on the right-hand side. We default to the paper's printed
2L (``eq7_factor=2.0``) for faithfulness; the factor only shifts the
Q ↔ (k, r) calibration slightly and preserves every monotonicity property
(Corollary 1) either way. ``eq7_factor=1.0`` selects our derivation.

From these we build, per class:
  * r_opt(k): bisection on the strictly-increasing RHS of Eq.6,
  * λ̄(k), Q(k) via Eq.7 + Eq.5,
  * the inverses K(Q), R(Q), N(Q) (Corollary 1: strictly decreasing), and
  * the threshold tables H^N, H^K of §IV-C.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import queueing
from repro_torch.core.delay_model import DelayParams, RequestClass


def _eq6_lhs(p: DelayParams, J: float, k: float) -> float:
    return k * (p.psi_bar * k + p.psi_tilde * J) / (p.delta_bar * k + p.delta_tilde * J)


def _eq6_rhs(p: DelayParams, J: float, r: float) -> float:
    if r <= 1.0:
        return 0.0
    lg = math.log(r / (r - 1.0))
    return (
        J
        * r
        * (r - 1.0)
        * (p.delta_tilde + p.psi_tilde * lg)
        / (p.delta_bar * r + p.psi_bar)
    )


def solve_r_for_k(p: DelayParams, J: float, k: float, *, r_hi: float = 1e6) -> float:
    """Solve Eq.6 for r given (continuous) k > 0. RHS is strictly increasing
    in r on (1, ∞), from 0 to ∞, so bisection is exact."""
    target = _eq6_lhs(p, J, k)
    lo, hi = 1.0 + 1e-12, 2.0
    while _eq6_rhs(p, J, hi) < target:
        hi *= 2.0
        if hi > r_hi:
            return r_hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _eq6_rhs(p, J, mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _eq7_rhs(p: DelayParams, J: float, k: float, r: float, L: int, factor: float) -> float:
    """π_i(k) with r = r_opt(k) substituted (paper appendix): RHS of Eq.7."""
    return (
        factor
        * L
        * (p.psi_bar * k + p.psi_tilde * J)
        / (k * r * (r - 1.0) * (p.delta_bar * k + p.delta_tilde * J))
    )


def lambda_bar_for_k(
    p: DelayParams, J: float, k: float, L: int, *, eq7_factor: float = 2.0
) -> float:
    """Close Eq.7 for λ̄ given k (and r = r_opt(k)):

    (L/(L−λ̄))² = 1 + π(k)  ⇒  λ̄ = L(1 − 1/√(1 + π(k))).
    """
    r = solve_r_for_k(p, J, k)
    pi = _eq7_rhs(p, J, k, r, L, eq7_factor)
    return L * (1.0 - 1.0 / math.sqrt(1.0 + pi))


def q_for_k(p: DelayParams, J: float, k: float, L: int, *, eq7_factor: float = 2.0) -> float:
    """Q at which (continuous) dimension k is optimal: Eq.5 at λ̄(k)."""
    lam_bar = lambda_bar_for_k(p, J, k, L, eq7_factor=eq7_factor)
    if lam_bar >= L:
        return math.inf
    return lam_bar**2 / (L * (L - lam_bar))


def _bisect_decreasing(fn, target: float, lo: float, hi: float, iters: int = 200) -> float:
    """Find x with fn(x) = target for strictly decreasing fn on [lo, hi]."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if fn(mid) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@dataclasses.dataclass
class ClassPlan:
    """Per-class solution tables: Q-grid ↔ (k, r, n) plus §IV-C thresholds."""

    cls: RequestClass
    L: int
    eq7_factor: float
    # Descending-Q tables, indexed by integer code parameter value:
    q_at_k: np.ndarray  # q_at_k[k-1] = K^{-1}(k) = Q at which dim k optimal
    q_at_n: np.ndarray  # q_at_n[n-1] = N^{-1}(n)
    h_k: np.ndarray  # thresholds H^K[1..k_max+1]; h_k[0] = inf, h_k[k_max] = 0
    h_n: np.ndarray  # thresholds H^N[1..n_max+1]

    def pick_k(self, q_ewma: float) -> int:
        """k s.t. q̄ ∈ [H_{k+1}, H_k), i.e. 1 + #{thresholds > q̄}."""
        k = int(np.searchsorted(-self.h_k[1:], -q_ewma, side="left")) + 1
        return min(k, self.cls.k_max)

    def pick_n(self, q_ewma: float) -> int:
        n = int(np.searchsorted(-self.h_n[1:], -q_ewma, side="left")) + 1
        return min(n, self.cls.n_max)

    def pick_code(self, q_ewma: float) -> tuple[int, int]:
        """TOFEC steps 4-6: (n, k) with the r_max cap applied."""
        k = self.pick_k(q_ewma)
        n = self.pick_n(q_ewma)
        n = min(int(self.cls.r_max * k), n)
        return max(n, k), k


def build_class_plan(
    cls: RequestClass, L: int, *, eq7_factor: float = 2.0
) -> ClassPlan:
    """Compute Q^K, Q^N and the threshold tables of §IV-C for one class."""
    p, J = cls.params, cls.file_mb

    q_at_k = np.array(
        [q_for_k(p, J, float(k), L, eq7_factor=eq7_factor) for k in range(1, cls.k_max + 1)]
    )

    # N(Q): n(k) = k · r_opt(k) is strictly increasing in k, so invert by
    # bisection on k for each integer n, then map through Q(k).
    def n_of_k(k: float) -> float:
        return k * solve_r_for_k(p, J, k)

    q_at_n = np.empty(cls.n_max)
    for n in range(1, cls.n_max + 1):
        if n_of_k(1e-9) >= n:  # n below the n(k) range: treat as k→0 (Q→∞)
            q_at_n[n - 1] = math.inf
            continue
        hi = float(max(cls.k_max * 4, 8))
        while n_of_k(hi) < n:
            hi *= 2.0
        k_sol = _bisect_decreasing(lambda k: -n_of_k(k), -float(n), 1e-9, hi)
        q_at_n[n - 1] = q_for_k(p, J, k_sol, L, eq7_factor=eq7_factor)

    def thresholds(q_tab: np.ndarray) -> np.ndarray:
        """H[0]=∞ (i.e. H_1), H[j] = (Q_{j+1} + Q_j)/2, last = 0 (§IV-C)."""
        m = len(q_tab)
        h = np.empty(m + 1)
        h[0] = math.inf
        for j in range(1, m):
            h[j] = 0.5 * (q_tab[j] + q_tab[j - 1])
        h[m] = 0.0
        return h

    return ClassPlan(
        cls=cls,
        L=L,
        eq7_factor=eq7_factor,
        q_at_k=q_at_k,
        q_at_n=q_at_n,
        h_k=thresholds(q_at_k),
        h_n=thresholds(q_at_n),
    )


def optimal_static_code(
    cls: RequestClass, L: int, lam: float, *, eq7_factor: float = 2.0
) -> tuple[float, float, float]:
    """Solve (*) for a single class at arrival rate λ: returns (k*, r*, Q*).

    Uses the fixed-point structure: Q ↦ (k, r) via Eq.6/7, then Eq.5
    consistency g(Q) = Q_implied − Q is strictly decreasing → bisection.
    """
    p, J = cls.params, cls.file_mb

    def k_for_q(Q: float) -> float:
        # q_for_k is strictly decreasing in k (Corollary 1).
        lo, hi = 1e-9, 1.0
        while q_for_k(p, J, hi, L, eq7_factor=eq7_factor) > Q and hi < 1e6:
            hi *= 2.0
        return _bisect_decreasing(
            lambda k: q_for_k(p, J, k, L, eq7_factor=eq7_factor), Q, lo, hi
        )

    def implied_q(Q: float) -> float:
        k = k_for_q(Q)
        r = solve_r_for_k(p, J, k)
        U = queueing.usage(p, J, k, r)
        return queueing.queue_length(lam, U, L)

    lo, hi = 1e-9, 1.0
    while implied_q(hi) > hi:
        hi *= 2.0
        if hi > 1e9:
            break
    Q = _bisect_decreasing(lambda q: implied_q(q) - q, 0.0, lo, hi)
    k = k_for_q(Q)
    r = solve_r_for_k(p, J, k)
    return k, r, Q
