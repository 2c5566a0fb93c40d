"""Queueing approximations of the paper (§IV-A, Eq.2-5).

All functions take the class delay parameters {Δ̄, Δ̃, Ψ̄, Ψ̃}, file size J
[MB], code (k, r) with n = k·r, and the thread count L.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.delay_model import DelayParams


def service_delay_exact(p: DelayParams, J: float, k: float, n: float) -> float:
    """Eq.2 first line: Δ(J/k) + (1/μ)(Σ_{j=0}^{k-1} 1/(n-j)), integer k, n."""
    B = J / k
    hsum = sum(1.0 / (n - j) for j in range(int(round(k))))
    return p.delta(B) + p.tail_mean(B) * hsum


def service_delay(p: DelayParams, J: float, k: float, r: float) -> float:
    """Eq.2 (log approximation, continuous k, r):

    D_s = Δ̄ + Δ̃J/k + (Ψ̄ + Ψ̃J/k)·ln(r / (r-1)).
    """
    B = J / k
    if r <= 1.0:
        # r = 1 means no redundancy: k-of-k join; ln(r/(r-1)) → ∞ in the
        # approximation. Use the exact harmonic form with n = k.
        return service_delay_exact(p, J, k, max(k, 1.0))
    return p.delta(B) + p.tail_mean(B) * math.log(r / (r - 1.0))


def usage(p: DelayParams, J: float, k: float, r: float) -> float:
    """Eq.3 expected system usage (thread-seconds per request):

    U = Δ̄·k·r + Δ̃·J·r + Ψ̄·k + Ψ̃·J.
    """
    return p.delta_bar * k * r + p.delta_tilde * J * r + p.psi_bar * k + p.psi_tilde * J


def queueing_delay(lam: float, U_bar: float, L: int) -> float:
    """Eq.4 M/M/1 approximation with service rate L/Ū:

    D_q = λŪ² / (L(L − λŪ)).  Infinite if λŪ ≥ L.
    """
    lam_bar = lam * U_bar
    if lam_bar >= L:
        return math.inf
    return lam_bar * U_bar / (L * (L - lam_bar))


def queue_length(lam: float, U_bar: float, L: int) -> float:
    """Eq.5: Q = λ̄² / (L(L − λ̄)) with λ̄ = λŪ."""
    lam_bar = lam * U_bar
    if lam_bar >= L:
        return math.inf
    return lam_bar**2 / (L * (L - lam_bar))


def lambda_bar_from_queue(Q: float, L: int) -> float:
    """Invert Eq.5: λ̄ = L(√(Q² + 4Q) − Q)/2 (paper, below Corollary 1)."""
    if math.isinf(Q):
        return float(L)
    return L * (math.sqrt(Q * Q + 4.0 * Q) - Q) / 2.0


def capacity(p: DelayParams, J: float, k: float, r: float, L: int) -> float:
    """Max sustainable arrival rate λ for a single class: L / U(k, r)."""
    return L / usage(p, J, k, r)


def total_delay(p: DelayParams, J: float, k: float, r: float, L: int, lam: float) -> float:
    """D_q + D_s for a single-class static (n=rk, k) strategy at rate λ."""
    U = usage(p, J, k, r)
    return queueing_delay(lam, U, L) + service_delay(p, J, k, r)
