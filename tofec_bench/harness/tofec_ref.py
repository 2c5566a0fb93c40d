"""The plain reference of TOFEC's controller (§IV-B, §IV-C), and the
recorder that hands it the backlog the program's controller saw.

The reference works the thresholds out again from the delay model's four
constants, the file size, k_max, r_max, n_max and L, in float64:

* Eq. 6 links r to k: k(Ψ̄k + Ψ̃J) / (Δ̄k + Δ̃J)
  = J·r(r−1)·(Δ̃ + Ψ̃·ln(r/(r−1))) / (Δ̄r + Ψ̄), solved for r by bisection
  (its right side grows with r);
* Eq. 7 gives the load at which k is optimal,
  λ̄ = L(1 − 1/√(1 + π)), π = 2L(Ψ̄k + Ψ̃J) / (k·r(r−1)·(Δ̄k + Δ̃J))
  (the paper's printed factor 2), and Eq. 5 the backlog Q = λ̄² / (L(L − λ̄));
* the thresholds are the midpoints of Q at consecutive k (and at the k where
  k·r = n, for n), with H_1 = ∞ and the last 0;
* each arrival updates q̄ ← αq + (1 − α)q̄ (the first sets q̄ = q), takes
  k = 1 + #{H_j > q̄} and n likewise, caps n at r_max·k and raises it to k.

The proxy then keeps k to a level its layout has and n to that level's
chunks (:func:`clamp`).
"""

from __future__ import annotations

import math
import threading

from repro_torch.core.controller import Policy


def _eq6_r(p, J: float, k: float) -> float:
    db, dt, pb, pt = p
    target = k * (pb * k + pt * J) / (db * k + dt * J)

    def rhs(r):
        return J * r * (r - 1) * (dt + pt * math.log(r / (r - 1))) / (db * r + pb)

    lo, hi = 1.0 + 1e-12, 2.0
    while rhs(hi) < target:
        hi *= 2.0
        if hi > 1e6:
            return 1e6
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if rhs(mid) < target else (lo, mid)
    return 0.5 * (lo + hi)


def _q_of_k(p, J: float, k: float, L: int) -> float:
    db, dt, pb, pt = p
    r = _eq6_r(p, J, k)
    pi = 2.0 * L * (pb * k + pt * J) / (k * r * (r - 1) * (db * k + dt * J))
    lam = L * (1.0 - 1.0 / math.sqrt(1.0 + pi))
    return math.inf if lam >= L else lam * lam / (L * (L - lam))


def _k_for_n(p, J: float, n: int, k_max: int) -> float:
    def n_of(k):
        return k * _eq6_r(p, J, k)

    lo, hi = 1e-9, float(max(4 * k_max, 8))
    while n_of(hi) < n:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if n_of(mid) < n else (lo, mid)
    return 0.5 * (lo + hi)


def _thresholds(q: list[float]) -> list[float]:
    return [math.inf] + [0.5 * (q[j] + q[j - 1]) for j in range(1, len(q))] + [0.0]


class TofecReference:
    def __init__(self, delay, file_mb: float, *, k_max: int, r_max: float, n_max: int, L: int,
                 alpha: float = 0.99):
        p = (delay.delta_bar, delay.delta_tilde, delay.psi_bar, delay.psi_tilde)
        self.k_max, self.r_max, self.n_max, self.alpha = k_max, r_max, n_max, alpha
        self.h_k = _thresholds([_q_of_k(p, file_mb, float(k), L) for k in range(1, k_max + 1)])
        self.h_n = _thresholds([_q_of_k(p, file_mb, _k_for_n(p, file_mb, n, k_max), L)
                                for n in range(1, n_max + 1)])

    def picks(self, qs) -> list[tuple[int, int]]:
        """(n, k) for each backlog in ``qs``, in arrival order."""
        out, q_bar = [], None
        for q in qs:
            q_bar = float(q) if q_bar is None else self.alpha * q + (1.0 - self.alpha) * q_bar
            k = min(1 + sum(h > q_bar for h in self.h_k[1:]), self.k_max)
            n = min(1 + sum(h > q_bar for h in self.h_n[1:]), self.n_max)
            n = min(int(self.r_max * k), n)
            out.append((max(n, k), k))
        return out


def clamp(pick: tuple[int, int], K: int, N: int) -> tuple[int, int]:
    """The code a shared-key layout of (N, K) strips serves for a pick: the
    largest k that divides K and is at most the pick's, and n between k and
    the N·k/K chunks that level has."""
    n, k = pick
    k = max(d for d in range(1, K + 1) if K % d == 0 and d <= k)
    return max(k, min(n, N * k // K)), k


class Recorder(Policy):
    """Hands every ``select`` to the program's policy and keeps the backlog
    it was given and the pick, in call order."""

    def __init__(self, inner: Policy):
        self.inner = inner
        self.calls: list[tuple[float, tuple[int, int]]] = []
        self._lock = threading.Lock()

    def select(self, *, q, idle, cls_id=0, now=None):
        with self._lock:
            pick = self.inner.select(q=q, idle=idle, cls_id=cls_id, now=now)
            self.calls.append((q, tuple(pick)))
            return pick

    def reset(self) -> None:
        self.inner.reset()
