"""Code-selection policies (§IV-C, §V-A).

Every policy answers one question at request-arrival time: which (n, k) MDS
code serves this request. Inputs available to a policy (mirroring what the
paper's proxy can observe locally): the instantaneous request-queue length
``q`` and the number of idle threads ``idle``.

Policies:
  * StaticPolicy(n, k)           — the paper's static strategies (incl. basic
                                   (1,1) and simple replication (2,1)).
  * TOFECPolicy                  — the paper's adaptive algorithm: EWMA of q
                                   against the H^N / H^K threshold tables.
  * GreedyPolicy                 — §V-A heuristic from idle-thread count.
  * FixedKAdaptivePolicy         — the strategy of [3]: k fixed, n adapted
                                   (backlog-driven via the same machinery).

Tensor forms of the TOFEC and MPC updates (:func:`tofec_threshold_step`,
:func:`mpc_step`) run the controller on the device inside the fused serving
step. Everything there is float32; they are held draw for draw against the
host policies and the reference package's JAX forms.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.delay_model import RequestClass
from repro_torch.core.static_optimizer import ClassPlan, build_class_plan


class Policy:
    """Interface: observe arrival, emit (n, k)."""

    name: str = "policy"

    def select(self, *, q: int, idle: int, cls_id: int = 0, now: float | None = None) -> tuple[int, int]:
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - default no state
        pass


@dataclasses.dataclass
class StaticPolicy(Policy):
    n: int
    k: int

    def __post_init__(self):
        if self.n < self.k or self.k < 1:
            raise ValueError(f"invalid static code ({self.n},{self.k})")
        self.name = f"static({self.n},{self.k})"

    def select(self, *, q: int, idle: int, cls_id: int = 0, now: float | None = None) -> tuple[int, int]:
        return self.n, self.k


class TOFECPolicy(Policy):
    """The paper's algorithm (§IV-C pseudocode), per-class thresholds.

    q̄ ← αq + (1−α)q̄ on each arrival; k and n from threshold lookup;
    n ← min(r_max·k, n); guard n ≥ k.
    """

    def __init__(self, plans: list[ClassPlan], alpha: float = 0.99):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("memory factor must be in (0, 1]")
        self.plans = plans
        self.alpha = alpha
        self.name = f"tofec(alpha={alpha})"
        self.reset()

    @classmethod
    def for_classes(
        cls, classes: list[RequestClass], L: int, alpha: float = 0.99, eq7_factor: float = 2.0
    ) -> "TOFECPolicy":
        return cls([build_class_plan(c, L, eq7_factor=eq7_factor) for c in classes], alpha)

    def reset(self) -> None:
        # None = cold start: the first observation seeds the EWMA directly
        # (an EWMA initialized from 0 would bias early picks toward low q̄,
        # hence toward under-chunked codes). Device scans use a -1.0 carry
        # sentinel for the same rule — see tofec_threshold_step.
        self.q_ewma = None

    def select(self, *, q: int, idle: int, cls_id: int = 0, now: float | None = None) -> tuple[int, int]:
        if self.q_ewma is None:
            self.q_ewma = float(q)
        else:
            self.q_ewma = self.alpha * q + (1.0 - self.alpha) * self.q_ewma
        return self.plans[cls_id].pick_code(self.q_ewma)


@dataclasses.dataclass
class GreedyPolicy(Policy):
    """§V-A Greedy: chunk as much as idle threads allow, then add redundancy.

    Paper's printed formula sets n = min(k_max, l) which would force n = k;
    the prose ("then increase the redundancy ratio as long as there are idle
    threads remain") implies n = min(r_max·k, l). We implement the prose and
    note the discrepancy.
    """

    k_max: int
    r_max: float

    def __post_init__(self):
        self.name = "greedy"

    def select(self, *, q: int, idle: int, cls_id: int = 0, now: float | None = None) -> tuple[int, int]:
        if idle <= 0:
            return 1, 1
        k = min(self.k_max, idle)
        n = min(int(self.r_max * k), max(idle, 1))
        return max(n, k), k


class FixedKAdaptivePolicy(Policy):
    """The adaptive strategy of [3]: fixed code dimension k, n adapted to
    backlog. Uses the Eq.7-analogue at fixed k: r(r−1) =
    f·L(Ψ̄k + Ψ̃J) / (k(Δ̄k + Δ̃J)((L/(L−λ̄))² − 1)), n = k·r, thresholded
    the same way as TOFEC.
    """

    def __init__(
        self,
        cls_: RequestClass,
        L: int,
        k: int,
        alpha: float = 0.99,
        eq7_factor: float = 2.0,
    ):
        self.cls = cls_
        self.k = k
        self.alpha = alpha
        self.name = f"fixedk(k={k})"
        p, J = cls_.params, cls_.file_mb
        c = (
            eq7_factor
            * L
            * (p.psi_bar * k + p.psi_tilde * J)
            / (k * (p.delta_bar * k + p.delta_tilde * J))
        )

        # Q at which n is optimal (n = k..n_max): from r = n/k,
        # (L/(L−λ̄))² − 1 = c / (r(r−1)) → λ̄ → Q.
        def q_for_n(n: int) -> float:
            r = n / k
            if r <= 1.0:
                return math.inf  # n = k only optimal at overload (Q → ∞)
            pi = c / (r * (r - 1.0))
            lam_bar = L * (1.0 - 1.0 / math.sqrt(1.0 + pi))
            return lam_bar**2 / (L * (L - lam_bar))

        n_values = list(range(k, cls_.n_max + 1))
        q_tab = np.array([q_for_n(n) for n in n_values])
        h = np.empty(len(n_values) + 1)
        h[0] = math.inf
        for j in range(1, len(n_values)):
            h[j] = 0.5 * (q_tab[j] + q_tab[j - 1])
        h[-1] = 0.0
        self.n_values = n_values
        self.h_n = h
        self.reset()

    def reset(self) -> None:
        self.q_ewma = None  # cold-start sentinel, see TOFECPolicy.reset

    def select(self, *, q: int, idle: int, cls_id: int = 0, now: float | None = None) -> tuple[int, int]:
        if self.q_ewma is None:
            self.q_ewma = float(q)
        else:
            self.q_ewma = self.alpha * q + (1.0 - self.alpha) * self.q_ewma
        j = int(np.searchsorted(-self.h_n[1:], -self.q_ewma, side="left"))
        n = self.n_values[min(j, len(self.n_values) - 1)]
        return n, self.k



# ---------------------------------------------------------------------------
# Tensor forms (run on the device inside the fused serving step)
# ---------------------------------------------------------------------------

#: Finite stand-in for +inf thresholds.
BIG = float(np.finfo(np.float32).max)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _to(obj, device):
    """Copy of a frozen dataclass of tensors with every tensor on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) if isinstance(getattr(obj, f.name), torch.Tensor)
        else getattr(obj, f.name) for f in dataclasses.fields(obj)
    })


@dataclasses.dataclass(frozen=True)
class TofecTables:
    """Static threshold tables as device tensors (one class)."""

    h_k: torch.Tensor  # (k_max + 1,) float32 descending, h_k[0] = BIG
    h_n: torch.Tensor  # (n_max + 1,) float32
    r_max: float

    @classmethod
    def from_plan(cls, plan: ClassPlan, device=None) -> "TofecTables":
        """Tables of ``plan`` on ``device`` (default ``cuda``); +inf becomes
        float32 max."""
        dev = resolve_device(device)
        h_k = np.where(np.isinf(plan.h_k), BIG, plan.h_k)
        h_n = np.where(np.isinf(plan.h_n), BIG, plan.h_n)
        return cls(h_k=_f32(h_k, dev), h_n=_f32(h_n, dev), r_max=plan.cls.r_max)

    def to(self, device) -> "TofecTables":
        return _to(self, device)


def tofec_threshold_step(q_ewma: torch.Tensor, q, h_k: torch.Tensor, h_n: torch.Tensor,
                         r_max, alpha) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TOFEC arrival update on tensors: returns (q̄', n, k).

    Same semantics as :meth:`TOFECPolicy.select` (threshold search =
    1 + #{h > q̄} over the descending tables). ``r_max`` and ``alpha`` may be
    Python floats or float32 tensors. Trailing zero entries in
    ``h_k``/``h_n`` are inert (0 > q̄ never holds for q̄ ≥ 0).

    Batched over a leading grid axis: ``q_ewma``, ``q``, ``r_max`` and
    ``alpha`` may be (G,) and the tables (G, len), one configuration per
    row (the fluid scan's form); each row counts only its own thresholds.
    With a 0-d ``q_ewma`` and 1-d tables it is the serving step's update.

    ``q_ewma < 0`` is the cold-start sentinel (carries initialize to -1.0):
    the first observation seeds the EWMA, matching the host policies'
    ``q_ewma = None`` rule.
    """
    q = _f32(q, q_ewma.device)
    q_new = torch.where(q_ewma < 0.0, q, alpha * q + (1.0 - alpha) * q_ewma)
    k = 1 + (h_k[..., 1:] > q_new[..., None]).sum(-1).to(torch.int32)
    n = 1 + (h_n[..., 1:] > q_new[..., None]).sum(-1).to(torch.int32)
    n = torch.minimum((r_max * k).to(torch.int32), n)
    n = torch.maximum(n, k)
    return q_new, n, k


def tofec_step(q_ewma: torch.Tensor, q, tables: TofecTables,
               alpha: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`tofec_threshold_step` with the tables of one class."""
    return tofec_threshold_step(q_ewma, q, tables.h_k, tables.h_n, tables.r_max, alpha)

class MPCPolicy(Policy):
    """Beyond-paper controller: discrete model-predictive code selection.

    Instead of inverting the continuous relaxation into thresholds (§IV-C),
    estimate the arrival rate online (interarrival EWMA) and pick the
    discrete (n, k) minimizing the paper's own cost model

        D̂(n, k) = D_q^{M/M/1}(λ̂, U(n, k)) + D_s^{exact}(n, k)

    over the feasible code set, rejecting codes with λ̂·U ≥ util_cap·L.
    Falls back to max chunking until a rate estimate exists.

    The whole select is vectorized float32 over the k-major code enumeration
    (k ascending outer, n ascending inner) so it is the bit-level oracle for
    :func:`mpc_step`; see that function for the tie-break contract.
    """

    def __init__(
        self,
        cls_: RequestClass,
        L: int,
        *,
        alpha_rate: float = 0.05,
        util_cap: float = 0.9,
        q_guard: float = 4.0,
        alpha_q: float = 0.1,
    ):
        from repro_torch.core import queueing as _q

        self.cls = cls_
        self.L = L
        self.alpha_rate = alpha_rate
        self.util_cap = util_cap
        self.q_guard = q_guard
        self.alpha_q = alpha_q
        self.name = "mpc"
        p, J = cls_.params, cls_.file_mb
        self.codes = []
        for k in range(1, cls_.k_max + 1):
            for n in range(k, min(int(cls_.r_max * k), cls_.n_max) + 1):
                u = _q.usage(p, J, k, n / k)
                ds = _q.service_delay_exact(p, J, k, n)
                self.codes.append((n, k, u, ds))
        self._n = np.asarray([c[0] for c in self.codes], np.int32)
        self._k = np.asarray([c[1] for c in self.codes], np.int32)
        self._u = np.asarray([c[2] for c in self.codes], np.float32)
        self._ds = np.asarray([c[3] for c in self.codes], np.float32)
        self.reset()

    def reset(self) -> None:
        self.mean_ia = None
        self.last_arrival = None
        self.q_ewma = None  # cold-start sentinel, see TOFECPolicy.reset

    def select(self, *, q: int, idle: int, cls_id: int = 0, now: float | None = None) -> tuple[int, int]:
        one = np.float32(1.0)
        a_q = np.float32(self.alpha_q)
        if self.q_ewma is None:
            self.q_ewma = np.float32(q)
        else:
            self.q_ewma = a_q * np.float32(q) + (one - a_q) * np.float32(self.q_ewma)
        if now is not None:
            if self.last_arrival is not None:
                ia = np.float32(max(now - self.last_arrival, 1e-9))
                a_r = np.float32(self.alpha_rate)
                self.mean_ia = (
                    ia if self.mean_ia is None
                    else (one - a_r) * np.float32(self.mean_ia) + a_r * ia
                )
            self.last_arrival = now
        if self.mean_ia is None:
            # Cold: max chunking = the LAST entry of the k-major enumeration
            # (largest k, then largest n).
            i = len(self.codes) - 1
        else:
            L = np.float32(self.L)
            lam_bar = (one / np.float32(self.mean_ia)) * self._u
            feasible = lam_bar < np.float32(self.util_cap) * L
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                dq = lam_bar * self._u / (L * (L - lam_bar))
                # backlog guard: sustained queue penalizes expensive codes.
                dq = dq * (one + np.float32(self.q_ewma) / np.float32(self.q_guard))
                cost = np.where(feasible, dq + self._ds, np.float32(np.inf))
            # First minimum = lowest k-major index; all-infeasible → index 0
            # = (1, 1). Same rule as torch.argmin in mpc_step.
            i = int(np.argmin(cost))
        return int(self._n[i]), int(self._k[i])



@dataclasses.dataclass(frozen=True)
class MPCTables:
    """MPC cost model as device tensors (one class) — all fields runtime data.

    The code enumeration is k-major (k ascending outer, n ascending inner),
    identical to ``MPCPolicy.codes``; ``n``/``k``/``u``/``ds`` are parallel
    (C,) tensors and the scalars are 0-d float32 tensors.
    """

    n: torch.Tensor  # (C,) int32
    k: torch.Tensor  # (C,) int32
    u: torch.Tensor  # (C,) float32 thread-seconds per request
    ds: torch.Tensor  # (C,) float32 exact service delay
    L: torch.Tensor  # () float32 pool size
    util_cap: torch.Tensor  # () float32
    q_guard: torch.Tensor  # () float32
    alpha_q: torch.Tensor  # () float32 backlog-EWMA gain (MPC default 0.1)
    alpha_rate: torch.Tensor  # () float32 interarrival-EWMA gain

    @classmethod
    def from_policy(cls, pol: MPCPolicy, device=None) -> "MPCTables":
        dev = resolve_device(device)
        return cls(
            n=torch.as_tensor(pol._n, device=dev),
            k=torch.as_tensor(pol._k, device=dev),
            u=torch.as_tensor(pol._u, device=dev),
            ds=torch.as_tensor(pol._ds, device=dev),
            L=_f32(pol.L, dev),
            util_cap=_f32(pol.util_cap, dev),
            q_guard=_f32(pol.q_guard, dev),
            alpha_q=_f32(pol.alpha_q, dev),
            alpha_rate=_f32(pol.alpha_rate, dev),
        )

    @classmethod
    def trivial(cls, device=None) -> "MPCTables":
        """Inert single-code table for steps that never select the MPC lane."""
        dev = resolve_device(device)
        return cls(
            n=torch.ones(1, dtype=torch.int32, device=dev),
            k=torch.ones(1, dtype=torch.int32, device=dev),
            u=torch.ones(1, dtype=torch.float32, device=dev),
            ds=torch.zeros(1, dtype=torch.float32, device=dev),
            L=_f32(1.0, dev),
            util_cap=_f32(1.0, dev),
            q_guard=_f32(1.0, dev),
            alpha_q=_f32(0.1, dev),
            alpha_rate=_f32(0.05, dev),
        )

    def to(self, device) -> "MPCTables":
        return _to(self, device)


def mpc_tables(
    cls_: RequestClass,
    L: int,
    *,
    alpha_rate: float = 0.05,
    util_cap: float = 0.9,
    q_guard: float = 4.0,
    alpha_q: float = 0.1,
    device=None,
) -> MPCTables:
    """Build :class:`MPCTables` through the host policy so the enumeration
    and float32 casts are shared with the oracle by construction."""
    pol = MPCPolicy(
        cls_, L, alpha_rate=alpha_rate, util_cap=util_cap, q_guard=q_guard, alpha_q=alpha_q
    )
    return MPCTables.from_policy(pol, device=device)


def mpc_step(
    carry: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    q,
    dt,
    tables: MPCTables,
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One MPC arrival update on tensors: ((q̄', ia', has_rate'), n, k).

    Carry = (q_ewma, mean_ia, has_rate), all 0-d float32 tensors; initialize
    to (-1.0, 0.0, 0.0). ``q_ewma < 0`` is the cold-start sentinel (first
    observation seeds the backlog EWMA); ``dt < 0`` means "no previous
    arrival timestamp" — the rate EWMA only updates on ``dt ≥ 0``, mirroring
    the host's ``now``/``last_arrival`` bookkeeping.

    Tie-break contract: costs are evaluated over the k-major enumeration of
    :class:`MPCTables` and the winner is the FIRST minimum — ``torch.argmin``
    here, ``np.argmin`` on the host. Cold start (has_rate == 0) picks index
    C-1, the max-(k, n) code; an all-infeasible round degenerates to argmin
    over all-inf costs = index 0 = (1, 1).
    """
    q_ewma, mean_ia, has_rate = carry
    t = tables
    q = _f32(q, q_ewma.device)
    dt = _f32(dt, q_ewma.device)
    one = torch.ones((), dtype=torch.float32, device=q_ewma.device)
    q_new = torch.where(q_ewma < 0.0, q, t.alpha_q * q + (one - t.alpha_q) * q_ewma)
    ia = torch.clamp_min(dt, 1e-9)
    seen = dt >= 0.0
    ia_new = torch.where(has_rate > 0.0, (one - t.alpha_rate) * mean_ia + t.alpha_rate * ia, ia)
    mean_ia = torch.where(seen, ia_new, mean_ia)
    has_rate = torch.where(seen, one, has_rate)
    lam_bar = (one / torch.clamp_min(mean_ia, 1e-30)) * t.u
    feasible = lam_bar < t.util_cap * t.L
    dq = lam_bar * t.u / (t.L * (t.L - lam_bar))
    dq = dq * (one + q_new / t.q_guard)
    cost = torch.where(feasible, dq + t.ds, torch.inf)
    idx = torch.argmin(cost)
    idx = torch.where(has_rate > 0.0, idx, t.n.shape[0] - 1)
    return (q_new, mean_ia, has_rate), t.n[idx], t.k[idx]

class FeedbackPolicy(Policy):
    """Externally-driven write policy: closes the §III control loop.

    The serving tower's fused controller picks (n, k) on device each round
    and :meth:`push`\\ es it here; the proxy's write path then encodes every
    queued write under the adapted code. ``select`` just replays the last
    pushed code — no internal state beyond it.
    """

    def __init__(self, n: int, k: int):
        self.name = "feedback"
        self.push(n, k)

    def push(self, n: int, k: int) -> None:
        n, k = int(n), int(k)
        if n < k or k < 1:
            raise ValueError(f"invalid pushed code ({n},{k})")
        self.code = (n, k)

    def select(self, *, q: int, idle: int, cls_id: int = 0, now: float | None = None) -> tuple[int, int]:
        return self.code
