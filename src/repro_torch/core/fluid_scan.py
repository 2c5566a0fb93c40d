"""The fluid scan: the paper's own M/G/1-style approximation, for a whole
grid of configurations at once.

The port of the reference package's ``repro/core/jax_sim.py`` (whose
``lax.scan`` is vmapped over a grid there). The event simulator
(:mod:`repro_torch.core.simulator`) is the oracle. This module implements the
*approximate* system the paper analyses in §IV-A — a single queue with
service rate L/U(n,k) — as one device loop over arrivals. Per arrival i, for
every grid row at once:

  * controller update (TOFEC thresholds, EWMA) → (n_i, k_i),
  * Lindley recursion on the virtual waiting time with service time
    s_i = U(n_i, k_i)/L   (M/G/1 fluid over L threads),
  * service delay sampled exactly as Δ(B) + (1/μ)(Σ_{j<k} E_j/(n−j)) —
    the k-th order statistic of n i.i.d. exponentials.

``lax.scan`` becomes a Python loop over arrivals that carries (w, q̄) as (G,)
tensors and writes column t of preallocated (G, T) outputs; the float32
operations are the reference's, in its order. The loop issues a few dozen
small kernels per arrival, so it is bound by host dispatch (``PERF.md``).
:func:`simulate_tofec_reference` is the reference's numpy mirror, copied.

The usage's constant terms Δ̃·J and Ψ̃·J are grid fields of their own
(``delta_tilde_J``, ``psi_tilde_J``), each the float64 product rounded once
to float32 — as the numpy oracle and the reference's single-configuration
scan (whose parameters are Python floats) take them. A float32 product of
the two float32-rounded factors, as the reference's vmapped grid takes it,
can be one ulp off; the Lindley recursion sums that error over a busy
period, which at 0.92 of capacity over 3,500 arrivals left a queueing delay
3e-6 s (1.7e-4 relative) away from the oracle.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.controller import TofecTables, tofec_threshold_step
from repro_torch.core.delay_model import RequestClass

#: The float fields a grid row carries: :class:`FluidScanParams`' own, then
#: the usage's constant products (see the module docstring).
PARAM_FIELDS = ("delta_bar", "delta_tilde", "psi_bar", "psi_tilde", "J", "L", "alpha",
                "delta_tilde_J", "psi_tilde_J")


@dataclasses.dataclass(frozen=True)
class FluidScanParams:
    """One configuration's scan parameters (the reference's ``JaxSimParams``)."""

    delta_bar: float
    delta_tilde: float
    psi_bar: float
    psi_tilde: float
    J: float
    L: int
    alpha: float
    n_max: int

    @classmethod
    def from_class(cls, c: RequestClass, L: int, alpha: float = 0.99) -> "FluidScanParams":
        p = c.params
        return cls(p.delta_bar, p.delta_tilde, p.psi_bar, p.psi_tilde, c.file_mb, L, alpha, c.n_max)

    @property
    def delta_tilde_J(self) -> float:
        return self.delta_tilde * self.J

    @property
    def psi_tilde_J(self) -> float:
        return self.psi_tilde * self.J

    def row(self) -> dict[str, float]:
        """One grid row's :data:`PARAM_FIELDS`, as Python floats."""
        return {f: float(getattr(self, f)) for f in PARAM_FIELDS}

    def rows(self, G: int, device) -> types.SimpleNamespace:
        """The row's fields as (G,) float32 tensors: the scan's ``p``."""
        return types.SimpleNamespace(**{
            f: torch.full((G,), v, dtype=torch.float32, device=device)
            for f, v in self.row().items()})


def _usage(p, k, r):
    """U(n, k) of Eq. 3 in the reference's order: Δ̄·k·r + Δ̃J·r + Ψ̄·k + Ψ̃J."""
    return p.delta_bar * k * r + p.delta_tilde_J * r + p.psi_bar * k + p.psi_tilde_J


def backlog_proxy(p, queueing):
    """Queue-length proxy series from the scan's queueing-delay output.

    The scan observes backlog as ``w · L / ū(1,1)`` and reports ``d_q = w``,
    so the controller's exact per-arrival backlog is recoverable post-hoc
    with the same float32 ops."""
    return queueing * p.L / _usage(p, 1.0, 1.0)


def _service_delay(p, k, n, exps, n_max: int):
    """Δ(B) + (1/μ(B)) Σ_{j<k} E_j/(n−j), per row; k, n: (G,), exps:
    (G, n_max) Exp(1) draws."""
    B = p.J / k
    j = torch.arange(n_max, dtype=torch.float32, device=exps.device)
    mask = j < k[..., None]
    denom = torch.clamp_min(n[..., None] - j, 1.0)
    tail = torch.where(mask, exps / denom, 0.0).sum(-1)
    return (p.delta_bar + p.delta_tilde * B) + (p.psi_bar + p.psi_tilde * B) * tail


def tofec_scan_core(
    p,
    h_k: torch.Tensor,
    h_n: torch.Tensor,
    r_max,
    interarrivals: torch.Tensor,
    exp_draws: torch.Tensor,
    *,
    n_max: int,
) -> dict[str, torch.Tensor]:
    """The scan over a grid of G configurations, on the device of the inputs.

    ``p`` exposes the :data:`PARAM_FIELDS` as (G,) float32 tensors (see
    :meth:`FluidScanParams.rows`); ``h_k``/``h_n`` are (G, len) threshold tables,
    ``r_max`` is (G,), ``interarrivals`` (G, T) and ``exp_draws``
    (G, T, n_max). Returns (G, T) ``total``/``queueing``/``service`` delays
    (float32) and the chosen ``n``/``k`` (int32). Rows never mix.
    """
    G, T = interarrivals.shape
    dev = interarrivals.device
    # Mean usage at the basic code — scale factor for the q-length proxy.
    ubar_hint = _usage(p, 1.0, 1.0)
    total = torch.empty((G, T), dtype=torch.float32, device=dev)
    queueing = torch.empty_like(total)
    service = torch.empty_like(total)
    ns = torch.empty((G, T), dtype=torch.int32, device=dev)
    ks = torch.empty_like(ns)
    w = torch.zeros(G, dtype=torch.float32, device=dev)  # virtual waiting work (s)
    # q̄ starts at the -1.0 cold-start sentinel (tofec_threshold_step): the
    # first observed backlog seeds the EWMA instead of decaying from 0.
    q_ewma = torch.full((G,), -1.0, dtype=torch.float32, device=dev)
    for t in range(T):
        w = torch.clamp_min(w - interarrivals[:, t], 0.0)
        # Queue length proxy upon arrival: waiting work / mean service time
        # (Little's law over the L fluid lanes).
        q_ewma, n_i, k_i = tofec_threshold_step(
            q_ewma, w * p.L / ubar_hint, h_k, h_n, r_max, p.alpha)
        nf, kf = n_i.to(torch.float32), k_i.to(torch.float32)
        r = nf / kf
        s = _usage(p, kf, r) / p.L
        d_s = _service_delay(p, kf, nf, exp_draws[:, t], n_max)
        total[:, t] = w + d_s
        queueing[:, t] = w
        service[:, t] = d_s
        ns[:, t] = n_i
        ks[:, t] = k_i
        w = w + s
    return {"total": total, "queueing": queueing, "service": service, "n": ns, "k": ks}


def simulate_tofec_scan(
    p: FluidScanParams,
    tables: TofecTables,
    interarrivals,
    exp_draws,
) -> dict[str, torch.Tensor]:
    """Scan over arrivals for one configuration, on the tables' device.
    interarrivals: (T,), exp_draws: (T, n_max) (numpy or tensors).

    Returns per-request total delay, queueing delay, service delay, n, k as
    (T,) tensors.
    """
    dev = tables.h_k.device
    inter = torch.as_tensor(interarrivals, dtype=torch.float32, device=dev)[None]
    exps = torch.as_tensor(exp_draws, dtype=torch.float32, device=dev)[None]
    r_max = torch.full((1,), float(tables.r_max), dtype=torch.float32, device=dev)
    out = tofec_scan_core(p.rows(1, dev), tables.h_k[None], tables.h_n[None], r_max,
                          inter, exps, n_max=p.n_max)
    return {k: v[0] for k, v in out.items()}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def simulate_tofec_reference(
    p: FluidScanParams,
    tables: TofecTables,
    interarrivals: np.ndarray,
    exp_draws: np.ndarray,
) -> dict[str, np.ndarray]:
    """Pure-Python/numpy mirror of :func:`simulate_tofec_scan`, step for step.

    The regression oracle for the scan: same Lindley recursion, same
    threshold controller, float32 throughout to match the scan's device
    arithmetic. A copy of the reference package's function of the same
    name; the tables may be tensors on any device.
    """
    h_k = _np(tables.h_k).astype(np.float32)
    h_n = _np(tables.h_n).astype(np.float32)
    inter = _np(interarrivals).astype(np.float32)
    exps = _np(exp_draws).astype(np.float32)
    one = np.float32(1.0)
    alpha = np.float32(p.alpha)
    L = np.float32(p.L)
    ubar = np.float32(_usage(p, np.float32(1.0), np.float32(1.0)))
    j = np.arange(p.n_max, dtype=np.float32)
    w = np.float32(0.0)
    q_ewma = np.float32(-1.0)  # cold-start sentinel, mirrors the scan carry
    tot, dq_l, ds_l, ns, ks = [], [], [], [], []
    for dt, e in zip(inter, exps):
        w = np.maximum(w - dt, np.float32(0.0))
        q = w * L / ubar
        q_ewma = q if q_ewma < 0.0 else alpha * q + (one - alpha) * q_ewma
        k = 1 + int(np.sum(h_k[1:] > q_ewma))
        n = 1 + int(np.sum(h_n[1:] > q_ewma))
        n = max(min(int(np.float32(tables.r_max) * np.float32(k)), n), k)
        nf, kf = np.float32(n), np.float32(k)
        r = nf / kf
        s = np.float32(_usage(p, kf, r)) / L
        B = np.float32(p.J) / kf
        denom = np.maximum(nf - j, np.float32(1.0))
        tail = np.sum(np.where(j < kf, e / denom, np.float32(0.0)), dtype=np.float32)
        d_s = (np.float32(p.delta_bar) + np.float32(p.delta_tilde) * B) + (
            np.float32(p.psi_bar) + np.float32(p.psi_tilde) * B
        ) * tail
        tot.append(w + d_s)
        dq_l.append(w)
        ds_l.append(d_s)
        ns.append(n)
        ks.append(k)
        w = w + s
    return {
        "total": np.asarray(tot, np.float32),
        "queueing": np.asarray(dq_l, np.float32),
        "service": np.asarray(ds_l, np.float32),
        "n": np.asarray(ns, np.int32),
        "k": np.asarray(ks, np.int32),
    }


def run_tofec_scan(
    c: RequestClass,
    tables: TofecTables,
    lam: float,
    count: int,
    *,
    L: int = 16,
    alpha: float = 0.99,
    seed: int = 0,
    device=None,
) -> dict[str, np.ndarray]:
    """Host wrapper: Poisson arrivals + Exp(1) draws from ``seed`` (the
    reference's streams), the scan on ``device`` (default ``cuda``), numpy
    arrays back."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    p = FluidScanParams.from_class(c, L, alpha)
    inter = rng.exponential(1.0 / lam, size=count).astype(np.float32)
    exps = rng.exponential(1.0, size=(count, c.n_max)).astype(np.float32)
    out = simulate_tofec_scan(p, tables.to(dev), inter, exps)
    return {k: v.cpu().numpy() for k, v in out.items()}
