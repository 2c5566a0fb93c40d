"""Joint multi-class shared-pool scan: ONE L-thread pool, C request classes,
for a whole grid of configurations at once.

The port of the reference package's ``repro/sched/scan.py``.
:func:`repro_torch.core.fluid_scan.tofec_scan_core` models a single class
against the pool; the fleet's ``tenant_cases`` path Poisson-splits a
:class:`repro_torch.fleet.workloads.TenantMix` into independent copies of
that fluid queue, so every class believes it has all L threads to itself
and cross-class interference — the phenomenon §IV's multi-class analysis
is about — never appears.

This module is the joint simulation: one loop over the merged arrival
stream, carrying a **per-class backlog** ``w`` (seconds of pool work) and a
per-class EWMA for every grid row. The pool is work conserving — total
backlog drains at rate 1 between arrivals regardless of discipline — but
*which class's* work drains first, and how much queued work an arrival
must wait behind, is set by the admission discipline:

* ``DISC_FIFO`` — arrival order. Backlog drains across classes in
  proportion to their share (the fluid limit of well-mixed FIFO), and an
  arrival waits behind the *total* backlog.
* ``DISC_PRIORITY`` — strict priority by per-class rank (lower rank drains
  first); an arrival waits behind the backlog of its own and
  higher-priority classes only.
* ``DISC_WFQ`` — weighted fair (the GPS fluid limit of deficit
  round-robin): drain splits by weight among backlogged classes with unused
  share redistributed; an arrival of class c waits for its own backlog
  served at class c's guaranteed share of the pool.

All three are computed as plain arithmetic and chosen with ``torch.where``
on a per-row discipline id, so a grid mixing disciplines runs in one loop.
Each class keeps its own TOFEC state (backlog EWMA → (n, k) via its own
threshold tables); usage accounting and queueing delay come from the
shared pool.

Per-arrival class data (``delta_bar[cid]``, ``prio[cid]``, the class's
tables, ...) is gathered once for the whole (G, T) stream before the loop,
so a step gathers and scatters only the carried per-class state. The usage
takes the fluid scan's grid fields Δ̃·J and Ψ̃·J, each rounded once from
float64, and its ``_usage``/``_service_delay``. So a one-class mix
reproduces :func:`repro_torch.core.fluid_scan.tofec_scan_core` bit for bit
under every discipline: the FIFO drain ``w − min(dt, W)·(w/W)`` is exactly
``max(w − dt, 0)`` for one class, and the other terms reduce to it exactly.

Cross-validated against the event oracle
:func:`repro_torch.core.simulator.simulate_shared_pool`.
"""

from __future__ import annotations

import types

import torch

from repro_torch.core.controller import tofec_threshold_step
from repro_torch.core.fluid_scan import _service_delay, _usage

#: Discipline ids (per-row data, never a Python branch).
DISC_FIFO = 0
DISC_PRIORITY = 1
DISC_WFQ = 2

DISC_NAMES = {DISC_FIFO: "fifo", DISC_PRIORITY: "priority", DISC_WFQ: "wfq"}

#: Per-class float fields of ``p`` (each (G, C)); ``p.L`` is (G,).
CLASS_FIELDS = ("delta_bar", "delta_tilde", "psi_bar", "psi_tilde", "J",
                "delta_tilde_J", "psi_tilde_J", "alpha", "r_max")

_EPS = 1e-20  # guards 0/0 on empty backlogs; far above float32 denormals


def multiclass_scan_core(
    p,
    h_k: torch.Tensor,
    h_n: torch.Tensor,
    disc: torch.Tensor,
    prio: torch.Tensor,
    wfq_w: torch.Tensor,
    interarrivals: torch.Tensor,
    cls_ids: torch.Tensor,
    exp_draws: torch.Tensor,
    *,
    n_max: int,
) -> dict[str, torch.Tensor]:
    """The joint scan over a grid of G rows, on the device of the inputs.

    ``p`` exposes :data:`CLASS_FIELDS` as (G, C) float32 tensors plus the
    pool size ``L`` (G,); ``h_k`` (G, C, k_max+1) and ``h_n`` (G, C,
    n_max+1) are per-class threshold tables (trailing zeros inert, like the
    fleet). ``disc`` (G,) is the discipline id, ``prio`` (G, C) the priority
    ranks (lower drains first; distinct), ``wfq_w`` (G, C) the weights.
    ``interarrivals`` (G, T) float32, ``cls_ids`` (G, T) the arriving class
    per step, ``exp_draws`` (G, T, n_max) Exp(1) draws. Returns (G, T)
    ``total``/``queueing``/``service`` delays (float32) and ``n``/``k``
    (int32). Rows never mix.
    """
    G, T = interarrivals.shape
    C = h_k.shape[1]
    dev = interarrivals.device
    f32 = torch.float32
    eps = _EPS
    # Per-class mean usage at the basic code — q-length proxy scale factors.
    ubar = _usage(p, 1.0, 1.0)
    ids = cls_ids.to(torch.int64)

    def per_arrival(x):
        """(G, C, ...) class data → (T, G, ...) at each arrival's class."""
        idx = ids.reshape(G, T, *([1] * (x.dim() - 2))).expand(G, T, *x.shape[2:])
        return x.gather(1, idx).transpose(0, 1).contiguous()

    at = {f: per_arrival(getattr(p, f)) for f in CLASS_FIELDS}
    ubar_t, h_k_t, h_n_t = per_arrival(ubar), per_arrival(h_k), per_arrival(h_n)
    prio_t, wfq_t = per_arrival(prio), per_arrival(wfq_w)
    ids_t = ids.T.contiguous()[:, :, None]  # (T, G, 1) scatter/gather index
    classes = torch.arange(C, device=dev)
    # Constant per row: ahead[g, c, c'] — class c' drains before class c.
    ahead_mask = prio[:, None, :] < prio[:, :, None]
    is_fifo = (disc == DISC_FIFO)[:, None]
    is_prio = (disc == DISC_PRIORITY)[:, None]
    inter_t = interarrivals.T.contiguous()
    L = p.L

    total = torch.empty((T, G), dtype=f32, device=dev)
    queueing = torch.empty_like(total)
    service = torch.empty_like(total)
    ns = torch.empty((T, G), dtype=torch.int32, device=dev)
    ks = torch.empty_like(ns)
    # w: (G, C) per-class waiting work [s of pool time]; t_tot/work track
    # cumulative time and per-class service work for online utilization.
    w = torch.zeros((G, C), dtype=f32, device=dev)
    # Per-class q̄ starts at the -1.0 cold-start sentinel (tofec_threshold_step).
    q_ewma = torch.full((G, C), -1.0, dtype=f32, device=dev)
    t_tot = torch.zeros(G, dtype=f32, device=dev)
    work = torch.zeros((G, C), dtype=f32, device=dev)
    for t in range(T):
        dt = inter_t[t]
        cid = ids_t[t]
        t_tot = t_tot + dt

        # ---- shared-pool drain over dt (work conserving in total) --------
        W = w.sum(1)
        drain = torch.minimum(dt, W)
        # FIFO fluid: drained work splits across classes by backlog share.
        # For C = 1 this is exactly max(w - dt, 0): w/W == 1.0. The drain is
        # rounded once, as a fused multiply-add (the reference's compiled
        # scan fuses it): the product of two float32 values is exact in
        # float64. Rounded twice, a class's share of a full drain leaves 0
        # where the fused form leaves a residue of ~1e-9 s, and the picks
        # drift apart at threshold crossings.
        share = w / torch.clamp_min(W, eps)[:, None]
        w_fifo = (w.double() - drain[:, None].double() * share.double()).to(f32)
        # Strict priority: class c only drains once all lower-rank backlog
        # ahead of it is gone.
        ahead = torch.where(ahead_mask, w[:, None, :], 0.0).sum(2)
        w_prio = w - torch.minimum(torch.clamp_min(dt[:, None] - ahead, 0.0), w)
        # Weighted fair (GPS fluid): split by weight among backlogged
        # classes, redistributing unused share. C rounds make the interval
        # allocation exact — each round empties a class or exhausts dt.
        w_wfq, rem = w, drain
        for _ in range(C):
            active = (w_wfq > 0.0).to(f32)
            denom = (wfq_w * active).sum(1)
            alloc = rem[:, None] * wfq_w * active / torch.clamp_min(denom, eps)[:, None]
            d = torch.minimum(alloc, w_wfq)
            w_wfq = w_wfq - d
            rem = rem - d.sum(1)
        w = torch.where(is_fifo, w_fifo, torch.where(is_prio, w_prio, w_wfq))

        # ---- queueing delay the class-cid arrival will experience --------
        dq_fifo = w.sum(1)
        # Priority: snapshot backlog at own-or-higher rank, amplified by
        # 1/(1 − σ_hi) for the strictly-higher-priority work that will keep
        # overtaking during the wait (the M/G/1 priority delay-cycle factor;
        # σ from the online utilization estimate, floor-clipped so a
        # saturated high class starves rather than diverges).
        rho = work / torch.clamp_min(t_tot, eps)[:, None]
        own_rank = prio_t[t][:, None]
        rho_hi = torch.where(prio < own_rank, rho, 0.0).sum(1)
        dq_prio = torch.where(prio <= own_rank, w, 0.0).sum(1) / torch.clamp(
            1.0 - rho_hi, 0.05, 1.0)
        # Own backlog served at the class's share of the pool (share over
        # classes that are backlogged now — plus itself — not over all C).
        phi_act = torch.where((w > 0.0) | (classes[None, :] == cid), wfq_w, 0.0)
        dq_wfq = w.gather(1, cid)[:, 0] * phi_act.sum(1) / torch.clamp_min(wfq_t[t], eps)
        d_q = torch.where(is_fifo[:, 0], dq_fifo,
                          torch.where(is_prio[:, 0], dq_prio, dq_wfq))

        # ---- per-class TOFEC adaptation (own EWMA, own tables) -----------
        q_new, n_i, k_i = tofec_threshold_step(
            q_ewma.gather(1, cid)[:, 0], d_q * L / ubar_t[t], h_k_t[t], h_n_t[t],
            at["r_max"][t], at["alpha"][t])
        q_ewma.scatter_(1, cid, q_new[:, None])

        pc = types.SimpleNamespace(**{f: at[f][t] for f in CLASS_FIELDS})
        nf, kf = n_i.to(f32), k_i.to(f32)
        s = _usage(pc, kf, nf / kf) / L
        d_s = _service_delay(pc, kf, nf, exp_draws[:, t], n_max)
        w.scatter_add_(1, cid, s[:, None])
        work.scatter_add_(1, cid, s[:, None])
        torch.add(d_q, d_s, out=total[t])
        queueing[t] = d_q
        service[t] = d_s
        ns[t] = n_i
        ks[t] = k_i
    return {"total": total.T.contiguous(), "queueing": queueing.T.contiguous(),
            "service": service.T.contiguous(), "n": ns.T.contiguous(), "k": ks.T.contiguous()}
