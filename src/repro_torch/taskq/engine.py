"""The exact task-level FEC queue engine, as one device loop over arrivals
for a whole grid of configurations.

The port of the reference package's ``repro/taskq/engine.py``, whose
``lax.scan`` runs one configuration (and is vmapped over a grid there).
:mod:`repro_torch.core.fluid_scan` runs the paper's §IV-A *fluid*
approximation; this module runs the **exact** §II-A system: L threads, a
FIFO request backlog, k-of-n completion, preemptive cancellation of the
n−k stragglers, task delays read from pre-sampled trace pools. It matches
the event oracle (:func:`repro_torch.core.simulator.simulate`) draw for
draw when both read the same :class:`repro_torch.core.traces.DevicePools`.

Why one admission per step is exact
-----------------------------------
With a single FIFO class, requests are admitted in arrival order, and a
request's service depends only on (a) the thread busy-until multiset left
by its predecessors and (b) its own task delays — never on later arrivals.
So the event simulation collapses to a per-request recurrence over an
L-vector ``b`` of thread busy-until times:

1. **Assign** (pass 1): tasks take threads in FIFO order at successive
   thread-free events. Task m starts at ``S_m = max(t, min(f))`` and
   tentatively completes at ``C_m = S_m + X_m`` (updating ``f``) — this
   handles the feedback where a request's later tasks start on threads
   freed by its *own* earlier completions.
2. **Complete**: the request departs at the k-th order statistic
   ``D = sort(C)[k−1]``. Tasks with ``C ≤ D`` are the k winners; tasks with
   ``S ≥ D`` never start (cancelled in queue); the rest are cancelled *in
   service* at D.
3. **Cancel** (pass 2): replay the assignment against the real outcome —
   started tasks hold their thread until ``min(C, D)``, never-started tasks
   leave it untouched. Never-started tasks form a suffix of the FIFO task
   order and only ever claim threads freeing at or after D, so the pass-1
   and pass-2 thread-free multisets agree below D and the replay is exact.

The backlog length at an arrival is the count of the last ``q_cap``
admission times (a ring) still in the future — exact while the backlog is
shorter than ``q_cap``. The idle-thread count ``#{b ≤ t}`` is always exact.

The loop carries (G,) and (G, L) tensors and writes row t of preallocated
outputs; each lane of the two passes is a handful of (G,) operations
(``argmin`` returns the first minimum, as ``jnp.argmin`` does). The float32
operations are the reference's, in its order, so the outputs equal its
element for element. Two rewrites change no value: pass 1 lets lanes past
n update its scratch thread state (those lanes form a suffix, their S and C
are +inf either way, and pass 1's state is dropped), and pass 2 tests
``max(t, f_j) < D`` as ``f_j < D`` against a threshold that is −inf where
the lane is not live or ``t ≥ D``.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.controller import tofec_threshold_step
from repro_torch.taskq.policies import POL_GREEDY, greedy_select

_INF = float("inf")

#: The per-row config fields the engine reads.
CFG_FIELDS = ("J", "alpha", "r_max", "pol", "gk_max", "h_k", "h_n")


def taskq_scan_core(
    cfg: dict,
    interarrivals: torch.Tensor,
    pool_idx: torch.Tensor,
    pools: torch.Tensor,
    pool_sizes: torch.Tensor,
    *,
    L: int,
    q_cap: int = 128,
    collect: bool = False,
    valid: torch.Tensor | None = None,
    window: int | None = None,
    horizon: int | None = None,
    flight: bool = False,
) -> dict[str, torch.Tensor]:
    """The engine over a grid of G configurations, on the device of the inputs.

    ``cfg`` maps :data:`CFG_FIELDS` to per-row tensors: ``J`` (file MB),
    ``alpha`` and ``r_max`` (G,) float32, ``pol`` (policy id) and ``gk_max``
    (greedy chunk cap) (G,) int32, ``h_k``/``h_n`` (G, len) float32
    threshold tables. ``interarrivals`` (G, T) float32 gaps; ``pool_idx``
    (G, T) integer pre-sampled row draws; ``pools`` (S, P, W) float32
    per-chunk-size delay pools and ``pool_sizes`` (S,) float32 their chunk
    sizes, shared by every row (see
    :meth:`repro_torch.core.traces.TraceStore.device_pools`). ``L`` is the
    thread count and ``q_cap`` the backlog ring width; the task-lane count
    is the pool width W, so codes with n > L are exact too.

    Returns (G, T) tensors: ``total``/``queueing``/``service`` delays
    (queueing = first task start − arrival, §II-C's D_q) and the chosen
    ``n``/``k`` (int32).

    ``flight`` additionally returns a ``"flight"`` dict of ``arrival`` and
    ``depart`` (G, T) and per-lane ``start``/``tent``/``thread`` (G, T, W):
    starts and tentative completions from pass 1, the thread each started
    task held from pass 2 (−1 for a lane that never starts).

    ``collect`` additionally records per step the idle-thread count, the
    backlog length and the cancellations split into queued
    (``#(live & S ≥ D)``) and in-service (``#(live & S < D & C > D)``) —
    started tasks have S < D, and X > 0 makes S ≥ D imply C > D, so the
    issued cancellations split exactly — and returns them as an ``"obs"``
    :class:`repro_torch.obs.MetricsBuf` with one row per configuration
    (idle histogram, cancellation counters, backlog high-water mark).
    ``valid`` is an optional (G, T) or (T,) mask of the arrivals to count.
    ``window`` (collect only) adds a ``"timeline"``
    :class:`repro_torch.obs.TimelineBuf` whose backlog series is the exact
    per-arrival queue length, over ``horizon`` arrivals (default T; the
    sweep passes its pow2 bucket). The primary outputs are the same either
    way.
    """
    G, T = interarrivals.shape
    dev = interarrivals.device
    W = pools.shape[2]
    f32 = torch.float32
    lane = torch.arange(W, device=dev)
    J, alpha, r_max = cfg["J"], cfg["alpha"], cfg["r_max"]
    h_k, h_n, gk_max = cfg["h_k"], cfg["h_n"], cfg["gk_max"]
    is_greedy = cfg["pol"] == POL_GREEDY
    idx = pool_idx.to(torch.int64)
    # Outputs are time-major so each step writes one contiguous row.
    total = torch.empty((T, G), dtype=f32, device=dev)
    queueing = torch.empty_like(total)
    service = torch.empty_like(total)
    ns = torch.empty((T, G), dtype=torch.int32, device=dev)
    ks = torch.empty_like(ns)
    if flight:
        fl_t = torch.empty_like(total)
        fl_d = torch.empty_like(total)
        fl_s = torch.empty((T, W, G), dtype=f32, device=dev)
        fl_c = torch.empty_like(fl_s)
        fl_tid = torch.empty((T, W, G), dtype=torch.int32, device=dev)
        minus1 = torch.full((G,), -1, dtype=torch.int32, device=dev)
    if collect:
        idle_t = torch.empty((T, G), dtype=torch.int32, device=dev)
        q_t = torch.empty_like(total)
        cq_t = torch.empty_like(idle_t)
        cs_t = torch.empty_like(idle_t)
    t = torch.zeros(G, dtype=f32, device=dev)
    b = torch.zeros((G, L), dtype=f32, device=dev)
    ring = torch.full((G, q_cap), -_INF, dtype=f32, device=dev)
    q_ewma = torch.full((G,), -1.0, dtype=f32, device=dev)  # cold-start sentinel
    S = torch.empty((W, G), dtype=f32, device=dev)  # lane-major scratch
    C = torch.empty_like(S)
    for step in range(T):
        t = t + interarrivals[:, step]

        # ---- exact arrival-instant observables ---------------------------
        idle = (b <= t[:, None]).sum(1, dtype=torch.int32)
        q = (ring > t[:, None]).sum(1).to(f32)

        # ---- policy: threshold tables and greedy, selected by id ---------
        q_ewma, n_t, k_t = tofec_threshold_step(q_ewma, q, h_k, h_n, r_max, alpha)
        n_g, k_g = greedy_select(q, idle, gk_max, r_max)
        k = torch.clamp_max(torch.where(is_greedy, k_g, k_t), W)
        n = torch.clamp_max(torch.maximum(torch.where(is_greedy, n_g, n_t), k), W)

        # ---- task delays from the shared trace pools ---------------------
        B = J / k.to(f32)
        s_idx = torch.argmin(torch.abs(pool_sizes[None, :] - B[:, None]), dim=1)
        live = lane[None, :] < n[:, None]  # (G, W); a prefix of the lanes
        X = torch.where(live, pools[s_idx, idx[:, step]], _INF)

        # ---- pass 1: FIFO assignment with own-completion feedback --------
        f = b.clone()
        for m in range(W):
            j = torch.argmin(f, dim=1, keepdim=True)
            torch.maximum(t, f.gather(1, j)[:, 0], out=S[m])
            torch.add(S[m], X[:, m], out=C[m])  # +inf past n
            f.scatter_(1, j, C[m][:, None])
        Sm = torch.where(live.T, S, _INF)

        # ---- k-of-n completion -------------------------------------------
        D = torch.sort(C, dim=0).values.gather(0, (k - 1).to(torch.int64)[None, :])[0]

        # ---- pass 2: replay with cancellation → new thread state ---------
        thr = torch.where(live.T & (t < D)[None, :], D[None, :], -_INF)
        settle = torch.minimum(C, D[None, :])
        for m in range(W):
            j = torch.argmin(b, dim=1, keepdim=True)
            fj = b.gather(1, j)[:, 0]
            started = fj < thr[m]
            b.scatter_(1, j, torch.where(started, settle[m], fj)[:, None])
            if flight:
                torch.where(started, j[:, 0].to(torch.int32), minus1, out=fl_tid[step, m])

        # ---- bookkeeping -------------------------------------------------
        a = Sm[0]  # admission = first task start (§II-C's T_1)
        ring[:, step % q_cap] = a
        torch.sub(a, t, out=queueing[step])
        torch.sub(D, a, out=service[step])
        torch.add(queueing[step], service[step], out=total[step])
        ns[step] = n
        ks[step] = k
        if collect:
            idle_t[step] = idle
            q_t[step] = q
            lv = live.T
            torch.sum(lv & (Sm >= D), 0, dtype=torch.int32, out=cq_t[step])
            torch.sum(lv & (Sm < D) & (C > D), 0, dtype=torch.int32, out=cs_t[step])
        if flight:
            fl_t[step] = t
            fl_d[step] = D
            fl_s[step] = Sm
            fl_c[step] = C
    out = {"total": total.T.contiguous(), "queueing": queueing.T.contiguous(),
           "service": service.T.contiguous(), "n": ns.T.contiguous(), "k": ks.T.contiguous()}
    if flight:
        out["flight"] = {"arrival": fl_t.T.contiguous(), "depart": fl_d.T.contiguous(),
                         "start": fl_s.permute(2, 0, 1).contiguous(),
                         "tent": fl_c.permute(2, 0, 1).contiguous(),
                         "thread": fl_tid.permute(2, 0, 1).contiguous()}
    if collect:
        out.update(_collected(out, interarrivals, idle_t.T, q_t.T, cq_t.T, cs_t.T, L=L,
                              valid=valid, window=window, horizon=horizon))
    return out


def _collected(out: dict, interarrivals, idle, q, cancel_q, cancel_s, *, L: int, valid,
               window, horizon) -> dict:
    """The ``"obs"`` buffer (and ``"timeline"`` with a window) of a
    collected run from its (G, T) per-step observables."""
    G, T = q.shape
    mask = (torch.ones_like(idle, dtype=torch.bool) if valid is None
            else valid.expand(G, T))
    w = mask.to(torch.int32)
    # Cancellations *issued*: tasks with C > D. Ties C == D complete with
    # the request (nothing to cancel), so this can undershoot the n−k budget
    # by the tie count — it is the exact cancel-RPC tally.
    buf = obs.MetricsBuf.zeros(
        counters=("taskq_cancelled", "taskq_cancel_queue", "taskq_cancel_service"),
        hists={"taskq_idle": L + 1},
        highs=("taskq_q_hi",),
        batch=(G,), device=q.device,
    )
    buf = buf.count("taskq_cancelled", ((cancel_q + cancel_s) * w).sum(1))
    buf = buf.count("taskq_cancel_queue", (cancel_q * w).sum(1))
    buf = buf.count("taskq_cancel_service", (cancel_s * w).sum(1))
    buf = buf.observe("taskq_idle", idle, weight=w)
    buf = buf.high("taskq_q_hi", torch.where(mask, q, 0.0))
    res = {"obs": buf}
    if window:
        res["timeline"] = obs.sweep_timeline(out, interarrivals, window=window, valid=mask,
                                             backlog=q, horizon=horizon)
    return res


def taskq_scan(
    cfg: dict,
    interarrivals,
    pool_idx,
    pools: torch.Tensor,
    pool_sizes: torch.Tensor,
    *,
    L: int,
    q_cap: int = 128,
    collect: bool | None = None,
    window: int | None = None,
    flight: bool = False,
) -> dict[str, torch.Tensor]:
    """One configuration on the pools' device: ``cfg`` holds the
    :data:`CFG_FIELDS` as numbers and (len,) tables, ``interarrivals`` and
    ``pool_idx`` are (T,) (numpy or tensors). Returns (T,) tensors (and
    (T, W) flight lanes); with ``collect`` (default: the ``REPRO_OBS``
    gate) also the run's ``"obs"`` buffer, and with a ``window`` its
    ``"timeline"``, both as one configuration's."""
    if collect is None:
        collect = obs.enabled()
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    dev = pools.device
    row = {}
    for name in CFG_FIELDS:
        dtype = torch.int32 if name in ("pol", "gk_max") else torch.float32
        row[name] = torch.as_tensor(cfg[name], dtype=dtype, device=dev)[None]
    inter = torch.as_tensor(interarrivals, dtype=torch.float32, device=dev)[None]
    idx = torch.as_tensor(pool_idx, device=dev)[None]
    out = taskq_scan_core(row, inter, idx, pools, pool_sizes, L=L, q_cap=q_cap,
                          collect=bool(collect), window=window, flight=flight)
    res = {name: v[0] for name, v in out.items() if name not in ("flight", "obs", "timeline")}
    if flight:
        res["flight"] = {name: v[0] for name, v in out["flight"].items()}
    if collect:
        res["obs"] = out["obs"].reduce_rows()
    if "timeline" in out:
        res["timeline"] = out["timeline"].take(0)
    return res
