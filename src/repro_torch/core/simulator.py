"""Discrete-event simulator of the proxy queueing system (Fig.2).

Faithful to §II-A semantics:
  * FIFO request queue; FIFO task queue; L threads.
  * The head-of-line request is admitted only when at least one thread is
    idle AND the task queue is empty; its n tasks are then injected.
  * Tasks start on idle threads in FIFO order; per-batch task delays are
    pre-sampled jointly (preserving Shared-Key cross-thread correlation;
    "the i-th thread downloads the i-th coded chunk", §III-B).
  * When k tasks of a request have completed, the request departs and its
    remaining tasks are preemptively cancelled: queued ones are removed,
    in-service ones release their thread immediately (§II-A, footnote 1).
  * Work conserving: freed threads immediately pull queued tasks, and
    admission re-runs whenever a thread frees or the task queue drains.

Delay bookkeeping matches §II-C: D_q = T_1 − T_A (first task start minus
arrival), D_s = X_(k) − T_1, total = D_q + D_s.

A copy of the reference package's ``repro/core/simulator.py``, the event
oracle (numpy only), event for event and draw for draw the same.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque

import numpy as np

from repro_torch.core.controller import Policy


@dataclasses.dataclass
class RequestStats:
    arrival: float
    cls_id: int
    n: int
    k: int
    t_first_start: float = np.nan
    t_done: float = np.nan
    completed_tasks: int = 0
    arrival_index: int = -1  # global arrival order (shared-pool sampler hook)

    @property
    def d_q(self) -> float:
        return self.t_first_start - self.arrival

    @property
    def d_s(self) -> float:
        return self.t_done - self.t_first_start

    @property
    def total(self) -> float:
        return self.t_done - self.arrival


@dataclasses.dataclass
class SimResult:
    stats: list[RequestStats]
    horizon: float

    def totals(self) -> np.ndarray:
        return np.array([s.total for s in self.stats])

    def service(self) -> np.ndarray:
        return np.array([s.d_s for s in self.stats])

    def queueing(self) -> np.ndarray:
        return np.array([s.d_q for s in self.stats])

    def ks(self) -> np.ndarray:
        return np.array([s.k for s in self.stats])

    def ns(self) -> np.ndarray:
        return np.array([s.n for s in self.stats])

    def throughput(self) -> float:
        return len(self.stats) / self.horizon if self.horizon > 0 else 0.0

    def k_composition(self, k_max: int) -> np.ndarray:
        """Fraction of requests served at each k = 1..k_max (Fig.8)."""
        ks = self.ks()
        return np.array([(ks == k).mean() for k in range(1, k_max + 1)])

    def summary(self) -> dict:
        t = self.totals()
        if len(t) == 0:
            return {"count": 0}
        return {
            "count": len(t),
            "mean": float(t.mean()),
            "median": float(np.median(t)),
            "p90": float(np.percentile(t, 90)),
            "p99": float(np.percentile(t, 99)),
            "std": float(t.std()),
            "mean_k": float(self.ks().mean()),
            "mean_n": float(self.ns().mean()),
            "throughput": float(self.throughput()),
        }


class _Task:
    __slots__ = ("req", "delay", "cancelled", "started", "done", "t_start",
                 "t_end")

    def __init__(self, req, delay: float):
        self.req = req
        self.delay = delay
        self.cancelled = False
        self.started = False
        self.done = False
        self.t_start = np.nan
        self.t_end = np.nan


class _Request:
    __slots__ = ("stats", "tasks")

    def __init__(self, stats: RequestStats):
        self.stats = stats
        self.tasks: list[_Task] = []


def simulate(
    policy: Policy,
    arrivals: np.ndarray,
    sampler,
    *,
    L: int = 16,
    cls_ids: np.ndarray | None = None,
    samplers: list | None = None,
    seed: int = 0,
    warmup_frac: float = 0.05,
    event_log: list | None = None,
) -> SimResult:
    """Run the event simulation over the given arrival times.

    ``sampler``: object with .sample(rng, k, n) → (n,) task delays (used for
    cls 0); ``samplers`` optionally overrides per class.

    ``event_log``: optional list the oracle appends one per-task record to
    at every request departure — ``(arrival_index, lane, kind, start, end,
    depart)`` with kind 0 = won, 1 = cancelled in queue, 2 = cancelled in
    service (start/end are NaN where the task never started) — the
    row-for-row host twin of the device engine's flight records
    (the reference package's ``repro.obs.flight.FlightLog``).

    Thin front-end over :func:`simulate_shared_pool` with the FIFO
    discipline and one shared policy instance (which observes the true
    ``cls_id``): a single FIFO queue admitted in arrival order IS the
    shared-pool engine with per-class queues popped earliest-arrival-first,
    event for event and draw for draw.
    """
    if cls_ids is None:
        cls_ids = np.zeros(len(arrivals), dtype=np.int64)
    return simulate_shared_pool(
        policy, arrivals, cls_ids, samplers or [sampler],
        L=L, discipline="fifo", seed=seed, warmup_frac=warmup_frac,
        event_log=event_log,
    )


def simulate_shared_pool(
    policies: list[Policy] | Policy,
    arrivals: np.ndarray,
    cls_ids: np.ndarray,
    samplers: list,
    *,
    L: int = 16,
    discipline: str = "fifo",
    prio: tuple | None = None,
    weights: tuple | None = None,
    drr_quantum: float = 8.0,
    seed: int = 0,
    warmup_frac: float = 0.05,
    event_log: list | None = None,
) -> SimResult:
    """Multi-class shared-pool oracle: C classes contending for ONE L-thread
    pool under a pluggable admission discipline (§IV's shared-resource view).

    Unlike :func:`simulate` (single FIFO request queue), requests queue per
    class and the discipline decides whose head-of-line request is admitted
    when threads free up:

    * ``"fifo"``     — earliest arrival across all class queues.
    * ``"priority"`` — head of the non-empty class with the lowest ``prio``
      rank (strict; ties broken by class index).
    * ``"wfq"``      — deficit round-robin over class queues: each visit adds
      ``drr_quantum``·(w_c/min w) to the class's deficit counter; a request
      costs its task count n. Classic DRR — empty classes forfeit deficit.

    ``policies`` holds ONE policy instance per class (independent adaptation
    state); each sees a discipline-shaped queue-length observation: total
    queued (fifo), queued at its own or higher priority (priority), or its
    own queue scaled by the inverse of its weight share (wfq) — mirroring
    the waiting-work terms of
    :func:`repro_torch.sched.scan.multiclass_scan_core`, which this function
    cross-validates. Passing a single :class:`Policy`
    instead shares it across classes (it then observes the true ``cls_id``
    per arrival) — the :func:`simulate` front-end.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.asarray(arrivals, dtype=np.float64)
    cls_ids = np.asarray(cls_ids, dtype=np.int64)
    shared_policy = isinstance(policies, Policy)
    if shared_policy:
        C = int(max(int(cls_ids.max(initial=0)) + 1, len(samplers), 1))
    else:
        C = len(policies)
    if discipline not in ("fifo", "priority", "wfq"):
        raise ValueError(f"unknown discipline {discipline!r}")
    prio = tuple(prio) if prio is not None else tuple(range(C))
    weights = tuple(weights) if weights is not None else (1.0,) * C
    if len(prio) != C or sorted(prio) != list(range(C)):
        raise ValueError("prio must be a permutation of range(C)")
    if len(weights) != C or any(wt <= 0 for wt in weights):
        raise ValueError("weights must be C positive values")
    for pol in ([policies] if shared_policy else policies):
        pol.reset()

    seq = itertools.count()
    events: list = []
    for t, c in zip(arrivals, cls_ids):
        heapq.heappush(events, (float(t), next(seq), 0, int(c)))

    queues: list[deque[_Request]] = [deque() for _ in range(C)]
    task_queue: deque[_Task] = deque()
    idle = L
    now = 0.0
    done_stats: list[RequestStats] = []
    deficit = [0.0] * C
    drr_ptr = 0
    # Quantum scaled so the LIGHTEST class earns drr_quantum per visit:
    # identical service proportions, but admission needs O(n/quantum) visits
    # instead of O(w_max/w_min) — extreme weight skews can't spin pop_next.
    w_min = min(weights)

    def start_tasks():
        nonlocal idle
        while idle > 0 and task_queue:
            task = task_queue.popleft()
            if task.cancelled:
                continue
            idle -= 1
            task.started = True
            task.t_start = now
            req = task.req
            if np.isnan(req.stats.t_first_start):
                req.stats.t_first_start = now
            heapq.heappush(events, (now + task.delay, next(seq), 1, task))

    def pop_next() -> _Request | None:
        nonlocal drr_ptr
        nonempty = [c for c in range(C) if queues[c]]
        if not nonempty:
            return None
        if discipline == "fifo":
            c = min(nonempty, key=lambda c: queues[c][0].stats.arrival)
        elif discipline == "priority":
            c = min(nonempty, key=lambda c: prio[c])
        else:  # deficit round-robin
            while True:
                c = drr_ptr % C
                drr_ptr += 1
                if not queues[c]:
                    deficit[c] = 0.0  # classic DRR: empty class forfeits
                    continue
                deficit[c] += drr_quantum * weights[c] / w_min
                if deficit[c] >= queues[c][0].stats.n:
                    deficit[c] -= queues[c][0].stats.n
                    break
        return queues[c].popleft()

    def admit():
        while idle > 0 and not task_queue:
            req = pop_next()
            if req is None:
                return
            st = req.stats
            s = samplers[st.cls_id] if st.cls_id < len(samplers) else samplers[0]
            # Shared-pool hook: samplers exporting ``sample_indexed`` (e.g.
            # repro_torch.core.traces.PoolSampler) are addressed by the request's
            # arrival index instead of RNG call order, so the oracle reads
            # the same pre-sampled pool rows as the device task engine.
            if hasattr(s, "sample_indexed"):
                delays = np.asarray(
                    s.sample_indexed(st.arrival_index, st.k, st.n), dtype=np.float64
                )
            else:
                delays = np.asarray(s.sample(rng, st.k, st.n), dtype=np.float64)
            req.tasks = [_Task(req, float(d)) for d in delays]
            task_queue.extend(req.tasks)
            start_tasks()

    def observed_q(c: int) -> float:
        if discipline == "fifo":
            return float(sum(len(q) for q in queues))
        if discipline == "priority":
            return float(sum(len(queues[c2]) for c2 in range(C) if prio[c2] <= prio[c]))
        act = [c2 for c2 in range(C) if queues[c2] or c2 == c]
        return len(queues[c]) * sum(weights[c2] for c2 in act) / weights[c]

    while events:
        now, seq_i, kind, payload = heapq.heappop(events)
        if kind == 0:  # arrival
            cls_id = payload
            # A shared policy keeps one state and sees the true class; a
            # per-class policy owns its state and always observes class 0.
            pol = policies if shared_policy else policies[cls_id]
            n, k = pol.select(
                q=observed_q(cls_id), idle=idle,
                cls_id=cls_id if shared_policy else 0, now=now,
            )
            # Arrivals are heap-pushed first with seq 0..T-1 in arrival
            # order, so seq_i IS the global arrival index.
            st = RequestStats(
                arrival=now, cls_id=cls_id, n=int(n), k=int(k), arrival_index=seq_i
            )
            queues[cls_id].append(_Request(st))
            admit()
        else:  # task completion
            task: _Task = payload
            if task.cancelled or task.done:
                continue
            task.done = True
            task.t_end = now
            idle += 1
            req = task.req
            req.stats.completed_tasks += 1
            if req.stats.completed_tasks == req.stats.k:
                req.stats.t_done = now
                done_stats.append(req.stats)
                for t2 in req.tasks:
                    if not t2.done and not t2.cancelled:
                        t2.cancelled = True
                        if t2.started:
                            t2.t_end = now
                            idle += 1
                if event_log is not None:
                    # One row per task lane, finalized at departure: won
                    # tasks keep their completion end, in-service
                    # cancellations end at the departure instant, queued
                    # cancellations never start (NaN start/end).
                    for lane, t2 in enumerate(req.tasks):
                        kind = 0 if t2.done else (2 if t2.started else 1)
                        event_log.append((
                            req.stats.arrival_index, lane, kind,
                            t2.t_start, t2.t_end, now,
                        ))
            start_tasks()
            admit()

    horizon = float(arrivals[-1] - arrivals[0]) if len(arrivals) > 1 else 0.0
    done_stats.sort(key=lambda s: s.arrival)
    n_warm = int(len(done_stats) * warmup_frac)
    return SimResult(stats=done_stats[n_warm:], horizon=horizon)


def poisson_arrivals(rng: np.random.Generator, lam: float, count: int) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / lam, size=count))


def piecewise_poisson_arrivals(
    rng: np.random.Generator, rates: list[tuple[float, float]]
) -> np.ndarray:
    """Arrivals for consecutive (duration_s, rate) segments (Fig.10 setup).

    .. deprecated:: use :class:`repro_torch.fleet.workloads.PiecewiseWorkload`
       directly — this is now a thin wrapper kept for source compatibility
       (draw-for-draw identical RNG consumption). The fleet workload family
       also yields device-ready interarrival arrays from the same spec.
    """
    from repro_torch.fleet.workloads import PiecewiseWorkload

    return PiecewiseWorkload(tuple(rates)).arrival_times(rng)
