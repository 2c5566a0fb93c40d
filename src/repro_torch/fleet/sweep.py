"""Fleet sweep: a whole (λ × policy × seed) grid per chunked device launch.

The port of the reference package's ``repro/fleet/sweep.py``. One grid
point = one row of :func:`repro_torch.core.fluid_scan.tofec_scan_core`. The
sweep stacks every per-point quantity — delay-model params, threshold
tables, redundancy cap, arrival/exponential draws — along a leading grid
axis and runs the scan over it, so a 256-point λ-sweep costs a handful of
launches instead of 256 serial ones.

Uniformity across the grid is manufactured, not assumed:

* **Policies as tables.** The scan's controller is the threshold form
  ``1 + #{h > q̄}``; :func:`static_tables` and :func:`fixedk_tables` encode
  static (n, k) codes and the fixed-k adaptive strategy of [3] into the
  same (h_k, h_n, r_max) triple (sentinel-``BIG``/0 thresholds pin the
  choice), so heterogeneous policy mixes ride one launch — and
  :class:`repro_torch.serve.engine.ServePolicy` runs every threshold policy
  through one controller.
* **Shape buckets.** Runs are keyed, as in the reference, on (chunk,
  pow2-bucketed T, n_max, table lengths, mesh shape, timeline window);
  trailing-zero threshold padding is semantically inert, so heterogeneous
  grids share a bucket. PyTorch has no compilation to share: the first use
  of each bucket is counted in ``stats.traces`` where the reference counts a
  jit trace, which keeps the bound on buckets pinned. Nor does it need the
  reference's zero-gap padding of the time axis up to the bucket's T: the
  streams are exactly ``count`` arrivals wide.
* **Memory-bounded chunked batching.** The grid axis is split into
  ``chunk``-sized launches (the last chunk padded by repetition), bounding
  the per-launch footprint at chunk × count × (n_max + 2) float32s.
"""

from __future__ import annotations

import dataclasses
import types
import warnings

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.coding.codec import pow2_bucket
from repro_torch.core.controller import BIG, FixedKAdaptivePolicy
from repro_torch.core.delay_model import RequestClass
from repro_torch.core.fluid_scan import (
    PARAM_FIELDS,
    FluidScanParams,
    backlog_proxy,
    tofec_scan_core,
)
from repro_torch.core.static_optimizer import ClassPlan, build_class_plan
from repro_torch.fleet.shard import StreamedStats, resolve_grid_mesh, resolve_stream, shard_grid
from repro_torch.fleet.stats import class_params, convergence_reduce, frontier_block_reduce
from repro_torch.fleet.workloads import PoissonWorkload, TenantMix, Workload
from repro_torch.obs.timeline import timeline_window

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
    (:class:`repro_torch.taskq.TaskqSweep`); :func:`policy_tables` raises
    for them.
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
            "backlog); run it on the exact task engine: repro_torch.taskq.TaskqSweep"
        )
    raise ValueError(f"unknown policy kind {spec.kind!r}")


# ---------------------------------------------------------------------------
# Grid construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepCase:
    """One grid point: arrival process × policy × seed (× class, L)."""

    lam: float
    policy: PolicySpec
    seed: int
    cls: RequestClass
    L: int = 16
    workload: Workload | None = None  # default: Poisson(lam)

    def resolved_workload(self) -> Workload:
        return self.workload if self.workload is not None else PoissonWorkload(self.lam)


def grid_cases(
    lams,
    policies,
    seeds,
    cls: RequestClass,
    L: int = 16,
    workload_for=None,
) -> list[SweepCase]:
    """Cartesian λ × policy × seed grid; ``workload_for(lam)`` optionally
    maps each rate to a non-Poisson workload spec."""
    return [
        SweepCase(
            lam=float(lam), policy=pol, seed=int(seed), cls=cls, L=L,
            workload=workload_for(float(lam)) if workload_for else None,
        )
        for lam in lams
        for pol in policies
        for seed in seeds
    ]


def tenant_cases(
    mix: TenantMix, policies, seeds, L: int = 16, *, quiet: bool = False
) -> list[SweepCase]:
    """Expand a multi-tenant mix into per-class grid points (Poisson
    splitting): each class rides the sweep with its own tables and its
    split rate w·λ.

    .. note:: This is the **approximation path**: splitting gives every
       class an independent fluid queue that believes it owns all L
       threads, so cross-class interference (§IV's shared-resource story)
       is invisible. The joint shared-pool simulation is
       :mod:`repro_torch.sched`; pass ``quiet=True`` when the fluid split is
       wanted deliberately.
    """
    if not quiet:
        warnings.warn(
            "tenant_cases() Poisson-splits the mix into independent per-class "
            "fluid queues and cannot show cross-class interference; use "
            "repro_torch.sched (SchedSweep) for the joint shared-pool "
            "simulation. Pass quiet=True to keep the fluid split "
            "deliberately.",
            UserWarning,
            stacklevel=2,
        )
    return [
        SweepCase(lam=sub.lam, policy=pol, seed=int(seed), cls=c, L=L, workload=sub)
        for c, sub in mix.split()
        for pol in policies
        for seed in seeds
    ]


# ---------------------------------------------------------------------------
# The chunked sweep engine
# ---------------------------------------------------------------------------


class ChunkedSweep:
    """Chunked, shape-bucketed case sweeps (the reference's
    ``ChunkedVmapSweep``).

    Owns the bucket cache (first use of a bucket counts in
    ``stats.traces``), the per-(class, L) plan cache, and the chunked launch
    loop (tail chunk padded by repetition, outputs sliced back and
    restacked). Subclasses define the bucket key, the per-case config
    stacking, the launch body and its argument axes (``IN_AXES``: 0 for a
    per-case operand, None for a grid-shared one).

    ``chunk`` bounds the grid points per launch (memory bound); ``t_floor``
    floors the pow2 time-axis bucket (default ``T_FLOOR``), so nearby
    horizon lengths share a bucket.

    ``mesh`` (None | int card count | list of devices | 1-D
    :class:`repro_torch.launch.mesh.Mesh`) cuts every launch's grid rows
    across its devices via :func:`repro_torch.fleet.shard.shard_grid`.
    Buckets are keyed additionally on the mesh shape, and the effective
    chunk is rounded up to a mesh-size multiple so every device owns an
    equal slice. ``device`` is where the chunks are stacked and folded
    (default: the mesh's first device, else ``cuda``).
    """

    #: Floor of the pow2 time-axis bucket (the reference's default).
    T_FLOOR = 512
    #: The launch body's argument axes, one per positional argument.
    IN_AXES: tuple = ()

    def __init__(self, *, chunk: int = 64, t_floor: int | None = None, mesh=None,
                 device=None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.chunk = chunk
        self.t_floor = t_floor or self.T_FLOOR
        self.mesh = resolve_grid_mesh(mesh)
        if device is None and self.mesh is not None:
            device = self.mesh.devices[0]
        self.device = resolve_device(device)
        self.stats = obs.CompileStats(label=f"sweep.{type(self).__name__}")
        self._fns: dict[tuple, object] = {}
        self._plans: dict[tuple, ClassPlan] = {}
        self._last_metrics = None  # MetricsBuf of the most recent run, if collected
        self._last_timeline = None  # per-case TimelineBuf of the most recent run

    @property
    def mesh_shape(self) -> tuple:
        """Device-mesh shape key: () single-device, (D,) for a grid mesh."""
        return () if self.mesh is None else tuple(self.mesh.shape)

    @property
    def mesh_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _chunk_bucket(self, n_cases: int) -> int:
        """Effective per-launch chunk: pow2-bucketed grid size capped at
        ``chunk``, then rounded up to a mesh-size multiple so
        :func:`~repro_torch.fleet.shard.shard_grid` can cut it evenly."""
        c = min(pow2_bucket(n_cases), self.chunk)
        d = self.mesh_size
        return -(-c // d) * d

    def _build(self, key: tuple, collect: bool = False):
        raise NotImplementedError

    def _fn_for(self, key: tuple, collect: bool = False):
        """The launch body of a bucket; its first use counts in ``traces``.

        ``collect`` (telemetry on/off) is part of the key, as in the
        reference: a constant ``REPRO_OBS`` setting keeps the pinned bucket
        counts, and flipping it mid-process is a new bucket."""
        fn = self._fns.get((key, collect))
        if fn is None:
            by_mesh = self.stats.by_mesh
            self.stats.traces += 1
            by_mesh[self.mesh_shape] = by_mesh.get(self.mesh_shape, 0) + 1
            with obs.span("sweep.trace", engine=type(self).__name__,
                          mesh=str(self.mesh_shape)):
                fn = self._build(key, collect)
                if self.mesh is not None:
                    fn = shard_grid(fn, self.mesh, self.IN_AXES)
                self._fns[(key, collect)] = fn
        return fn

    def _plan_for(self, cls: RequestClass, L: int, eq7_factor: float) -> ClassPlan:
        key = (cls, L, eq7_factor)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = build_class_plan(cls, L, eq7_factor=eq7_factor)
        return plan

    def _launch_chunks(self, fn, cfg, streams, G: int, chunk: int, count: int,
                       broadcast: tuple = (), fold=None):
        """ceil(G / chunk) launches over (cfg, *streams, *broadcast); returns
        the stacked (G, count) output dict (on the device). Tail-chunk rows
        are repetitions of row ``lo`` and sliced off before stacking, so
        padding never leaks. ``broadcast`` tensors (already on the device)
        are passed whole to every launch: grid-shared operands with no grid
        axis, such as the task engine's trace pools.

        ``streams`` is a callable ``(idx) -> tuple of (chunk, ...) numpy
        blocks`` generating one chunk's host-side streams on demand from the
        padded case-index array: host memory never holds more than one chunk
        of workload draws.

        ``fold`` streams: called per launch as ``fold(out, cfg_np,
        streams_np, lo)`` with the chunk's (chunk, count) outputs and the
        grid index of its first row, it returns fixed-size per-row
        statistics which are stacked *instead of* the raw block, so a
        streamed sweep never materializes O(G × T).

        A collecting launch body adds ``"obs"`` (a per-case
        :class:`repro_torch.obs.MetricsBuf`) and ``"timeline"`` (a per-case
        :class:`repro_torch.obs.TimelineBuf`) to its outputs; both are
        folded per chunk on the device — metrics cut to the real rows,
        row-reduced and merged, timelines cut and concatenated — and left in
        ``_last_metrics`` / ``_last_timeline``, on both paths.
        """
        outs = []
        mbuf = tlbuf = None
        engine = type(self).__name__
        dev = self.device
        idx = np.empty(chunk, np.intp)  # preallocated chunk-gather indices
        for lo in range(0, G, chunk):
            hi = min(lo + chunk, G)
            with obs.span("sweep.chunk", engine=engine, rows=hi - lo):
                idx[: hi - lo] = np.arange(lo, hi)
                idx[hi - lo:] = lo  # pad the tail chunk by repetition
                with obs.span("sweep.hostgen", engine=engine):
                    cfg_np = {name: v[idx] for name, v in cfg.items()}
                    streams_np = streams(idx)
                with obs.span("sweep.launch", engine=engine):
                    out = fn({name: torch.from_numpy(v).to(dev) for name, v in cfg_np.items()},
                             *(torch.from_numpy(s).to(dev) for s in streams_np), *broadcast,
                             count)
                self.stats.launches += 1
                mb, tl = out.pop("obs", None), out.pop("timeline", None)
                if mb is not None:
                    mb = mb.reduce_rows(hi - lo)
                    mbuf = mb if mbuf is None else mbuf.merge(mb)
                if tl is not None:
                    tl = tl.reduce_rows(hi - lo)
                    tlbuf = tl if tlbuf is None else tlbuf.concat(tl)
                if fold is None:
                    outs.append({name: v[: hi - lo] for name, v in out.items()})
                else:
                    with obs.span("sweep.fold", engine=engine):
                        red = fold(out, cfg_np, streams_np, lo)
                    outs.append({name: v[: hi - lo] for name, v in red.items()})
                del out
        self.stats.cases += G
        self._last_metrics, self._last_timeline = mbuf, tlbuf
        return {name: torch.cat([o[name] for o in outs]) for name in outs[0]}


def frontier_fold(w: int, bins: int):
    """Per-chunk streaming fold for fleet-style (single-class) sweeps.

    Runs the SAME reductions the materialized frontier uses
    (:func:`repro_torch.fleet.stats.frontier_block_reduce` for the
    delay/usage statistics, :func:`repro_torch.fleet.stats.convergence_reduce`
    for the adaptation integers) on one (chunk, count) block at a time, so
    the streamed statistics are bit-exact equals of the materialized ones.
    ``w`` is the warmup cut, ``bins`` any bound exceeding every chosen k.
    """

    def fold(out, cfg_np, streams_np, lo):
        red = dict(frontier_block_reduce(out, *class_params(cfg_np, out["total"].device), w=w,
                                         first=lo))
        red.update(convergence_reduce(out["k"], w=w, bins=bins))
        return red

    return fold


@dataclasses.dataclass
class SweepResult:
    """Stacked per-request outputs for every grid point.

    ``out`` holds tensors of shape (G, count) on the sweep's device:
    ``total``/``queueing``/``service`` delays (float32) and the chosen
    ``n``/``k`` (int32), reduced there by :mod:`repro_torch.fleet.frontier`.
    ``cfg`` is the stacked per-case config (params + tables, numpy).

    A **streamed** run (``run(..., stream=...)``) never materializes the
    (G, count) block: ``out`` is empty and ``streamed`` carries the running
    frontier reduction (:class:`repro_torch.fleet.shard.StreamedStats`).
    """

    cases: list[SweepCase]
    out: dict
    cfg: dict[str, np.ndarray]
    count: int
    compiles: int  # bucket first uses in this run (the reference's jit traces)
    launches: int
    streamed: object = None  # StreamedStats for streamed runs
    metrics: object = None  # MetricsBuf folded across chunks (REPRO_OBS=1)
    timeline: object = None  # per-case TimelineBuf, (G, S) slots (REPRO_OBS=1)
    mesh_shape: tuple = ()

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.out.items()}


class FleetSweep(ChunkedSweep):
    """Chunked, shape-bucketed sweep over :class:`SweepCase` grids."""

    #: The launch body's (cfg, interarrivals, exps, count).
    IN_AXES = (0, 0, 0, None)

    # -- bucket cache -------------------------------------------------------

    def bucket_key(self, n_cases: int, count: int, n_max: int, hk_len: int, hn_len: int):
        """The bucket a run with these shapes lands in (the reference's
        compilation-cache key, unchanged)."""
        t_b = pow2_bucket(count, self.t_floor)
        return (
            self._chunk_bucket(n_cases),
            t_b,
            n_max,
            hk_len,
            hn_len,
            self.mesh_shape,
            timeline_window(t_b),
        )

    def _build(self, key: tuple, collect: bool = False):
        t_b, n_max, window = key[1], key[2], key[-1]

        def launch(cfg, inter, exps, count):
            p = types.SimpleNamespace(**{f: cfg[f] for f in PARAM_FIELDS})
            out = tofec_scan_core(p, cfg["h_k"], cfg["h_n"], cfg["r_max"], inter, exps,
                                  n_max=n_max)
            if collect:
                valid = obs.valid_mask(cfg, count)
                rows = types.SimpleNamespace(**{f: v[:, None] for f, v in vars(p).items()})
                out["obs"] = obs.sweep_point_metrics(out, "fleet", valid=valid)
                out["timeline"] = obs.sweep_timeline(
                    out, inter, window=window, valid=valid, horizon=t_b,
                    backlog=backlog_proxy(rows, out["queueing"]))
            return out

        return launch

    # -- the sweep ----------------------------------------------------------

    def _stack_cfg(self, cases: list[SweepCase], hk_len: int, hn_len: int):
        G = len(cases)
        cfg = {name: np.empty(G, np.float32) for name in (*PARAM_FIELDS, "r_max")}
        cfg["h_k"] = np.zeros((G, hk_len), np.float32)
        cfg["h_n"] = np.zeros((G, hn_len), np.float32)
        for i, case in enumerate(cases):
            plan = (
                self._plan_for(case.cls, case.L, case.policy.eq7_factor)
                if case.policy.kind == "tofec" else None
            )
            h_k, h_n, r_max = policy_tables(case.policy, case.cls, case.L, plan)
            row = FluidScanParams.from_class(case.cls, case.L, case.policy.alpha).row()
            for name, v in row.items():
                cfg[name][i] = v
            cfg["r_max"][i] = r_max
            # Trailing zeros are inert thresholds (0 > q̄ never holds), so
            # shorter per-class tables pad into the shared bucket for free.
            cfg["h_k"][i, : len(h_k)] = h_k
            cfg["h_n"][i, : len(h_n)] = h_n
        return cfg

    def run(self, cases: list[SweepCase], count: int, *, stream=None) -> SweepResult:
        """Evaluate every grid point over ``count`` arrivals.

        Host side: per-case RNG streams generate the workload arrays (the
        reference's streams, draw for draw). Device side: ceil(G / chunk)
        launches of the scan.

        ``stream`` (True or a :class:`repro_torch.fleet.shard.StreamSpec`)
        folds each chunk into running frontier statistics instead of
        stacking the raw (G, count) block.

        With ``REPRO_OBS`` on, the result also carries ``metrics`` (request,
        task and pick counts, the worst delay) and ``timeline`` (per-case
        windowed series and delay histograms); the primary outputs are the
        same bit for bit.
        """
        if not cases:
            raise ValueError("empty case grid")
        spec = resolve_stream(stream)
        traces0, launches0 = self.stats.traces, self.stats.launches
        n_max = max(c.cls.n_max for c in cases)
        hk_len = max(c.cls.k_max for c in cases) + 1
        hn_len = n_max + 1
        key = self.bucket_key(len(cases), count, n_max, hk_len, hn_len)
        chunk = key[0]
        cfg = self._stack_cfg(cases, hk_len, hn_len)
        collect = obs.enabled()
        if collect:
            # Runtime row, not a bucket-key entry: the real arrival count.
            cfg["obs_count"] = np.full(len(cases), count, np.int32)

        # The reference pads the time axis to the bucket's T with zero gaps
        # and slices their outputs off; the scan is causal, so here the
        # streams are ``count`` wide and the padding is never built.
        def chunk_streams(idx):
            inter = np.empty((len(idx), count), np.float32)
            exps = np.zeros((len(idx), count, n_max), np.float32)
            for j, i in enumerate(idx):
                if j and i == idx[0]:  # tail pad: repeat the chunk's row 0
                    inter[j], exps[j] = inter[0], exps[0]
                    continue
                case = cases[i]
                rng = np.random.default_rng(case.seed)
                it, ex = case.resolved_workload().device_arrays(rng, count, case.cls.n_max)
                inter[j] = it
                # Classes with smaller n_max leave trailing Exp columns at
                # zero; the scan masks draws at j >= k, so padding never
                # enters.
                exps[j, :, : case.cls.n_max] = ex
            return inter, exps

        fn = self._fn_for(key, collect)
        fold = frontier_fold(int(count * spec.warmup_frac), hn_len) if spec else None
        stacked = self._launch_chunks(fn, cfg, chunk_streams, len(cases), chunk, count,
                                      fold=fold)
        return SweepResult(
            cases=list(cases),
            out={} if spec else stacked,
            cfg=cfg,
            count=count,
            compiles=self.stats.traces - traces0,
            launches=self.stats.launches - launches0,
            streamed=StreamedStats(spec.warmup_frac, count, stacked) if spec else None,
            metrics=self._last_metrics,
            timeline=self._last_timeline,
            mesh_shape=self.mesh_shape,
        )
