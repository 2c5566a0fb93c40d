"""Task-level sweep: exact (λ × policy × seed) grids per chunked launch.

The port of the reference package's ``repro/taskq/sweep.py``. It mirrors
:class:`repro_torch.fleet.sweep.FleetSweep` — the same
:class:`~repro_torch.fleet.sweep.ChunkedSweep` bucket cache and chunked
launches — but each grid row runs the exact task-level engine
(:func:`repro_torch.taskq.engine.taskq_scan_core`) instead of the fluid
scan, and the per-chunk-size delay pools are passed to every launch as one
device copy shared by the whole grid (the reference's ``in_axes None``).

Cases are plain :class:`repro_torch.fleet.sweep.SweepCase` grids (reuse
``grid_cases``), so a fleet grid re-runs on the exact engine unchanged —
plus ``PolicySpec.greedy()`` rows, which only this sweep accepts.
Reductions reuse :func:`repro_torch.fleet.frontier.frontier_points`
unchanged, and :func:`write_taskq_artifact` writes the ``BENCH_taskq.json``
twin of the fleet artifact.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch import obs
from repro_torch.coding.codec import pow2_bucket
from repro_torch.core.traces import DevicePools
from repro_torch.fleet.frontier import (
    capacity_estimates,
    convergence_stats,
    frontier_points,
    headline_ratios,
)
from repro_torch.fleet.shard import StreamedStats, resolve_stream
from repro_torch.fleet.sweep import (
    ChunkedSweep,
    SweepCase,
    SweepResult,
    frontier_fold,
)
from repro_torch.taskq.engine import taskq_scan, taskq_scan_core
from repro_torch.taskq.policies import encode_policy


def taskq_streams(case: SweepCase, count: int, n_rows: int):
    """One grid point's host-side draws: (interarrivals, pool row indices).

    The draw order — workload gaps first, then row indices, from ONE
    ``default_rng(case.seed)`` stream — is the contract both the sweep and
    the oracle cross-validation rely on to feed identical randomness to
    both engines (the reference's streams, draw for draw).
    """
    rng = np.random.default_rng(case.seed)
    inter = case.resolved_workload().interarrivals(rng, count)
    idx = rng.integers(n_rows, size=count).astype(np.int32)
    return inter, idx


@dataclasses.dataclass
class TaskqResult(SweepResult):
    """Stacked per-request outputs for every exact grid point — the layout
    of :class:`repro_torch.fleet.sweep.SweepResult`, so the fleet's frontier
    reductions consume it unchanged; here the delays are exact task-level
    simulations."""


class TaskqSweep(ChunkedSweep):
    """Chunked, shape-bucketed sweep over exact task-level grid points.

    ``q_cap`` bounds the backlog-length observable (see
    :mod:`repro_torch.taskq.engine`); all cases of one run must share ``L``
    (the thread-state width). Buckets are keyed on (chunk, pow2(T), L,
    q_cap, table lengths, pool shape), the reference's key; their first
    uses are counted in ``stats.traces``.
    """

    #: The launch body's (cfg, interarrivals, pool rows, pools, sizes, count):
    #: the trace pools are grid-shared.
    IN_AXES = (0, 0, 0, None, None, None)

    def __init__(self, *, chunk: int = 64, q_cap: int = 128, t_floor: int | None = None,
                 mesh=None, device=None):
        super().__init__(chunk=chunk, t_floor=t_floor, mesh=mesh, device=device)
        if q_cap < 1:
            raise ValueError("q_cap must be >= 1")
        self.q_cap = q_cap

    # -- bucket cache -------------------------------------------------------

    def bucket_key(self, n_cases: int, count: int, L: int, hk_len: int,
                   hn_len: int, pool_shape: tuple):
        """The bucket a run with these shapes lands in (the reference's
        compilation-cache key, unchanged)."""
        t_b = pow2_bucket(count, self.t_floor)
        return (
            self._chunk_bucket(n_cases),
            t_b,
            L,
            self.q_cap,
            hk_len,
            hn_len,
            tuple(pool_shape),
            self.mesh_shape,
            obs.timeline_window(t_b),
        )

    def _build(self, key: tuple, collect: bool = False):
        t_b, L, q_cap, window = key[1], key[2], key[3], key[-1]

        def launch(cfg, inter, idx, pools, sizes, count):
            valid = obs.valid_mask(cfg, count) if collect else None
            out = taskq_scan_core(cfg, inter, idx, pools, sizes, L=L, q_cap=q_cap,
                                  collect=collect, valid=valid,
                                  window=window if collect else None, horizon=t_b)
            if collect:
                # The engine's buffer (cancellations, idle, backlog) rides with
                # the generic per-case picks; disjoint names union-merge.
                out["obs"] = out["obs"].merge(
                    obs.sweep_point_metrics(out, "taskq", valid=valid))
            return out

        return launch

    # -- the sweep ----------------------------------------------------------

    def _stack_cfg(self, cases: list[SweepCase], hk_len: int, hn_len: int):
        G = len(cases)
        cfg = {
            name: np.empty(G, np.float32)
            for name in ("delta_bar", "delta_tilde", "psi_bar", "psi_tilde",
                         "J", "L", "alpha", "r_max")
        }
        cfg["pol"] = np.empty(G, np.int32)
        cfg["gk_max"] = np.empty(G, np.int32)
        cfg["h_k"] = np.zeros((G, hk_len), np.float32)
        cfg["h_n"] = np.zeros((G, hn_len), np.float32)
        for i, case in enumerate(cases):
            plan = (
                self._plan_for(case.cls, case.L, case.policy.eq7_factor)
                if case.policy.kind == "tofec" else None
            )
            enc = encode_policy(case.policy, case.cls, case.L, hk_len, hn_len, plan)
            pr = case.cls.params
            # delta/psi params ride along for the frontier's usage reduction
            # (the engine itself reads delays from the trace pools).
            cfg["delta_bar"][i] = pr.delta_bar
            cfg["delta_tilde"][i] = pr.delta_tilde
            cfg["psi_bar"][i] = pr.psi_bar
            cfg["psi_tilde"][i] = pr.psi_tilde
            cfg["J"][i] = case.cls.file_mb
            cfg["L"][i] = case.L
            cfg["alpha"][i] = enc.alpha
            cfg["r_max"][i] = enc.r_max
            cfg["pol"][i] = enc.pol
            cfg["gk_max"][i] = enc.gk_max
            cfg["h_k"][i] = enc.h_k
            cfg["h_n"][i] = enc.h_n
        return cfg

    def run(self, cases: list[SweepCase], count: int, pools: DevicePools, *,
            stream=None) -> TaskqResult:
        """Evaluate every grid point exactly over ``count`` arrivals.

        Host side: per-case RNG streams (:func:`taskq_streams`), ``count``
        arrivals wide (the engine is causal, so the reference's zero-gap
        padding up to the bucket's T is never built). Device side:
        ceil(G / chunk) scan loops sharing one device copy of ``pools``.

        ``stream`` (True or a :class:`repro_torch.fleet.shard.StreamSpec`)
        folds each chunk into the fleet frontier statistics instead of
        stacking the exact (G, count) block.

        With ``REPRO_OBS`` on, the result also carries ``metrics`` (the
        engine's cancellation split, idle histogram and backlog high-water
        mark, plus request, task and pick counts) and ``timeline`` (per-case
        windowed series with the exact backlog); the primary outputs are the
        same bit for bit.
        """
        if not cases:
            raise ValueError("empty case grid")
        spec = resolve_stream(stream)
        Ls = {c.L for c in cases}
        if len(Ls) != 1:
            raise ValueError(f"all cases of one run must share L, got {sorted(Ls)}")
        L = Ls.pop()
        n_need = max(c.cls.n_max for c in cases)
        if pools.pools.shape[2] < n_need:
            raise ValueError(
                f"pool width {pools.pools.shape[2]} cannot serve "
                f"n_max={n_need}; re-export with "
                f"TraceStore.device_pools(n_max={n_need})"
            )
        traces0, launches0 = self.stats.traces, self.stats.launches
        hk_len = max(c.cls.k_max for c in cases) + 1
        hn_len = n_need + 1
        key = self.bucket_key(len(cases), count, L, hk_len, hn_len, pools.pools.shape)
        chunk = key[0]
        cfg = self._stack_cfg(cases, hk_len, hn_len)
        collect = obs.enabled()
        if collect:
            cfg["obs_count"] = np.full(len(cases), count, np.int32)

        def chunk_streams(rows):
            inter = np.empty((len(rows), count), np.float32)
            idx = np.empty((len(rows), count), np.int32)
            for j, i in enumerate(rows):
                if j and i == rows[0]:  # tail pad: repeat the chunk's row 0
                    inter[j], idx[j] = inter[0], idx[0]
                    continue
                inter[j], idx[j] = taskq_streams(cases[i], count, pools.n_rows)
            return inter, idx

        fn = self._fn_for(key, collect)
        fold = frontier_fold(int(count * spec.warmup_frac), hn_len) if spec else None
        # The one device copy of the pools every chunk reads.
        broadcast = (pools.pools.to(self.device), pools.sizes_mb.to(self.device))
        stacked = self._launch_chunks(fn, cfg, chunk_streams, len(cases), chunk, count,
                                      broadcast=broadcast, fold=fold)
        return TaskqResult(
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

    def replay_flight(self, result: TaskqResult, pools: DevicePools, case_index: int, *,
                      label: str | None = None) -> obs.FlightLog:
        """Re-run ONE grid point of ``result`` with the flight recorder on.

        The "aggregate engines stream, flight replays one case" rule: grid
        runs keep their streamed/stacked reductions, and an anomalous cell
        is zoomed into after the fact — this regenerates the case's host
        streams from its seed (:func:`taskq_streams`), replays it through
        :func:`repro_torch.taskq.engine.taskq_scan` with ``flight=True`` on
        the sweep's device (no sweep bucket is touched) and returns the
        :class:`repro_torch.obs.FlightLog`. The replay consumes the stored
        ``result.cfg`` row, so its per-request delays equal the sweep
        cell's.
        """
        G = len(result.cases)
        if not 0 <= case_index < G:
            raise ValueError(f"case_index {case_index} outside grid of {G}")
        case = result.cases[case_index]
        cfg_row = {name: np.asarray(v[case_index])
                   for name, v in result.cfg.items() if name != "obs_count"}
        inter, idx = taskq_streams(case, result.count, pools.n_rows)
        out = taskq_scan(cfg_row, np.asarray(inter, np.float32), np.asarray(idx, np.int32),
                         pools.pools.to(self.device), pools.sizes_mb.to(self.device),
                         L=case.L, q_cap=self.q_cap, collect=False, flight=True)
        return obs.FlightLog(out, label=label or f"taskq[{case_index}]:{case.policy.name}")


def write_taskq_artifact(
    path: str,
    result: TaskqResult,
    *,
    warmup_frac: float = 0.05,
    extra: dict | None = None,
    flight=None,
    flight_top_k: int = 3,
) -> dict:
    """Reduce an exact sweep and write the ``BENCH_taskq.json`` artifact.

    Reuses the fleet's frontier reductions (per-point delay stats, per-policy
    capacities, convergence, headline ratios) on the exact per-request
    delays.

    ``flight``: optional :class:`repro_torch.obs.FlightLog` from a
    :meth:`TaskqSweep.replay_flight` zoom of one cell — adds a ``"flight"``
    block with the structural counts (records emitted, exemplars found)
    plus the replayed case's label.
    """
    points = frontier_points(result, warmup_frac)
    artifact = {
        "schema": "repro.taskq/BENCH_taskq/v1",
        "meta": obs.run_meta(mesh_shape=getattr(result, "mesh_shape", ())),
        "grid_size": len(result.cases),
        "count": result.count,
        "compiles": result.compiles,
        "launches": result.launches,
        "points": [p.to_dict() for p in points],
        "capacity_req_s": capacity_estimates(points),
        "convergence": convergence_stats(result, warmup_frac),
        "headline": headline_ratios(points),
    }
    if flight is not None:
        exemplars = flight.exemplars(flight_top_k)
        artifact["flight"] = {
            "label": flight.label,
            "requests": len(flight),
            "records": len(flight.records()),
            "exemplars": len(exemplars),
            "exemplar_reqs": [ex["req"] for ex in exemplars],
        }
    if extra:
        artifact.update(extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return artifact
