"""Shared-pool sweep: (mix × discipline × seed) grids, jointly.

The port of the reference package's ``repro/sched/sweep.py``. It mirrors
:class:`repro_torch.fleet.sweep.FleetSweep` — the bucket cache, chunked
launches, policies as threshold tables — but each grid row is a whole
multi-class system: one merged arrival stream, one L-thread pool,
per-class TOFEC state, and a per-row admission discipline
(:mod:`repro_torch.sched.scan`). Disciplines travel as data (id + rank +
weight arrays), so a grid mixing FIFO, strict priority and weighted-fair
rows runs in one bucket — held in ``tests/test_torch_sched.py``.

Shared-bucket rule: within one :meth:`SchedSweep.run`, every case is padded
to the run's widest class count C (dummy classes get zero tables, zero
weight and the lowest priority; their ids never occur in ``cls_ids``, so
they are inert), and the bucket key is (chunk, pow2(T), C, n_max, table
lengths), the reference's.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from repro_torch import obs
from repro_torch.coding.codec import pow2_bucket
from repro_torch.fleet.shard import StreamedStats, resolve_stream
from repro_torch.fleet.sweep import ChunkedSweep, PolicySpec, policy_tables
from repro_torch.fleet.workloads import TenantMix
from repro_torch.sched.frontier import _reduce_multiclass
from repro_torch.sched.scan import (
    CLASS_FIELDS,
    DISC_FIFO,
    DISC_PRIORITY,
    DISC_WFQ,
    multiclass_scan_core,
)


@dataclasses.dataclass(frozen=True)
class DisciplineSpec:
    """Declarative admission discipline for one grid point.

    ``prio`` (priority only): per-class ranks, a permutation of range(C),
    lower = served first. ``weights`` (wfq only): positive per-class shares.
    """

    kind: str
    prio: tuple = ()
    weights: tuple = ()

    @classmethod
    def fifo(cls) -> "DisciplineSpec":
        return cls("fifo")

    @classmethod
    def priority(cls, *prio: int) -> "DisciplineSpec":
        return cls("priority", prio=tuple(int(r) for r in prio))

    @classmethod
    def wfq(cls, *weights: float) -> "DisciplineSpec":
        return cls("wfq", weights=tuple(float(w) for w in weights))

    @property
    def name(self) -> str:
        if self.kind == "priority":
            return f"priority({','.join(map(str, self.prio))})"
        if self.kind == "wfq":
            return f"wfq({':'.join(f'{w:g}' for w in self.weights)})"
        return "fifo"

    def validate(self, C: int) -> None:
        if self.kind == "priority":
            if sorted(self.prio) != list(range(C)):
                raise ValueError(f"priority ranks {self.prio} must permute range({C})")
        elif self.kind == "wfq":
            if len(self.weights) != C or any(w <= 0 for w in self.weights):
                raise ValueError(f"wfq weights {self.weights} must be {C} positives")
        elif self.kind != "fifo":
            raise ValueError(f"unknown discipline kind {self.kind!r}")

    def encode(self, C: int, C_pad: int):
        """(disc_id, prio (C_pad,), weights (C_pad,)) arrays.

        Padded classes rank below every real one and carry zero weight —
        they never arrive, never backlog, never receive pool share.
        """
        self.validate(C)
        disc = {"fifo": DISC_FIFO, "priority": DISC_PRIORITY, "wfq": DISC_WFQ}[self.kind]
        prio = np.arange(C_pad, dtype=np.float32)
        if self.kind == "priority":
            prio[:C] = np.asarray(self.prio, np.float32)
            prio[C:] = C + np.arange(C_pad - C)
        weights = np.zeros(C_pad, np.float32)
        weights[:C] = np.asarray(self.weights, np.float32) if self.kind == "wfq" else 1.0
        return disc, prio, weights


@dataclasses.dataclass(frozen=True)
class SchedCase:
    """One grid point: a tenant mix × discipline × per-class policies × seed."""

    mix: TenantMix
    discipline: DisciplineSpec
    policy: object = None  # PolicySpec (shared) | tuple[PolicySpec, ...] | None→tofec
    seed: int = 0
    L: int = 16

    @property
    def lam(self) -> float:
        return self.mix.lam

    def policies(self) -> tuple[PolicySpec, ...]:
        C = len(self.mix.classes)
        pol = self.policy if self.policy is not None else PolicySpec.tofec()
        if isinstance(pol, PolicySpec):
            return (pol,) * C
        pol = tuple(pol)
        if len(pol) != C:
            raise ValueError(f"need {C} per-class policies, got {len(pol)}")
        return pol


def sched_cases(mixes, disciplines, seeds, *, policy=None, L: int = 16) -> list[SchedCase]:
    """Cartesian mix × discipline × seed grid of :class:`SchedCase`."""
    return [
        SchedCase(mix=mix, discipline=disc, policy=policy, seed=int(seed), L=L)
        for mix in mixes
        for disc in disciplines
        for seed in seeds
    ]


def multiclass_fold(w: int, C: int):
    """Per-chunk streaming fold for joint multi-class sweeps.

    Runs the SAME per-class reduction the materialized path uses
    (:func:`repro_torch.sched.frontier._reduce_multiclass`, over blocks of
    the same row count) on one (chunk, count) block at a time, with the
    chunk's class ids taken from its host streams (the second stream), so
    the streamed per-class statistics are bit-exact equals of the
    materialized ones.
    """

    def fold(out, cfg_np, streams_np, lo):
        ids = torch.from_numpy(streams_np[1]).to(out["total"].device)
        return _reduce_multiclass({**out, "cls_ids": ids}, C=C, w=w, first=lo)

    return fold


@dataclasses.dataclass
class SchedResult:
    """Stacked per-request outputs for every joint grid point.

    ``out`` holds (G, count) tensors on the sweep's device
    (``total``/``queueing``/``service`` float32, ``n``/``k`` int32) plus
    ``cls_ids`` (G, count) int32 — kept on the device so
    :mod:`repro_torch.sched.frontier` masks per-class reductions there. A
    **streamed** run leaves ``out`` empty and carries the running per-class
    reduction in ``streamed`` (:class:`repro_torch.fleet.shard.StreamedStats`).
    """

    cases: list[SchedCase]
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


class SchedSweep(ChunkedSweep):
    """Chunked, shape-bucketed sweep over :class:`SchedCase` grids.

    Shares the bucket cache, launch counting and chunked launch loop with
    :class:`repro_torch.fleet.sweep.FleetSweep` via
    :class:`repro_torch.fleet.sweep.ChunkedSweep`; differs in the bucket key
    (a class axis C), the per-case config (per-class vectors + discipline
    encoding) and the scan body (the joint multi-class core).
    """

    #: The launch body's (cfg, interarrivals, class ids, exps, count).
    IN_AXES = (0, 0, 0, 0, None)

    # -- bucket cache -------------------------------------------------------

    def bucket_key(self, n_cases: int, count: int, C: int, n_max: int,
                   hk_len: int, hn_len: int):
        """The bucket a run with these shapes lands in (the reference's
        compilation-cache key, unchanged)."""
        t_b = pow2_bucket(count, self.t_floor)
        return (
            self._chunk_bucket(n_cases),
            t_b,
            C,
            n_max,
            hk_len,
            hn_len,
            self.mesh_shape,
            obs.timeline_window(t_b),
        )

    def _build(self, key: tuple, collect: bool = False):
        t_b, n_max, window = key[1], key[3], key[-1]

        def launch(cfg, inter, cls_ids, exps, count):
            p = types.SimpleNamespace(L=cfg["L"], **{f: cfg[f] for f in CLASS_FIELDS})
            out = multiclass_scan_core(p, cfg["h_k"], cfg["h_n"], cfg["disc"], cfg["prio"],
                                       cfg["wfq_w"], inter, cls_ids, exps, n_max=n_max)
            if collect:
                valid = obs.valid_mask(cfg, count)
                out["obs"] = obs.sweep_point_metrics(out, "sched", valid=valid)
                # The joint scan has no single-queue backlog (the pool is
                # shared across classes): rate, pick and delay series only.
                out["timeline"] = obs.sweep_timeline(out, inter, window=window, valid=valid,
                                                     horizon=t_b)
            return out

        return launch

    # -- the sweep ----------------------------------------------------------

    def _stack_cfg(self, cases: list[SchedCase], C: int, hk_len: int, hn_len: int):
        G = len(cases)
        cfg = {name: np.zeros((G, C), np.float32) for name in CLASS_FIELDS}
        cfg["L"] = np.empty(G, np.float32)
        cfg["disc"] = np.empty(G, np.int32)
        cfg["prio"] = np.zeros((G, C), np.float32)
        cfg["wfq_w"] = np.zeros((G, C), np.float32)
        cfg["h_k"] = np.zeros((G, C, hk_len), np.float32)
        cfg["h_n"] = np.zeros((G, C, hn_len), np.float32)
        for i, case in enumerate(cases):
            disc, prio, wfq_w = case.discipline.encode(len(case.mix.classes), C)
            cfg["L"][i] = case.L
            cfg["disc"][i] = disc
            cfg["prio"][i] = prio
            cfg["wfq_w"][i] = wfq_w
            for c, (cls, spec) in enumerate(zip(case.mix.classes, case.policies())):
                plan = (
                    self._plan_for(cls, case.L, spec.eq7_factor)
                    if spec.kind == "tofec" else None
                )
                h_k, h_n, r_max = policy_tables(spec, cls, case.L, plan)
                pr = cls.params
                cfg["delta_bar"][i, c] = pr.delta_bar
                cfg["delta_tilde"][i, c] = pr.delta_tilde
                cfg["psi_bar"][i, c] = pr.psi_bar
                cfg["psi_tilde"][i, c] = pr.psi_tilde
                cfg["J"][i, c] = cls.file_mb
                # The usage's constant products, rounded once from float64
                # (the fluid scan's grid fields; see core/fluid_scan.py).
                cfg["delta_tilde_J"][i, c] = pr.delta_tilde * cls.file_mb
                cfg["psi_tilde_J"][i, c] = pr.psi_tilde * cls.file_mb
                cfg["alpha"][i, c] = spec.alpha
                cfg["r_max"][i, c] = r_max
                cfg["h_k"][i, c, : len(h_k)] = h_k
                cfg["h_n"][i, c, : len(h_n)] = h_n
        return cfg

    def run(self, cases: list[SchedCase], count: int, *, stream=None) -> SchedResult:
        """Evaluate every joint grid point over ``count`` merged arrivals.

        Host side: per-case RNG streams generate merged interarrivals,
        exponential draws and class-id streams (one ``default_rng(seed)``
        per case, the reference's draws), ``count`` arrivals wide. Device
        side: ceil(G / chunk) scan loops.

        ``stream`` (True or a :class:`repro_torch.fleet.shard.StreamSpec`)
        folds each chunk into the per-class frontier statistics instead of
        stacking the (G, count) block.

        With ``REPRO_OBS`` on, the result also carries ``metrics`` and
        ``timeline``; the primary outputs are the same bit for bit.
        """
        if not cases:
            raise ValueError("empty case grid")
        spec = resolve_stream(stream)
        traces0, launches0 = self.stats.traces, self.stats.launches
        C = max(len(case.mix.classes) for case in cases)
        n_max = max(c.n_max for case in cases for c in case.mix.classes)
        hk_len = max(c.k_max for case in cases for c in case.mix.classes) + 1
        hn_len = n_max + 1
        key = self.bucket_key(len(cases), count, C, n_max, hk_len, hn_len)
        chunk = key[0]
        cfg = self._stack_cfg(cases, C, hk_len, hn_len)
        G = len(cases)
        collect = obs.enabled()
        if collect:
            cfg["obs_count"] = np.full(G, count, np.int32)
        # Materialized runs keep the class-id streams for the per-class
        # reductions; streamed runs fold them per chunk and never stack them.
        ids_full = None if spec else np.zeros((G, count), np.int32)

        def chunk_streams(idx):
            inter = np.empty((len(idx), count), np.float32)
            ids = np.empty((len(idx), count), np.int32)
            exps = np.zeros((len(idx), count, n_max), np.float32)
            for j, i in enumerate(idx):
                if j and i == idx[0]:  # tail pad: repeat the chunk's row 0
                    inter[j], ids[j], exps[j] = inter[0], ids[0], exps[0]
                    continue
                case = cases[i]
                rng = np.random.default_rng(case.seed)
                case_n_max = max(c.n_max for c in case.mix.classes)
                inter[j], ex, ids[j] = case.mix.multiclass_device_arrays(rng, count, case_n_max)
                # Narrower classes leave trailing Exp columns at zero; the
                # scan masks draws at j >= k, so the padding never enters.
                exps[j, :, :case_n_max] = ex
                if ids_full is not None:
                    ids_full[i] = ids[j]
            return inter, ids, exps

        fn = self._fn_for(key, collect)
        fold = multiclass_fold(int(count * spec.warmup_frac), C) if spec else None
        stacked = self._launch_chunks(fn, cfg, chunk_streams, G, chunk, count, fold=fold)
        if not spec:
            stacked["cls_ids"] = torch.from_numpy(ids_full).to(self.device)
        return SchedResult(
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
