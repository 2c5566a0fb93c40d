"""Workload-generator family: one spec, two consumers.

Every workload answers the same two questions from one spec and one RNG
stream:

* ``arrival_times(rng)`` — absolute arrival instants for the discrete-event
  oracle (:func:`repro_torch.core.simulator.simulate`), and
* ``interarrivals(rng, count)`` — a fixed-length device-ready float32 array
  for the jitted scan (:func:`repro_torch.core.fluid_scan.tofec_scan_core`) and the
  fleet sweep.

Generators (the scenario diversity of the journal version arXiv:1403.5007
and FAST CLOUD arXiv:1301.1294):

* :class:`PoissonWorkload`    — homogeneous Poisson(λ).
* :class:`MMPPWorkload`       — Markov-modulated Poisson: exponential dwell
                                in each state, per-state rate (bursty).
* :class:`DiurnalWorkload`    — sinusoidal rate λ(t) = base·(1 + a·sin(·)).
* :class:`FlashCrowdWorkload` — step to a peak rate on [t_on, t_off).
* :class:`PiecewiseWorkload`  — piecewise-constant trace replay; absorbs
                                ``repro_torch.core.simulator.piecewise_poisson_
                                arrivals`` (now a thin wrapper over this).
* :class:`TenantMix`          — multi-class tenant mixes over
                                :class:`repro_torch.core.delay_model.RequestClass`
                                (per-class arrival splits + event-sim
                                class-id streams).

Time-varying rates use exact methods where the rate is piecewise constant
(per-segment/per-dwell exponentials) and Lewis-Shedler thinning for the
continuous diurnal profile.

A copy of the reference package's ``repro/fleet/workloads.py`` (host numpy,
draw for draw the same streams).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.delay_model import RequestClass


def _as_float32(times: np.ndarray, count: int | None) -> np.ndarray:
    inter = np.diff(times, prepend=0.0).astype(np.float32)
    if count is not None:
        inter = inter[:count]
    return inter


class Workload:
    """Interface: a stochastic arrival process with a well-defined mean rate."""

    def mean_rate(self) -> float:
        raise NotImplementedError

    def arrival_times(self, rng: np.random.Generator, horizon: float | None = None) -> np.ndarray:
        """Absolute arrival times on [0, horizon); default horizon covers
        ~``DEFAULT_COUNT`` arrivals at the mean rate."""
        raise NotImplementedError

    DEFAULT_COUNT = 4096

    def interarrivals(self, rng: np.random.Generator, count: int) -> np.ndarray:
        """(count,) float32 interarrival gaps — the device-ready form.

        Generic implementation: draw arrival times over a horizon sized for
        ``count`` arrivals at the mean rate (retrying with a larger horizon
        on shortfall), then difference.
        """
        horizon = 1.25 * count / self.mean_rate()
        for _ in range(16):
            times = self.arrival_times(rng, horizon)
            if len(times) >= count:
                return _as_float32(times, count)
            horizon *= 2.0
        raise RuntimeError(f"workload {self!r} could not produce {count} arrivals")

    def device_arrays(
        self, rng: np.random.Generator, count: int, n_max: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(interarrivals (count,), Exp(1) draws (count, n_max)) — everything
        one fleet grid point feeds the scan."""
        inter = self.interarrivals(rng, count)
        exps = rng.exponential(1.0, size=(count, n_max)).astype(np.float32)
        return inter, exps


@dataclasses.dataclass(frozen=True)
class PoissonWorkload(Workload):
    """Homogeneous Poisson arrivals at rate ``lam``."""

    lam: float

    def mean_rate(self) -> float:
        return self.lam

    def arrival_times(self, rng, horizon=None):
        horizon = horizon or self.DEFAULT_COUNT / self.lam
        # Draw in blocks of the expected count (+5σ) until past the horizon.
        n_exp = max(int(self.lam * horizon + 5.0 * np.sqrt(self.lam * horizon)), 16)
        times = np.cumsum(rng.exponential(1.0 / self.lam, size=n_exp))
        while times[-1] < horizon:
            times = np.concatenate(
                [times, times[-1] + np.cumsum(rng.exponential(1.0 / self.lam, size=n_exp))]
            )
        return times[times < horizon]

    def interarrivals(self, rng, count):
        return rng.exponential(1.0 / self.lam, size=count).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MMPPWorkload(Workload):
    """Markov-modulated Poisson process: exponential dwells, per-state rates.

    ``rates[i]`` is the Poisson rate in state i; ``dwell[i]`` the mean dwell
    time. The classic 2-state on/off burst model is ``rates=(lo, hi)``;
    states cycle (i → i+1 mod S), which for S = 2 is exactly the alternating
    renewal burst process.
    """

    rates: tuple[float, ...]
    dwell: tuple[float, ...]

    def __post_init__(self):
        if len(self.rates) != len(self.dwell) or not self.rates:
            raise ValueError("rates and dwell must be equal-length, non-empty")

    def mean_rate(self) -> float:
        d = np.asarray(self.dwell)
        return float(np.dot(self.rates, d) / d.sum())

    def arrival_times(self, rng, horizon=None):
        horizon = horizon or self.DEFAULT_COUNT / self.mean_rate()
        out, t, state = [], 0.0, 0
        while t < horizon:
            stay = rng.exponential(self.dwell[state])
            end = min(t + stay, horizon)
            lam = self.rates[state]
            if lam > 0.0:
                tt = t
                while True:
                    tt += rng.exponential(1.0 / lam)
                    if tt >= end:
                        break
                    out.append(tt)
            t += stay
            state = (state + 1) % len(self.rates)
        return np.asarray(out)


@dataclasses.dataclass(frozen=True)
class DiurnalWorkload(Workload):
    """Sinusoidal rate λ(t) = base·(1 + amplitude·sin(2πt/period))."""

    base: float
    amplitude: float
    period: float

    def __post_init__(self):
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1) so the rate stays positive")

    def mean_rate(self) -> float:
        return self.base

    def rate(self, t: np.ndarray) -> np.ndarray:
        return self.base * (1.0 + self.amplitude * np.sin(2.0 * np.pi * t / self.period))

    def arrival_times(self, rng, horizon=None):
        horizon = horizon or self.DEFAULT_COUNT / self.base
        # Lewis-Shedler thinning against the envelope rate, in blocks.
        lam_max = self.base * (1.0 + self.amplitude)
        out, t = [], 0.0
        block = max(int(lam_max * horizon / 4), 64)
        while t < horizon:
            gaps = rng.exponential(1.0 / lam_max, size=block)
            cand = t + np.cumsum(gaps)
            keep = rng.uniform(size=block) * lam_max < self.rate(cand)
            out.append(cand[keep])
            t = cand[-1]
        times = np.concatenate(out)
        return times[times < horizon]


@dataclasses.dataclass(frozen=True)
class FlashCrowdWorkload(Workload):
    """Step workload: ``base`` rate, jumping to ``peak`` on [t_on, t_off)."""

    base: float
    peak: float
    t_on: float
    t_off: float

    def __post_init__(self):
        if not 0.0 <= self.t_on < self.t_off:
            raise ValueError("need 0 <= t_on < t_off")

    def mean_rate(self) -> float:
        # Rate averaged over one "episode" [0, t_off + t_on) — used only to
        # size horizons, so the pre/post-flash base split is fine.
        span = self.t_off + self.t_on
        burst = self.t_off - self.t_on
        return (self.base * (span - burst) + self.peak * burst) / span

    def _segments(self, horizon: float) -> list[tuple[float, float]]:
        segs = [(min(self.t_on, horizon), self.base)]
        if horizon > self.t_on:
            segs.append((min(self.t_off, horizon) - self.t_on, self.peak))
        if horizon > self.t_off:
            segs.append((horizon - self.t_off, self.base))
        return [(d, r) for d, r in segs if d > 0.0]

    def arrival_times(self, rng, horizon=None):
        horizon = horizon or self.DEFAULT_COUNT / self.mean_rate()
        return PiecewiseWorkload(tuple(self._segments(horizon))).arrival_times(rng, horizon)


@dataclasses.dataclass(frozen=True)
class PiecewiseWorkload(Workload):
    """Piecewise-constant trace replay: consecutive (duration_s, rate)
    segments, cycled if more arrivals are requested than one pass provides
    (the paper's Fig.10 transient setup is one pass of three segments)."""

    segments: tuple[tuple[float, float], ...]

    def __post_init__(self):
        if not self.segments or any(d <= 0 or r < 0 for d, r in self.segments):
            raise ValueError("segments must be non-empty (duration>0, rate>=0) pairs")

    def total_duration(self) -> float:
        return float(sum(d for d, _ in self.segments))

    def mean_rate(self) -> float:
        return float(sum(d * r for d, r in self.segments) / self.total_duration())

    def arrival_times(self, rng, horizon=None):
        """One pass over the segments (clipped/cycled to ``horizon``).

        Draw-for-draw identical to the historical
        ``repro_torch.core.simulator.piecewise_poisson_arrivals`` for the default
        horizon: per segment, exponential gaps are accumulated until one
        crosses the segment boundary (that crossing draw is discarded, as a
        fresh exponential restarts each segment — memorylessness makes this
        exact).
        """
        horizon = horizon if horizon is not None else self.total_duration()
        out: list[float] = []
        t0 = 0.0
        while t0 < horizon:
            for dur, lam in self.segments:
                end = min(t0 + dur, horizon)
                if lam > 0.0:
                    t = t0
                    while True:
                        t += rng.exponential(1.0 / lam)
                        if t >= end:
                            break
                        out.append(t)
                t0 += dur
                if t0 >= horizon:
                    break
        return np.asarray(out)


@dataclasses.dataclass(frozen=True)
class TenantMix(Workload):
    """Multi-class tenant mix: total rate ``lam`` split across request
    classes by ``weights`` (§IV's multiple (type, size) classes).

    For the host event sim this is one merged Poisson stream plus a
    categorical ``cls_ids`` stream (``simulate(..., cls_ids=..., samplers=
    ...)``). For the device sweep, :meth:`split` expands the mix into
    per-class sub-workloads (independent Poisson splitting), each of which
    becomes its own grid point with its own class tables.
    """

    lam: float
    classes: tuple[RequestClass, ...]
    weights: tuple[float, ...]

    def __post_init__(self):
        if len(self.classes) != len(self.weights) or not self.classes:
            raise ValueError("classes and weights must be equal-length, non-empty")
        if abs(sum(self.weights) - 1.0) > 1e-6 or any(w < 0 for w in self.weights):
            raise ValueError("weights must be non-negative and sum to 1")

    def mean_rate(self) -> float:
        return self.lam

    def arrival_times(self, rng, horizon=None):
        return PoissonWorkload(self.lam).arrival_times(rng, horizon)

    def interarrivals(self, rng, count):
        return PoissonWorkload(self.lam).interarrivals(rng, count)

    def cls_ids(self, rng: np.random.Generator, count: int) -> np.ndarray:
        """Per-arrival class ids for the event sim's ``cls_ids`` argument."""
        return rng.choice(len(self.classes), size=count, p=np.asarray(self.weights))

    def multiclass_device_arrays(
        self, rng: np.random.Generator, count: int, n_max: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(interarrivals (count,), Exp(1) draws (count, n_max), class ids
        (count,)) — everything one joint shared-pool grid point feeds
        :func:`repro_torch.sched.scan.multiclass_scan_core`.

        RNG plumbing matches :meth:`Workload.device_arrays` draw for draw:
        interarrivals then exponentials from the same stream, and a
        single-class mix consumes NO extra draws for the ids (they are all
        zero) — the degenerate-equivalence guarantee that a one-class mix
        through the joint scan reproduces ``tofec_scan_core`` exactly.
        """
        inter = self.interarrivals(rng, count)
        exps = rng.exponential(1.0, size=(count, n_max)).astype(np.float32)
        if len(self.classes) == 1:
            ids = np.zeros(count, np.int32)
        else:
            ids = self.cls_ids(rng, count).astype(np.int32)
        return inter, exps, ids

    def split(self) -> list[tuple[RequestClass, "PoissonWorkload"]]:
        """Per-class (class, Poisson(w·λ)) sub-workloads (Poisson splitting)."""
        return [
            (c, PoissonWorkload(self.lam * w))
            for c, w in zip(self.classes, self.weights)
            if w > 0.0
        ]
