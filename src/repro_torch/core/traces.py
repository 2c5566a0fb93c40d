"""Synthetic S3-like delay traces (stand-in for the paper's measured traces).

No network access in this container, so the trace-driven evaluation draws
from the paper's own fitted model family (§III-C): shifted exponential with
Δ(B), 1/μ(B) linear in chunk size. Two placement modes:

  * ``unique_key``  — i.i.d. task delays (measured cross-corr < 0.05),
  * ``shared_key``  — correlated tails via a Gaussian copula targeting the
                      measured cross-correlation coefficient (0.11–0.17).

A :class:`TraceStore` pre-generates per-chunk-size delay pools — the moral
equivalent of the paper's 24h measurement runs — from which the simulator
resamples, and from which :func:`repro_torch.core.delay_model.fit_delay_params`
re-estimates {Δ̄, Δ̃, Ψ̄, Ψ̃} exactly the way §V-A does.

A copy of the reference package's ``repro/core/traces.py`` (numpy draws,
draw for draw the same), except that :meth:`TraceStore.device_pools` puts
the stacked pools in tensors on a device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

try:  # dev-only dependency (requirements-dev.txt); the erf fallback below
    from scipy import stats as _scipy_stats  # keeps minimal containers working
except ImportError:  # pragma: no cover - exercised on minimal containers
    _scipy_stats = None

from repro_torch import resolve_device
from repro_torch.core.delay_model import DelayParams

_SQRT2 = math.sqrt(2.0)
_vec_erf = np.vectorize(math.erf, otypes=[np.float64])


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    """Standard-normal CDF; scipy when available, math.erf otherwise.

    Φ(z) = (1 + erf(z/√2))/2 — exact, just slower elementwise on the
    fallback path, which only runs where scipy isn't installed.
    """
    if _scipy_stats is not None:
        return _scipy_stats.norm.cdf(z)
    return 0.5 * (1.0 + _vec_erf(np.asarray(z) / _SQRT2))


def _corr_exponentials(
    rng: np.random.Generator, mean: float, n: int, rho: float, size: int
) -> np.ndarray:
    """(size, n) exponentials, pairwise Gaussian-copula correlation ~rho."""
    if rho <= 0.0 or n == 1:
        return rng.exponential(mean, size=(size, n))
    cov = np.full((n, n), rho)
    np.fill_diagonal(cov, 1.0)
    z = rng.multivariate_normal(np.zeros(n), cov, size=size, method="cholesky")
    u = _norm_cdf(z)
    u = np.clip(u, 1e-12, 1.0 - 1e-12)
    return -mean * np.log1p(-u)


@dataclasses.dataclass
class TraceSampler:
    """Draws per-task delays for a request served with an (n, k) code."""

    params: DelayParams
    file_mb: float
    correlation: float = 0.0  # 0 → Unique Key; ~0.14 → Shared Key

    def sample(self, rng: np.random.Generator, k: int, n: int) -> np.ndarray:
        B = self.file_mb / k
        tails = _corr_exponentials(rng, self.params.tail_mean(B), n, self.correlation, 1)[0]
        return self.params.delta(B) + tails

    def sample_batch(self, rng: np.random.Generator, k: int, n: int, size: int) -> np.ndarray:
        B = self.file_mb / k
        tails = _corr_exponentials(rng, self.params.tail_mean(B), n, self.correlation, size)
        return self.params.delta(B) + tails


@dataclasses.dataclass
class TraceStore:
    """Pre-generated delay pools per chunk size (the 'collected traces')."""

    chunk_sizes_mb: np.ndarray
    pools: list[np.ndarray]  # pools[i]: (samples, threads) delays for size i

    @classmethod
    def generate(
        cls,
        params: DelayParams,
        chunk_sizes_mb,
        *,
        threads: int = 12,
        samples: int = 20_000,
        correlation: float = 0.0,
        seed: int = 0,
    ) -> "TraceStore":
        rng = np.random.default_rng(seed)
        sizes = np.asarray(chunk_sizes_mb, dtype=np.float64)
        pools = []
        for B in sizes:
            tails = _corr_exponentials(rng, params.tail_mean(B), threads, correlation, samples)
            pools.append(params.delta(B) + tails)
        return cls(chunk_sizes_mb=sizes, pools=pools)

    def pool_for(self, B: float) -> np.ndarray:
        i = int(np.argmin(np.abs(self.chunk_sizes_mb - B)))
        return self.pools[i]

    def thread_delays(self, B: float) -> list[np.ndarray]:
        """Per-thread delay series at chunk size B (for CCDF / corr plots)."""
        pool = self.pool_for(B)
        return [pool[:, t] for t in range(pool.shape[1])]

    def flat_delays(self, B: float) -> np.ndarray:
        return self.pool_for(B).reshape(-1)

    def cross_correlation(self, B: float) -> float:
        """Mean pairwise cross-correlation coefficient between threads."""
        pool = self.pool_for(B)
        c = np.corrcoef(pool.T)
        n = c.shape[0]
        off = c[~np.eye(n, dtype=bool)]
        return float(off.mean())

    def device_pools(self, n_max: int, size: int | None = None, *,
                     device=None) -> "DevicePools":
        """Export the per-chunk-size pools as one stacked block on ``device``
        (default ``cuda``).

        Returns a :class:`DevicePools` holding ``sizes_mb`` (S,) float32 and
        ``pools`` (S, size, n_max) float32 tensors — the shared pre-sampled
        delay supply consumed by BOTH the on-device task engine
        (:mod:`repro_torch.taskq`) and the host event oracle (via
        :meth:`DevicePools.host_sampler`). Rows are whole jointly-sampled
        thread batches, so the shared-key copula correlation of the trace
        survives the export; reading row ``i`` of pool ``s`` yields identical
        values on both sides, which is what makes the engine-vs-oracle
        parity pin of ``tests/test_torch_taskq.py`` possible.
        """
        dev = resolve_device(device)
        widths = [p.shape[1] for p in self.pools]
        if min(widths) < n_max:
            raise ValueError(
                f"store pools have {min(widths)} threads; need >= n_max={n_max}"
            )
        rows = min(p.shape[0] for p in self.pools)
        size = rows if size is None else size
        if size > rows:
            raise ValueError(f"requested {size} rows; pools hold only {rows}")
        stacked = np.stack([p[:size, :n_max] for p in self.pools])
        return DevicePools(
            sizes_mb=torch.from_numpy(self.chunk_sizes_mb.astype(np.float32)).to(dev),
            pools=torch.from_numpy(stacked.astype(np.float32)).to(dev),
        )


@dataclasses.dataclass
class DevicePools:
    """Stacked per-chunk-size delay pools shared by device and host samplers.

    ``pools[s, i, j]`` is the delay of thread j in jointly-sampled batch i at
    chunk size ``sizes_mb[s]``. The pool index for a request served at code
    dimension k is ``argmin |sizes_mb − J/k|`` computed in float32 — the
    device engine and :class:`PoolSampler` use the byte-identical rule so
    they always land in the same pool. The host samplers read a host copy,
    made once.
    """

    sizes_mb: torch.Tensor  # (S,) float32
    pools: torch.Tensor     # (S, P, W) float32
    _host: tuple = dataclasses.field(default=None, init=False, repr=False, compare=False)

    @property
    def n_rows(self) -> int:
        return self.pools.shape[1]

    def host(self) -> tuple[np.ndarray, np.ndarray]:
        """(sizes_mb, pools) as numpy arrays, copied from the device once."""
        if self._host is None:
            self._host = (self.sizes_mb.cpu().numpy(), self.pools.cpu().numpy())
        return self._host

    def pool_index(self, file_mb: float, k: int) -> int:
        B = np.float32(file_mb) / np.float32(k)
        return int(np.argmin(np.abs(self.host()[0] - B)))

    def host_sampler(self, file_mb: float, indices: np.ndarray) -> "PoolSampler":
        """Oracle-side sampler reading the same rows the device engine reads
        (``indices[i]`` is request i's pre-sampled row draw)."""
        return PoolSampler(self, file_mb, np.asarray(indices, dtype=np.int64))


@dataclasses.dataclass
class PoolSampler:
    """Trace sampler replaying :class:`DevicePools` rows by request index.

    Exposes the :func:`repro_torch.core.simulator.simulate` sampler interface plus
    the ``sample_indexed`` oracle hook: when present, the event simulator
    passes each request's arrival index so host draws line up with the
    device engine's ``pools[s, indices[i]]`` gather draw for draw, even when
    admission order and arrival order are allowed to diverge (multi-class
    disciplines). ``sample`` falls back to call-order indexing, which equals
    arrival order for the single-class FIFO oracle.
    """

    device: DevicePools
    file_mb: float
    indices: np.ndarray
    _ptr: int = 0

    def sample_indexed(self, index: int, k: int, n: int) -> np.ndarray:
        if n > self.device.pools.shape[2]:
            raise ValueError(f"n={n} exceeds pool width {self.device.pools.shape[2]}")
        s = self.device.pool_index(self.file_mb, k)
        return self.device.host()[1][s, self.indices[index], :n].astype(np.float64)

    def sample(self, rng: np.random.Generator, k: int, n: int) -> np.ndarray:
        i = self._ptr
        self._ptr += 1
        return self.sample_indexed(i, k, n)


@dataclasses.dataclass
class StoreSampler:
    """Trace-driven sampler: resamples rows of a TraceStore pool.

    Sampling a row (all threads at one 'time') preserves the cross-thread
    correlation structure of the trace, like replaying measured batches.
    """

    store: TraceStore
    file_mb: float

    def sample(self, rng: np.random.Generator, k: int, n: int) -> np.ndarray:
        B = self.file_mb / k
        pool = self.store.pool_for(B)
        row = pool[rng.integers(pool.shape[0])]
        if n <= row.shape[0]:
            return row[:n].copy()
        extra = pool[rng.integers(pool.shape[0])][: n - row.shape[0]]
        return np.concatenate([row, extra])
