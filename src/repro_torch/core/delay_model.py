"""Task-delay model of the paper (§III-C, Eq.1) and parameter fitting (§V-A).

    D_t(B) ~ Δ(B) + Exp(mean = 1/μ(B)),   Δ(B) = Δ̄ + Δ̃·B,   1/μ(B) = Ψ̄ + Ψ̃·B

Units: seconds and MB throughout.

The default constants are calibrated (DESIGN.md §2) so that the paper's
headline numbers come out of the simulator for the (read, 3 MB) class with
L = 16 threads: basic (1,1) mean ≈ 205 ms, simple replication (2,1) ≈ 151 ms,
best code at light load ≈ 80-90 ms, capacity of the delay-optimal high-chunk
codes ≈ 30-40 % of basic — matching Fig.1/Fig.7 within the fidelity that a
synthetic trace permits.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DelayParams:
    """{Δ̄, Δ̃, Ψ̄, Ψ̃} for one request type (read or write)."""

    delta_bar: float  # Δ̄  [s]      fixed per-task overhead floor
    delta_tilde: float  # Δ̃  [s/MB]  floor growth per MB
    psi_bar: float  # Ψ̄  [s]      exponential-tail mean at B=0
    psi_tilde: float  # Ψ̃  [s/MB]  tail-mean growth per MB

    def delta(self, B: float) -> float:
        """Deterministic lower bound Δ(B) of task delay (observation 3)."""
        return self.delta_bar + self.delta_tilde * B

    def tail_mean(self, B: float) -> float:
        """Mean (= std) 1/μ(B) of the exponential tail (observation 4)."""
        return self.psi_bar + self.psi_tilde * B

    def task_mean(self, B: float) -> float:
        return self.delta(B) + self.tail_mean(B)

    def task_std(self, B: float) -> float:
        return self.tail_mean(B)

    def sample(self, rng: np.random.Generator, B: float, size=None) -> np.ndarray:
        """Draw task delays for chunk size B."""
        return self.delta(B) + rng.exponential(self.tail_mean(B), size=size)


# Calibrated to land the paper's Fig.1/Fig.7 numbers for (read, 3MB), L=16.
PAPER_READ_3MB = DelayParams(
    delta_bar=0.050, delta_tilde=0.018, psi_bar=0.015, psi_tilde=0.030
)
# Writes on S3 are slower per byte (paper measured both; constants scaled).
PAPER_WRITE_3MB = DelayParams(
    delta_bar=0.060, delta_tilde=0.024, psi_bar=0.020, psi_tilde=0.040
)


def fit_delay_params(
    chunk_sizes_mb: np.ndarray,
    delays_s: list[np.ndarray],
    *,
    drop_worst_frac: float = 0.10,
) -> DelayParams:
    """Fit {Δ̄, Δ̃, Ψ̄, Ψ̃} from per-chunk-size task-delay samples (§V-A).

    Paper procedure: filter out the worst ``drop_worst_frac`` of task delays
    per setting, then least-squares lines through (B, mean) and (B, std).
    Δ is recovered from mean − std (shifted exponential: mean = Δ + 1/μ,
    std = 1/μ).
    """
    chunk_sizes_mb = np.asarray(chunk_sizes_mb, dtype=np.float64)
    means, stds = [], []
    for d in delays_s:
        d = np.sort(np.asarray(d, dtype=np.float64))
        keep = d[: max(1, int(round(len(d) * (1.0 - drop_worst_frac))))]
        means.append(keep.mean())
        stds.append(keep.std())
    means = np.asarray(means)
    stds = np.asarray(stds)

    def lsq_line(x, y):
        A = np.stack([x, np.ones_like(x)], axis=1)
        slope, intercept = np.linalg.lstsq(A, y, rcond=None)[0]
        return float(slope), float(intercept)

    psi_tilde, psi_bar = lsq_line(chunk_sizes_mb, stds)
    mean_slope, mean_intercept = lsq_line(chunk_sizes_mb, means)
    # mean = Δ̄ + Ψ̄ + (Δ̃ + Ψ̃)·B  →  subtract the tail line.
    delta_tilde = mean_slope - psi_tilde
    delta_bar = mean_intercept - psi_bar
    return DelayParams(
        delta_bar=max(delta_bar, 0.0),
        delta_tilde=max(delta_tilde, 0.0),
        psi_bar=max(psi_bar, 1e-6),
        psi_tilde=max(psi_tilde, 0.0),
    )


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """(type, size) request class (§IV): file size + its delay parameters."""

    name: str
    file_mb: float
    params: DelayParams
    k_max: int = 6
    r_max: float = 2.0
    n_max: int = 12

    def chunk_mb(self, k: float) -> float:
        return self.file_mb / k
