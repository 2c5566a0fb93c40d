"""Systematic Cauchy Reed-Solomon MDS codes over GF(2^8).

An (n, k) code maps k data strips (rows of bytes) to n coded strips; the
first k coded strips equal the data (systematic), the remaining n - k are
parity rows produced by a Cauchy matrix, which guarantees the MDS property:
any k of the n strips reconstruct the data.

The paper (§II-B) uses one high-dimension (N = r*K, K) "strip" code that is
simultaneously an (N/m, K/m) code for chunk size B = m*b; that batching is
implemented in :mod:`repro_torch.coding.layout` on top of this module.

Host-side encode/decode here is table-based numpy (the oracle). Bulk encode
on the GPU goes through :mod:`repro_torch.kernels.gf2mm` (bit-matrix formulation).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.coding import gf256


@functools.cache
def cauchy_parity_matrix(n: int, k: int) -> np.ndarray:
    """(n - k, k) Cauchy matrix over GF(256).

    X_i = i (rows / parities), Y_j = (n - k) + j (cols / data); all distinct,
    entries 1 / (X_i + Y_j). Requires n <= 256 (field size bound for MDS).
    """
    if not (0 < k <= n):
        raise ValueError(f"need 0 < k <= n, got ({n=}, {k=})")
    if n > 256:
        raise ValueError("Cauchy RS over GF(256) supports n <= 256")
    rows = np.arange(n - k, dtype=np.uint8)[:, None]
    cols = (np.arange(k, dtype=np.uint8) + np.uint8(n - k))[None, :]
    return gf256.inv(gf256.add(rows, cols)) if n > k else np.zeros((0, k), np.uint8)


@functools.cache
def generator_matrix(n: int, k: int) -> np.ndarray:
    """(n, k) systematic generator: [I_k ; Cauchy]."""
    eye = np.eye(k, dtype=np.uint8)
    par = cauchy_parity_matrix(n, k)
    return np.concatenate([eye, par], axis=0)


def encode(data: np.ndarray, n: int, k: int) -> np.ndarray:
    """Encode (k, B) data strips -> (n, B) coded strips (systematic)."""
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim != 2 or data.shape[0] != k:
        raise ValueError(f"data must be (k={k}, B), got {data.shape}")
    par = cauchy_parity_matrix(n, k)
    parity = gf256.matmul(par, data) if n > k else np.zeros((0, data.shape[1]), np.uint8)
    return np.concatenate([data, parity], axis=0)


@functools.cache
def decode_matrix(n: int, k: int, present: tuple[int, ...]) -> np.ndarray:
    """(k, k) matrix D s.t. D @ coded[present] == data, for any k present rows."""
    if len(present) != k:
        raise ValueError(f"need exactly k={k} present indices, got {len(present)}")
    if len(set(present)) != k or max(present) >= n or min(present) < 0:
        raise ValueError(f"invalid present set {present} for (n={n}, k={k})")
    gen = generator_matrix(n, k)
    sub = gen[list(present)]  # (k, k)
    return gf256.mat_inv(sub)


def decode(coded_rows: np.ndarray, present: tuple[int, ...], n: int, k: int) -> np.ndarray:
    """Reconstruct (k, B) data from any k coded strips.

    ``coded_rows`` is (k, B): the surviving strips, in the order given by
    ``present`` (sorted or not — order must match).
    """
    coded_rows = np.asarray(coded_rows, dtype=np.uint8)
    dec = decode_matrix(n, k, tuple(int(i) for i in present))
    return gf256.matmul(dec, coded_rows)


@dataclasses.dataclass(frozen=True)
class MDSCode:
    """Convenience bundle for an (n, k) systematic Cauchy RS code."""

    n: int
    k: int

    def __post_init__(self):
        generator_matrix(self.n, self.k)  # validates and caches

    @property
    def r(self) -> float:
        """Redundancy ratio n / k (paper's r)."""
        return self.n / self.k

    def encode(self, data: np.ndarray) -> np.ndarray:
        return encode(data, self.n, self.k)

    def decode(self, coded_rows: np.ndarray, present) -> np.ndarray:
        return decode(coded_rows, tuple(int(i) for i in present), self.n, self.k)

    def generator(self) -> np.ndarray:
        return generator_matrix(self.n, self.k)

    def parity(self) -> np.ndarray:
        return cauchy_parity_matrix(self.n, self.k)
