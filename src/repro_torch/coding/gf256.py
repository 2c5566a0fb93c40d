"""GF(2^8) arithmetic.

Field: GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1)  (0x11d, the Rijndael-adjacent
polynomial used by most Reed-Solomon deployments, e.g. ISA-L, par2).

Two representations are provided:

* **Table form** — log/antilog tables for scalar and vectorized numpy
  arithmetic. This is the oracle used by ``kernels/gf2mm/ref.py`` and the
  host-side matrix inversion in decode.
* **Bit-matrix form** — every constant c in GF(256) acts on the field (an
  8-dim GF(2) vector space) as a linear map; ``bitmatrix(c)`` returns the
  8x8 0/1 matrix of that map. Expanding an RS generator matrix entrywise
  into bit matrices turns GF(256) encode into a GF(2) matmul, which is the
  formulation the CUDA kernel ``kernels/gf2mm/csrc/gf2_rs_bytes.cu`` runs.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
ORDER = 256
GENERATOR = 2  # primitive element for 0x11d


@functools.cache
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(exp, log) tables. exp has length 512 so exp[a+b] avoids a mod."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    log[0] = 0  # by convention; mul() special-cases zero
    return exp, log


def exp_table() -> np.ndarray:
    return _tables()[0]


def log_table() -> np.ndarray:
    return _tables()[1]


def add(a, b):
    """Addition in GF(2^8) is XOR (works elementwise on arrays)."""
    return np.bitwise_xor(a, b)


def mul(a, b):
    """Elementwise GF(256) multiply of uint8 arrays (broadcasting)."""
    exp, log = _tables()
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = exp[log[a.astype(np.int32)] + log[b.astype(np.int32)]]
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def inv(a):
    """Elementwise multiplicative inverse. inv(0) is an error."""
    exp, log = _tables()
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("inverse of 0 in GF(256)")
    return exp[255 - log[a.astype(np.int32)]]


def div(a, b):
    return mul(a, inv(b))


def pow_(a: int, e: int) -> int:
    exp, log = _tables()
    if a == 0:
        return 0
    return int(exp[(int(log[a]) * e) % 255])


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(256) matrix multiply, (m,k) @ (k,n) -> (m,n), uint8.

    Straightforward O(mkn) via table lookups; fine for the small generator /
    decode matrices handled on host. Bulk data encode goes through the
    bit-matrix kernel instead.
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0]
    exp, log = _tables()
    # products[i, t, j] = a[i, t] * b[t, j], then XOR-reduce over t.
    prod = mul(a[:, :, None], b[None, :, :])
    return np.bitwise_xor.reduce(prod, axis=1)


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(256) matrix by Gauss-Jordan. Raises if singular."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        # Find pivot.
        piv = None
        for row in range(col, n):
            if aug[row, col] != 0:
                piv = row
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        # Normalize pivot row.
        aug[col] = mul(aug[col], inv(aug[col, col]))
        # Eliminate all other rows.
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] = add(aug[row], mul(aug[row, col], aug[col]))
    return aug[:, n:].astype(np.uint8)


# ---------------------------------------------------------------------------
# Bit-matrix (GF(2)) representation
# ---------------------------------------------------------------------------


@functools.cache
def _bitmatrix_cache() -> np.ndarray:
    """(256, 8, 8) uint8 array: bitmatrix(c)[i, j] = bit i of c * x^j.

    Column j of M(c) is the bit-vector of ``c * 2^j`` in GF(256), so that for
    a byte v with bits v_j (LSB-first), ``M(c) @ bits(v) mod 2 == bits(c*v)``.
    """
    out = np.zeros((256, 8, 8), dtype=np.uint8)
    for c in range(256):
        for j in range(8):
            col = int(mul(np.uint8(c), np.uint8(1 << j)))
            for i in range(8):
                out[c, i, j] = (col >> i) & 1
    return out


def bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix of multiplication by c (LSB-first bit order)."""
    return _bitmatrix_cache()[c].copy()


def expand_bitmatrix(m: np.ndarray) -> np.ndarray:
    """Expand an (r, c) GF(256) matrix to an (8r, 8c) GF(2) 0/1 matrix."""
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    cache = _bitmatrix_cache()
    # (r, c, 8, 8) -> (r, 8, c, 8) -> (8r, 8c)
    blocks = cache[m]  # fancy index: (r, c, 8, 8)
    return blocks.transpose(0, 2, 1, 3).reshape(8 * r, 8 * c)


def expand_bitmatrix_batched(mats: np.ndarray) -> np.ndarray:
    """Expand (batch, r, c) GF(256) matrices to (batch, 8r, 8c) in one
    vectorized fancy-index — no per-item Python loop on the hot path."""
    mats = np.asarray(mats, dtype=np.uint8)
    b, r, c = mats.shape
    blocks = _bitmatrix_cache()[mats]  # (b, r, c, 8, 8)
    return blocks.transpose(0, 1, 3, 2, 4).reshape(b, 8 * r, 8 * c)


def bytes_to_bitplanes(data: np.ndarray) -> np.ndarray:
    """(k, B) uint8 -> (8k, B) 0/1 uint8, LSB-first within each row block.

    Row 8*i + b of the output is bit b of data row i. This matches the
    LSB-first convention of :func:`bitmatrix`.
    """
    data = np.asarray(data, dtype=np.uint8)
    k, B = data.shape
    shifts = np.arange(8, dtype=np.uint8)
    planes = (data[:, None, :] >> shifts[None, :, None]) & 1
    return planes.reshape(8 * k, B)


def bitplanes_to_bytes(planes: np.ndarray) -> np.ndarray:
    """(8n, B) 0/1 -> (n, B) uint8, inverse of :func:`bytes_to_bitplanes`."""
    planes = np.asarray(planes, dtype=np.uint8)
    n8, B = planes.shape
    assert n8 % 8 == 0
    n = n8 // 8
    shifts = np.arange(8, dtype=np.uint8)
    grouped = planes.reshape(n, 8, B)
    return np.bitwise_or.reduce(grouped << shifts[None, :, None], axis=1).astype(np.uint8)
