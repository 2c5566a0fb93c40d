"""Plain PyTorch versions of the GF(2)/GF(256) encode path.

They run on any device. The CPU tests hold them against the reference
package's oracles, and ``chip_smoke.py`` holds the CUDA kernels against them
on the card. ``gf2_rs_matmul_bytes_ref`` is the plain version of K1
(:func:`repro_torch.kernels.gf2mm.gf2mm.gf2_rs_matmul_bytes`).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.coding import gf256


def _t(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    exp = torch.as_tensor(gf256.exp_table(), dtype=torch.int64, device=device)
    log = torch.as_tensor(gf256.log_table(), dtype=torch.int64, device=device)
    return exp, log


def gf2_matmul_ref(a, b) -> torch.Tensor:
    """(A @ B) mod 2 in int32; exact for 0/1 inputs (float64 sums)."""
    a = _t(a).to(torch.float64)
    b = _t(b, a.device).to(torch.float64)
    return (a @ b).remainder(2).to(torch.int32)


def gf256_mul_ref(a, b) -> torch.Tensor:
    """Elementwise GF(256) multiply via log/exp gathers."""
    a = _t(a).to(torch.int64)
    b = _t(b, a.device).to(torch.int64)
    exp, log = _tables(a.device)
    out = exp[log[a] + log[b]]
    return torch.where((a == 0) | (b == 0), 0, out).to(torch.uint8)


def gf256_matmul_ref(g, d) -> torch.Tensor:
    """GF(256) matmul (n, k) @ (k, B) -> (n, B) via gathers + XOR fold."""
    g = _t(g).to(torch.int64)
    d = _t(d, g.device).to(torch.int64)
    prod = gf256_mul_ref(g[:, :, None], d[None, :, :]).to(torch.int64)
    out = torch.zeros((g.shape[0], d.shape[1]), dtype=torch.int64, device=g.device)
    for t in range(g.shape[1]):  # k is small (<= 256)
        out ^= prod[:, t, :]
    return out.to(torch.uint8)


def bytes_to_bitplanes_ref(data) -> torch.Tensor:
    """(k, B) uint8 -> (8k, B) 0/1 uint8, LSB-first."""
    data = _t(data).to(torch.uint8)
    k, B = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    return ((data[:, None, :] >> shifts[None, :, None]) & 1).reshape(8 * k, B)


def bitplanes_to_bytes_ref(planes) -> torch.Tensor:
    """(8n, B) 0/1 -> (n, B) uint8."""
    planes = _t(planes).to(torch.uint8)
    n8, B = planes.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=planes.device)
    grouped = planes.reshape(n8 // 8, 8, B) << shifts[None, :, None]
    out = torch.zeros((n8 // 8, B), dtype=torch.uint8, device=planes.device)
    for b in range(8):
        out |= grouped[:, b, :]
    return out


def rs_parity_ref(parity_gf256, data) -> torch.Tensor:
    """Oracle for the full encode path: parity rows = P ·_{GF256} data."""
    return gf256_matmul_ref(parity_gf256, data)


def gf2_rs_matmul_bytes_ref(bitmats: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: (batch, 8m, 8k) 0/1 × (batch, k, B) uint8 →
    (batch, m, B) uint8.

    Unpacks LSB-first bitplanes, takes a float32 ``bmm`` — exact, since every
    sum is at most 255 · 2048 < 2**24 (a 0/1 matrix gives at most 2048) —
    reduces mod 2 with ``.to(int32) & 1`` and repacks 8 bit-rows per byte.
    """
    batch, M8, K8 = bitmats.shape
    _, k, B = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    planes = ((data[:, :, None, :] >> shifts[None, None, :, None]) & 1).reshape(batch, K8, B)
    acc = torch.bmm(bitmats.to(torch.float32), planes.to(torch.float32))
    bits = (acc.to(torch.int32) & 1).reshape(batch, M8 // 8, 8, B)
    return (bits << shifts.to(torch.int32)[None, None, :, None]).sum(2).to(torch.uint8)
