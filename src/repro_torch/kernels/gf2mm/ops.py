"""User-facing ops over the K1 kernel.

Thin wrappers around the batched codec engine (:mod:`repro_torch.coding.codec`)
pinned to the ``kernel`` backend: single-codeword calls go through the
shared engine, its shape buckets and K1. ``device`` defaults to the input
tensor's device, else ``cuda``.
"""

from __future__ import annotations

import numpy as np
import torch


def _codec(data, device):
    from repro_torch.coding.codec import get_codec

    if device is None and isinstance(data, torch.Tensor):
        device = data.device
    return get_codec("kernel", device=device)


def rs_encode(data, *, n: int, k: int, device=None):
    """Systematic RS encode: (k, B) uint8 -> (n, B) uint8.

    Data rows pass through; parity rows come from K1 (batch of one).
    """
    if data.shape[0] != k:
        raise ValueError(f"data rows {data.shape[0]} != k {k}")
    return _codec(data, device).encode(data, n, k)


def rs_decode(rows, *, n: int, k: int, present: tuple[int, ...], device=None):
    """Reconstruct (k, B) data from k surviving strips through K1.

    ``present`` selects the decode matrix; decode is encode with the
    inverted generator submatrix (a runtime input to the bucketed kernel).
    """
    if rows.shape[0] != k:
        raise ValueError(f"rows {rows.shape[0]} != k {k}")
    present = tuple(int(i) for i in present)
    return _codec(rows, device).decode(rows, present, n, k)


def encode_blob(payload: np.ndarray, *, n: int, k: int, device=None) -> np.ndarray:
    """Host convenience: 1-D uint8 payload -> (n, ceil(len/k)) coded strips."""
    return _codec(None, device).encode_blob(np.asarray(payload, np.uint8), n=n, k=k)


def decode_blob(strips: np.ndarray, present: tuple[int, ...], *, n: int, k: int,
                payload_len: int, device=None) -> np.ndarray:
    """Host convenience: any k strips (k, strip) + ids -> payload bytes."""
    return _codec(None, device).decode_blob(
        strips, tuple(int(i) for i in present), n=n, k=k, payload_len=payload_len
    )
