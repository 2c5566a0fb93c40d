"""K1: the batched, fused GF(2) Reed-Solomon product on raw bytes.

:func:`gf2_rs_matmul_bytes` is the port of the reference package's TPU
kernel ``repro/kernels/gf2mm/gf2mm.py::gf2_rs_matmul_bytes``: per-item
GF(2)-expanded coding matrices times raw byte strips, bytes in and bytes
out, with the bitplane unpack and repack fused into one kernel. Every
encode and decode of the codec's ``kernel`` backend, and so of the proxy
and the fused serving step, goes through it.

On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/gf2_rs_bytes.cu`` (design and bound are described there) or raises;
on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.gf2mm.ref.gf2_rs_matmul_bytes_ref`.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gf2mm.ref import gf2_rs_matmul_bytes_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "gf2_rs_bytes.cu"
_COUNT_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (at first use) and load the K1 library; returns it."""
    lib = build.load_library("gf2_rs_bytes", SOURCE)
    fn = lib.gf2_rs_bytes_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(bitmats: torch.Tensor, data: torch.Tensor) -> None:
    for name, x in (("bitmats", bitmats), ("data", data)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {x.dtype}")
        if x.ndim != 3:
            raise ValueError(f"{name} must have rank 3, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    batch, M8, K8 = bitmats.shape
    if data.shape[0] != batch or K8 != 8 * data.shape[1] or M8 % 8:
        raise ValueError(f"inconsistent shapes {tuple(bitmats.shape)} / {tuple(data.shape)}: "
                         "need bitmats (batch, 8m, 8k) and data (batch, k, B)")
    if bitmats.device != data.device:
        raise ValueError(f"bitmats on {bitmats.device} but data on {data.device}")
    if batch > 65535 or data.shape[1] > 256:
        raise ValueError(f"batch ≤ 65535 and k ≤ 256 required, got batch={batch}, "
                         f"k={data.shape[1]}")


def gf2_rs_matmul_bytes(bitmats: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Batched fused RS matmul on raw bytes.

    bitmats: (batch, 8m, 8k) uint8 0/1 — per-item GF(2)-expanded coding
             matrices (parity rows for encode, inverted generator rows for
             decode), e.g. from ``gf256.expand_bitmatrix_batched``.
    data:    (batch, k, B) uint8 — raw byte strips.
    Returns  (batch, m, B) uint8, the GF(256) product rows.

    Both tensors must be contiguous and on one device. ``launches`` counts
    kernel launches (CPU calls do not count).
    """
    _check(bitmats, data)
    if data.device.type == "cpu":
        return gf2_rs_matmul_bytes_ref(bitmats, data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    batch, M8, _ = bitmats.shape
    _, k, B = data.shape
    out = torch.empty((batch, M8 // 8, B), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    lib = load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf2_rs_bytes_launch(bitmats.data_ptr(), data.data_ptr(), out.data_ptr(),
                                     batch, M8, k, B, stream)
    if rc != 0:
        raise RuntimeError(f"gf2_rs_bytes kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        gf2_rs_matmul_bytes.launches += 1
    return out


gf2_rs_matmul_bytes.launches = 0
