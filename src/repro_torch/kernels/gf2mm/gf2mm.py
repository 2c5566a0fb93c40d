"""The GF(2) kernels: K1 and K2.

* K1, :func:`gf2_rs_matmul_bytes`, is the port of the reference package's
  TPU kernel ``repro/kernels/gf2mm/gf2mm.py::gf2_rs_matmul_bytes``:
  per-item GF(2)-expanded coding matrices times raw byte strips, bytes in
  and bytes out, with the bitplane unpack and repack fused into one kernel.
  Every encode and decode of the codec's ``kernel`` backend, and so of the
  proxy and the fused serving step, goes through it.
* K2, :func:`gf2_matmul`, is the port of ``gf2mm.py::gf2_matmul``: (A @ B)
  mod 2 for 0/1 matrices, the classic bit-matrix encode on bitplanes the
  caller packs and unpacks.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/gf2_rs_bytes.cu``, ``csrc/gf2_matmul.cu``; design and bound are
described there) or raises; on a CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.gf2mm.ref`.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gf2mm.ref import gf2_matmul_ref, gf2_rs_matmul_bytes_ref
from repro_torch.obs import profile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: library name -> (C entry point, its argument types); source csrc/<name>.cu
KERNELS = {
    "gf2_rs_bytes": ("gf2_rs_bytes_launch", [_PTR, _PTR, _PTR, _INT, _INT, _INT, _LL, _PTR]),
    "gf2_matmul": ("gf2_matmul_launch", [_PTR, _PTR, _PTR, _INT, _INT, _LL, _PTR]),
}
_COUNT_LOCK = threading.Lock()
#: library name -> its C entry point, once :func:`load_all` has loaded it
_ENTRY: dict[str, ctypes._CFuncPtr] = {}


def load_all(names=tuple(KERNELS)) -> dict[str, ctypes.CDLL]:
    """Build (at first use, one nvcc for each, started together) and load
    the named kernel libraries; returns name -> library."""
    libs = build.load_libraries({name: CSRC / f"{name}.cu" for name in names})
    for name, lib in libs.items():
        entry, argtypes = KERNELS[name]
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return libs


def load(name: str = "gf2_rs_bytes") -> ctypes.CDLL:
    """Build (at first use) and load one kernel library (K1 by default);
    returns it."""
    return load_all((name,))[name]


def _launch(name: str, *args) -> None:
    """Call a kernel's C entry point on the current stream; raise on a
    refused launch."""
    fn = _ENTRY.get(name)
    if fn is None:
        load(name)
        fn = _ENTRY[name]
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _launch_on(device: torch.device, name: str, *args) -> None:
    """:func:`_launch` with ``device`` current, switching devices only when
    it is not current already (the switch costs host time on every call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        _launch(name, *args)
    else:
        with torch.cuda.device(device):
            _launch(name, *args)


def k1_counts(batch: int, m8: int, k8: int, B: int) -> tuple[float, int]:
    """(operations, bytes) of one K1 call on (batch, m8, k8) bit-matrices and
    (batch, k8 / 8, B) strips: the equivalent 0/1 int8 product's
    2·batch·m8·k8·B operations, and each input byte read once and each
    output byte written once."""
    nbytes = batch * m8 * k8 + batch * (k8 // 8) * B + batch * (m8 // 8) * B
    return 2.0 * batch * m8 * k8 * B, nbytes


def k2_counts(M: int, K: int, N: int) -> tuple[float, int]:
    """(operations, bytes) of one K2 call (M, K) @ (K, N): the 0/1 int8
    product's 2·M·K·N operations, each operand byte read once and each
    output byte written once."""
    return 2.0 * M * K * N, M * K + K * N + M * N


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
    kernel launches (CPU calls do not count); each launch reports
    :func:`k1_counts` to :func:`repro_torch.obs.profile_launch`.

    The kernel (``csrc/gf2_rs_bytes.cu``) replaces the reference's TPU kernel
    ``repro/kernels/gf2mm/gf2mm.py::gf2_rs_matmul_bytes`` (:154, body
    ``_rs_bytes_kernel`` :125). It runs on the int8 tensor cores:
    ``mma.sync`` m16n8k32 (and m16n8k16) u8·u8→s32, with the item's
    bit-matrix in registers — for k ≤ 8 its rows paired, weighted 1 and
    128, so one accumulator carries two output bits — B's bits spread from
    the raw data nibbles in registers, a few integer ops per output byte
    to fold the accumulators into bytes, and one 16-byte store per lane;
    k > 8 reads A per k-step from a shared tile. Its bound on an H100 at
    the decode shape (32, 64, 48) × (32, 6, 524,288) is 0.0701 ms (bytes).
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
    _launch_on(data.device, "gf2_rs_bytes", bitmats.data_ptr(), data.data_ptr(), out.data_ptr(),
               batch, M8, k, B)
    with _COUNT_LOCK:
        gf2_rs_matmul_bytes.launches += 1
    profile.add_counts(*k1_counts(batch, M8, 8 * k, B))
    return out


gf2_rs_matmul_bytes.launches = 0


def gf2_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=torch.uint8) -> torch.Tensor:
    """(A @ B) mod 2 for 0/1 matrices. A: (M, K), B: (K, N) -> (M, N).

    Inputs may be any integer, float or bool dtype holding 0/1 values, on one
    device. On a CUDA tensor both are cast to uint8 and made contiguous (a
    transposed or sliced view is fine), and the kernel runs; each entry
    counts by its lowest bit, the exact mod-2 value for integer inputs. On a
    CPU tensor the plain version :func:`ref.gf2_matmul_ref` runs. The result
    has ``out_dtype`` (default uint8).

    The kernel (``csrc/gf2_matmul.cu``) replaces the reference's TPU kernel
    ``repro/kernels/gf2mm/gf2mm.py::gf2_matmul`` (:77, body :60-74). It runs
    on the int8 tensor cores: ``mma.sync`` m16n8k32 u8·u8→s32 on 0/1 bytes
    (every operand word masked to its lowest bits) from K-major shared
    tiles, B transposed with ``prmt`` on its way in, A by a ``cp.async``
    double buffer, 128 × 128 output blocks and k-tiles of 128, and
    ``acc & 1`` out. Its bounds on an H100: 0.0150 ms at the encode shape
    (48, 48) @ (48, 524,288) (bytes), 0.0694 ms at (1024, 1024) @
    (1024, 65,536) (operations).

    The reference's ``block_m``/``block_n``/``block_k`` (TPU VMEM tile
    sizes) and ``interpret`` (the Pallas interpreter) have no counterpart
    here: the kernel picks its own tiles and masks its own ragged edges
    (byte-wise paths where K or N is not a multiple of 16 or a pointer is
    not 16-byte aligned; nothing padded in device memory).
    ``launches`` counts kernel launches (CPU calls do not count); each
    launch reports :func:`k2_counts` to :func:`repro_torch.obs.profile_launch`.
    """
    for name, x in (("a", a), ("b", b)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.ndim != 2:
            raise ValueError(f"{name} must have rank 2, got shape {tuple(x.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")
    if a.device.type == "cpu":
        return gf2_matmul_ref(a, b).to(out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    a8 = a.to(torch.uint8).contiguous()
    b8 = b.to(torch.uint8).contiguous()
    (M, K), N = a8.shape, b8.shape[1]
    if M > 2**31 - 1 or K > 2**31 - 1:
        raise ValueError(f"M and K must fit in int32, got {M}, {K}")
    out = torch.empty((M, N), dtype=torch.uint8, device=a.device)
    if out.numel() == 0:
        return out.to(out_dtype)
    _launch_on(a.device, "gf2_matmul", a8.data_ptr(), b8.data_ptr(), out.data_ptr(), M, K, N)
    with _COUNT_LOCK:
        gf2_matmul.launches += 1
    profile.add_counts(*k2_counts(M, K, N))
    return out if out_dtype == torch.uint8 else out.to(out_dtype)


gf2_matmul.launches = 0
