"""Unified batched MDS codec engine — one API over numpy / torch / CUDA.

The port of the reference package's ``repro.coding.codec``, with the same
batched API

    encode(data: (batch, k, B)) -> (batch, n, B)      # systematic
    decode(rows: (batch, k, B), present)  -> (batch, k, B)

and the same shape buckets: calls are keyed on
(kind, k, bucket(n - k), bucket(B), bucket(batch)) and zero-padded to them,
and the GF(256) coding matrices are runtime inputs built host-side from the
cached Cauchy generator, so a heterogeneous (n, k) stream from
``TOFECPolicy`` lands in a small set of shapes. ``stats.traces`` counts the
first use of each bucket, which keeps that bound visible. ``decode`` takes a
per-item ``present`` matrix, so one batched call reconstructs many objects
that each survived a different erasure pattern.

Backends:

* ``numpy``  — the table oracle (vectorized log/exp gathers on host), copied
  from the reference; the one every other backend is tested against.
* ``torch``  — log/exp-table gathers + XOR fold in PyTorch, on any device.
* ``kernel`` — the GF(2) bit-matrix kernel K1
  (:func:`repro_torch.kernels.gf2mm.gf2mm.gf2_rs_matmul_bytes`): a CUDA
  kernel on the card, its plain PyTorch version on the CPU.

Selection: ``Codec("torch", device="cpu")`` explicitly, or :func:`get_codec`,
which reads ``REPRO_TORCH_CODEC_BACKEND`` (default ``kernel``). The device
backends run on ``cuda`` unless given ``device=``; without a card that
raises.

Inputs may be host numpy arrays or tensors. numpy comes back as numpy; a
tensor comes back as a tensor on its own device, so the codec composes with
device-resident callers without host round-trips.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.coding import gf256, rs

__all__ = [
    "Codec",
    "CodecStats",
    "get_codec",
    "default_backend",
    "register_backend",
    "available_backends",
    "pow2_bucket",
]


def pow2_bucket(x: int, floor: int = 1) -> int:
    """Smallest power of two ≥ max(x, floor)."""
    b = max(floor, 1)
    while b < x:
        b <<= 1
    return b


CodecStats = obs.CompileStats


class _Backend:
    """One coding backend: batched GF(256) matmul.

    The single primitive every backend implements is

        matmul(mats: (batch, m, k) GF(256), data: (batch, k, B) bytes)
            -> (batch, m, B) bytes

    — parity rows for encode, inverted-generator rows for decode. ``mats``
    is always a runtime input, so a code change is never a new shape.
    """

    name = "base"
    #: device-resident, shape-bucketed backend (the reference's ``jitted``)
    on_device = False
    #: rows and columns per GF(256) entry in what :meth:`prep_mats` returns
    mat_bits = 1

    def __init__(self, stats: CodecStats, device: torch.device | None = None):
        self.stats = stats
        self.device = device
        self._seen: set[tuple] = set()
        self._lock = threading.Lock()  # guards _seen only

    def matmul(self, mats, data):
        """Host ``mats`` × ``data`` (a tensor on the backend's device)."""
        return self.matmul_prepped(self.prep_mats(mats), data)

    def prep_mats(self, mats):
        """Prep (already padded) host coding matrices into the form
        :meth:`matmul_prepped` consumes: identity here, an upload for the
        torch backend, GF(2) bit-expansion + upload for the kernel backend.
        Runs once per admission round on tiny arrays."""
        return mats

    def matmul_prepped(self, mats, data):
        """matmul on ``mats`` already through :meth:`prep_mats`, with
        ``data`` a tensor on the backend's device. Host-only backends
        raise."""
        raise TypeError(
            f"codec backend {self.name!r} is host-only; use the torch or "
            "kernel backend for device-resident steps"
        )

    def note_bucket(self, key: tuple) -> None:
        """Count the first use of a shape bucket in ``stats.traces`` (a
        ``codec.build`` span marks it)."""
        with self._lock:
            if key not in self._seen:
                with obs.span("codec.build", backend=self.name, bucket=str(key)):
                    self._seen.add(key)
                    self.stats.traces += 1


class NumpyBackend(_Backend):
    """Vectorized table oracle; host only, runs anywhere."""

    name = "numpy"

    def matmul(self, mats, data):
        mats = np.asarray(mats, np.uint8)
        data = np.asarray(data, np.uint8)
        batch, m, k = mats.shape
        B = data.shape[2]
        out = np.zeros((batch, m, B), np.uint8)
        for t in range(k):  # k ≤ 256; avoids a (b, m, k, B) temp
            prod = gf256.mul(mats[:, :, t : t + 1], data[:, t : t + 1, :])
            np.bitwise_xor(out, prod, out=out)
        return out


class TorchBackend(_Backend):
    """Log/exp-table gathers + XOR fold in PyTorch, on the backend's device."""

    name = "torch"
    on_device = True

    def __init__(self, stats: CodecStats, device: torch.device | None = None):
        super().__init__(stats, device)
        self._exp = torch.as_tensor(gf256.exp_table(), dtype=torch.int32, device=device)
        self._log = torch.as_tensor(gf256.log_table(), dtype=torch.int32, device=device)

    def prep_mats(self, mats):
        return torch.as_tensor(np.asarray(mats, np.uint8), device=self.device)

    def matmul_prepped(self, mats, data):
        self.note_bucket((mats.shape[2], mats.shape[0], mats.shape[1], data.shape[2]))
        a = mats.to(torch.int64)  # (batch, m, k)
        d = data.to(torch.int64)  # (batch, k, B)
        la, ld = self._log[a], self._log[d]
        out = torch.zeros((a.shape[0], a.shape[1], d.shape[2]), dtype=torch.int32,
                          device=data.device)
        for t in range(a.shape[2]):  # fold over the contraction dim
            prod = self._exp[la[:, :, t, None] + ld[:, None, t, :]]
            prod = torch.where((a[:, :, t, None] == 0) | (d[:, None, t, :] == 0), 0, prod)
            out ^= prod
        return out.to(torch.uint8)


class KernelBackend(_Backend):
    """GF(2) bit-matrix kernel K1; fused bytes→bitplanes→bytes path."""

    name = "kernel"
    on_device = True
    mat_bits = 8

    def prep_mats(self, mats):
        """GF(2) bit-expansion (batch, m, k) → (batch, 8m, 8k) on host, then
        one upload to the backend's device."""
        bits = gf256.expand_bitmatrix_batched(np.asarray(mats, np.uint8))
        return torch.from_numpy(np.ascontiguousarray(bits)).to(self.device)

    def matmul_prepped(self, bitmats, data):
        from repro_torch.kernels.gf2mm.gf2mm import gf2_rs_matmul_bytes

        self.note_bucket((bitmats.shape[2] // 8, bitmats.shape[0], bitmats.shape[1] // 8,
                          data.shape[2]))
        return gf2_rs_matmul_bytes(bitmats, data.contiguous())


class Codec:
    """Batched systematic Cauchy-RS codec over a pluggable backend.

    Shape bucketing (powers of two on batch, parity count and strip width,
    zero-padded, sliced on exit) keeps the set of kernel shapes small under
    heterogeneous (n, k) streams.
    """

    #: floor for the strip-width bucket (the reference's lane-aligned floor).
    B_FLOOR = 128

    def __init__(self, backend: str | None = None, *, device=None):
        name = backend or default_backend()
        if name not in _REGISTRY:
            raise ValueError(f"unknown codec backend {name!r}; have {sorted(_REGISTRY)}")
        cls = _REGISTRY[name]
        self.device = resolve_device(device) if cls.on_device else None
        self.stats = CodecStats(label=f"codec.{name}")
        self.backend: _Backend = cls(self.stats, self.device)
        self.name = name

    # -- bucketing ----------------------------------------------------------

    def bucket_key(self, kind: str, n: int, k: int, B: int, batch: int) -> tuple:
        """The shape bucket a call with these params lands in."""
        if not self.backend.on_device:
            return (self.name,)
        m = k if kind == "dec" else n - k
        return (kind, k, pow2_bucket(m), pow2_bucket(B, self.B_FLOOR), pow2_bucket(batch))

    def matmul_shapes(self, kind: str, n: int, k: int, B: int, batch: int) -> tuple:
        """The coding matrices' and the data's shapes that a call with these
        params hands the backend's matmul, after bucket padding and
        ``prep_mats``: K1's operands on the kernel backend."""
        m = k if kind == "dec" else n - k
        if not self.backend.on_device:
            return (batch, m, k), (batch, k, B)
        _, _, m_b, B_b, batch_b = self.bucket_key(kind, n, k, B, batch)
        bits = self.backend.mat_bits
        return (batch_b, bits * m_b, bits * k), (batch_b, k, B_b)

    @staticmethod
    def _pad(arr, batch_b: int, B_b: int):
        batch, rows, B = arr.shape
        if batch == batch_b and B == B_b:
            return arr
        if isinstance(arr, np.ndarray):
            out = np.zeros((batch_b, rows, B_b), np.uint8)
        else:
            out = torch.zeros((batch_b, rows, B_b), dtype=torch.uint8, device=arr.device)
        out[:batch, :, :B] = arr
        return out

    def _as_bytes(self, arr):
        """(uint8 array, is_tensor) for the input.

        Tensors stay tensors: on a device backend they must already lie on
        the codec's device, and the result comes back there. The numpy
        backend reads a tensor through the host and answers in numpy."""
        if isinstance(arr, torch.Tensor):
            if not self.backend.on_device:
                return arr.detach().cpu().numpy().astype(np.uint8, copy=False), False
            if arr.device != self.device:
                raise ValueError(f"tensor on {arr.device}, codec on {self.device}")
            return arr.to(torch.uint8), True
        return np.asarray(arr, np.uint8), False

    def _to_device(self, arr):
        if isinstance(arr, torch.Tensor):
            return arr
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- batched API --------------------------------------------------------

    def encode(self, data, n: int, k: int, *, n_out: int | None = None):
        """Systematic encode: (batch, k, B) → (batch, n, B). Also accepts a
        single codeword (k, B) and returns (n, B).

        ``n_out`` (k ≤ n_out ≤ n) produces only the FIRST n_out codeword rows
        — the write path's partial encode for an adapted (smaller) code.
        Cauchy parity rows depend on n − k, so this slices the full (n, k)
        parity matrix rather than building an (n_out, k) code: the emitted
        strips are bit-identical to a prefix of the full codeword and stay
        compatible with every chunking level of the same layout.
        """
        data, is_tensor = self._as_bytes(data)
        single = data.ndim == 2
        if single:
            data = data[None]
        if data.ndim != 3 or data.shape[1] != k:
            raise ValueError(f"data must be (batch, k={k}, B), got {tuple(data.shape)}")
        if not 0 < k <= n:
            raise ValueError(f"need 0 < k <= n, got ({n=}, {k=})")
        if n_out is None:
            n_out = n
        elif not k <= n_out <= n:
            raise ValueError(f"need k <= n_out <= n, got ({n=}, {k=}, {n_out=})")
        batch, _, B = data.shape
        self.stats.calls += 1
        self.stats.items += batch
        if n_out == k:
            out = data
        else:
            # Prefix of the cached full parity matrix (see n_out docstring).
            par = rs.cauchy_parity_matrix(n, k)[: n_out - k]
            parity = self._matmul_bucketed("enc", par[None].repeat(batch, 0), data, n, k,
                                           is_tensor=is_tensor)
            if is_tensor:
                out = torch.cat([data, parity], dim=1)
            else:
                out = np.concatenate([data, parity], axis=1)
        return out[0] if single else out

    def decode(self, rows, present, n: int, k: int):
        """Reconstruct data from any k surviving strips per item.

        rows: (batch, k, B) (or (k, B)); ``present`` is the strip ids of
        those rows — either one shared (k,) tuple or a per-item (batch, k)
        array, enabling one batched call across heterogeneous erasure
        patterns. Row order must match ``present``, which selects the
        host-side decode matrices.
        """
        rows, is_tensor = self._as_bytes(rows)
        single = rows.ndim == 2
        if single:
            rows = rows[None]
        if rows.ndim != 3 or rows.shape[1] != k:
            raise ValueError(f"rows must be (batch, k={k}, B), got {tuple(rows.shape)}")
        batch, _, B = rows.shape
        present = _host_present(present, batch, k)
        self.stats.calls += 1
        self.stats.items += batch
        out = self._matmul_bucketed("dec", self.decode_mats(present, n, k), rows, n, k,
                                    is_tensor=is_tensor)
        return out[0] if single else out

    def decode_mats(self, present, n: int, k: int) -> np.ndarray:
        """(batch, k, k) host decode matrices for per-item ``present``
        patterns — tiny inversions, cached per (n, k, pattern). This is the
        runtime-matrix input of the fused serving step, built host-side each
        round."""
        present = np.asarray(present, np.int64)
        if present.ndim == 1:
            present = present[None]
        return np.stack(
            [rs.decode_matrix(n, k, tuple(int(i) for i in p)) for p in present]
        )

    def pad_to_bucket(self, kind: str, mats: np.ndarray, data, n: int, k: int):
        """Zero-pad (mats, data) to the shape bucket this call lands in.

        Returns (mats_p, data_p, key) with key = :meth:`bucket_key`'s tuple.
        The one source of truth for bucket padding, shared by the unfused
        matmul path and the fused serving step (which feeds mats_p through
        ``backend.prep_mats``); callers slice ``[:batch, :m, :B]`` off the
        result themselves. ``data`` may be numpy or a tensor; it is padded
        where it lies."""
        batch, m, _ = mats.shape
        key = self.bucket_key(kind, n, k, data.shape[2], batch)
        if not self.backend.on_device:
            return mats, data, key
        _, _, m_b, B_b, batch_b = key
        mats_p = np.zeros((batch_b, m_b, k), np.uint8)
        mats_p[:batch, :m] = mats
        return mats_p, self._pad(data, batch_b, B_b), key

    def _matmul_bucketed(self, kind, mats, data, n, k, *, is_tensor=False):
        batch, m, _ = mats.shape
        B = data.shape[2]
        if not self.backend.on_device:
            return self.backend.matmul(mats, data)
        # Upload before padding: the padded columns are made on the device.
        mats_p, data_p, _ = self.pad_to_bucket(kind, mats, self._to_device(data), n, k)
        out = self.backend.matmul(mats_p, data_p)[:batch, :m, :B]
        return out if is_tensor else out.cpu().numpy()

    # -- blob helpers (1-D payload convenience) -----------------------------

    @staticmethod
    def strip_bytes(payload_len: int, k: int) -> int:
        return -(-max(payload_len, 1) // k)

    def encode_blob(self, payload, *, n: int, k: int) -> np.ndarray:
        """1-D uint8 payload → (n, ceil(len/k)) coded strips."""
        return self.encode_blobs([payload], n=n, k=k)[0]

    def encode_blobs(self, payloads, *, n: int, k: int) -> list[np.ndarray]:
        """Batch-encode same-class payloads in ONE kernel launch.

        Payloads are packed to a common strip width (the max over the batch);
        each result is sliced back to its own ceil(len/k) strip width, which
        is lossless because coded columns depend only on same-index data
        columns (zero columns encode to zero).
        """
        bufs = [np.asarray(p, np.uint8).reshape(-1) for p in payloads]
        strips = [self.strip_bytes(b.size, k) for b in bufs]
        B = max(strips)
        data = np.zeros((len(bufs), k, B), np.uint8)
        for i, (b, s) in enumerate(zip(bufs, strips)):
            # Each blob keeps ITS OWN (k, strip_i) row layout, left-aligned
            # into the batch-max width.
            row = np.zeros(k * s, np.uint8)
            row[: b.size] = b
            data[i, :, :s] = row.reshape(k, s)
        coded = self.encode(data, n, k)
        return [coded[i][:, : strips[i]] for i in range(len(bufs))]

    def decode_blob(self, strips, present, *, n: int, k: int, payload_len: int) -> np.ndarray:
        """Any k strips (k, strip) + their ids → payload bytes."""
        out = self.decode(np.asarray(strips, np.uint8), present, n, k)
        return out.reshape(-1)[:payload_len]


def _host_present(present, batch: int, k: int) -> np.ndarray:
    """``present`` as a host (batch, k) int64 array (a shared (k,) pattern is
    broadcast)."""
    if isinstance(present, torch.Tensor):
        present = present.cpu().numpy()
    present = np.asarray(present, np.int64)
    if present.ndim == 1:
        present = np.broadcast_to(present, (batch, k))
    if present.shape != (batch, k):
        raise ValueError(f"present must be (k,) or (batch, k), got {present.shape}")
    return present


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}
_INSTANCES: dict[tuple, Codec] = {}
_INSTANCES_LOCK = threading.Lock()


def register_backend(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def default_backend() -> str:
    return os.environ.get("REPRO_TORCH_CODEC_BACKEND", "kernel")


def get_codec(backend: str | None = None, *, device=None) -> Codec:
    """Process-wide codec instance per (backend, resolved device) pair.

    ``device`` applies to the device backends and defaults to ``cuda``
    (raising without a card); the numpy backend ignores it.
    """
    name = backend or default_backend()
    if name not in _REGISTRY:
        raise ValueError(f"unknown codec backend {name!r}; have {sorted(_REGISTRY)}")
    dev = resolve_device(device) if _REGISTRY[name].on_device else None
    key = (name, str(dev))
    with _INSTANCES_LOCK:
        if key not in _INSTANCES:
            _INSTANCES[key] = Codec(name, device=dev)
        return _INSTANCES[key]


register_backend("numpy", NumpyBackend)
register_backend("torch", TorchBackend)
register_backend("kernel", KernelBackend)
