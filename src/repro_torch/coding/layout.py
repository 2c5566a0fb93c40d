"""Shared-Key strip layout (paper §II-B, §III, Fig.3).

One (N = r*K, K) MDS codeword over b-byte *strips* is stored as a single
coded object of N*b bytes. For every divisor m of K it simultaneously acts
as an (n = N/m, k = K/m) MDS code over B = m*b-byte *chunks*: chunk i is the
contiguous strip range [i*m, (i+1)*m), fetched with one ranged read. Any k
chunks cover k*m = K strips, which reconstruct the file.

This is what makes variable chunk sizing storage-efficient: one stored
object (cost r × file size) supports every chunking level, vs. Unique-Key's
extra r × file size *per chunk size* (§III-A.1).

Encode/decode route through the unified batched codec engine
(:mod:`repro_torch.coding.codec`); the backend follows ``REPRO_TORCH_CODEC_BACKEND``
(the CUDA ``kernel`` backend by default, ``torch`` or the ``numpy`` oracle
otherwise) and can be overridden per call. :func:`encode_files` amortizes one kernel
launch over a whole batch of same-class files — the proxy's write-queue
drain uses it — and :func:`reconstruct_batch` is its read-side mirror: one
batched decode with per-item ``present`` masks reconstructs a whole
admission round of completed reads, across heterogeneous chunk levels and
erasure patterns.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.coding import codec as codec_mod


def divisors(x: int) -> list[int]:
    return [d for d in range(1, x + 1) if x % d == 0]


@dataclasses.dataclass(frozen=True)
class SharedKeyLayout:
    """Layout parameters for one file class.

    K: code dimension at strip granularity (max chunking level k_max).
    r: integer redundancy ratio (N = r*K).
    strip_bytes: b. File payload is K*b bytes (padded if shorter).
    """

    K: int
    r: int
    strip_bytes: int

    def __post_init__(self):
        if self.K < 1 or self.r < 1 or self.strip_bytes < 1:
            raise ValueError("K, r, strip_bytes must be positive")
        if self.N > 256:
            raise ValueError("N = r*K must be <= 256 for GF(256) RS")

    @property
    def N(self) -> int:
        return self.r * self.K

    @property
    def file_bytes(self) -> int:
        return self.K * self.strip_bytes

    @property
    def object_bytes(self) -> int:
        return self.N * self.strip_bytes

    def supported_k(self) -> list[int]:
        """Chunk-level code dimensions k available from this one object."""
        return sorted(self.K // m for m in divisors(self.K))

    def code_for_k(self, k: int) -> tuple[int, int, int]:
        """(n_max, k, m) for a chunk-level dimension k; n_max = N/m."""
        if self.K % k != 0:
            raise ValueError(f"k={k} must divide K={self.K}")
        m = self.K // k
        if self.N % m != 0:
            raise ValueError(f"m={m} must divide N={self.N}")
        return self.N // m, k, m

    def chunk_bytes(self, k: int) -> int:
        """B = J / k for chunk-level dimension k."""
        _, _, m = self.code_for_k(k)
        return m * self.strip_bytes

    def chunk_range(self, k: int, chunk_idx: int) -> tuple[int, int]:
        """(offset, length) byte range of chunk ``chunk_idx`` at level k.

        This is the argument to the storage partial-read API
        (S3 getObject with setRange / Azure DownloadRangeToStream).
        """
        n_max, _, m = self.code_for_k(k)
        if not 0 <= chunk_idx < n_max:
            raise ValueError(f"chunk_idx {chunk_idx} out of range for n_max={n_max}")
        off = chunk_idx * m * self.strip_bytes
        return off, m * self.strip_bytes

    # -- encode / decode ----------------------------------------------------

    def _strip_data(self, payload: bytes) -> np.ndarray:
        if len(payload) > self.file_bytes:
            raise ValueError(f"payload {len(payload)}B exceeds {self.file_bytes}B")
        buf = np.zeros(self.file_bytes, dtype=np.uint8)
        buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
        return buf.reshape(self.K, self.strip_bytes)

    def _n_strips(self, n: int | None, k: int | None) -> int:
        """Strip count for an adapted chunk-level code (n, k); N if n is None.

        The shared-key property makes the first n·m strips of the FULL (N, K)
        codeword exactly an (n, k) chunk-level codeword, so an adapted write
        is a strip-prefix — existing readers keep decoding at any level whose
        chunks fall inside the written prefix.
        """
        if n is None:
            return self.N
        if k is None:
            raise ValueError("adapted encode needs both n and k")
        n_max, _, m = self.code_for_k(k)
        if not k <= n <= n_max:
            raise ValueError(f"invalid chunk code ({n},{k}) for {self}")
        return n * m

    def encode_file(
        self,
        payload: bytes,
        codec: "codec_mod.Codec | None" = None,
        *,
        n: int | None = None,
        k: int | None = None,
    ) -> bytes:
        """Pad payload to K*b, strip-encode, return the N*b coded object.

        With an adapted chunk-level code (n, k) — the closed-loop write path
        — returns the n·m·b-byte strip prefix instead (see :meth:`_n_strips`).
        """
        codec = codec or codec_mod.get_codec()
        n_strips = self._n_strips(n, k)
        coded = codec.encode(self._strip_data(payload), self.N, self.K, n_out=n_strips)
        return np.asarray(coded).tobytes()

    def encode_files(
        self,
        payloads: Sequence[bytes],
        codec: "codec_mod.Codec | None" = None,
        *,
        n: int | None = None,
        k: int | None = None,
    ) -> list[bytes]:
        """Batch-encode many files of this class in one codec call.

        This is the proxy's admission-round amortization: one (batch, K, b)
        → (batch, N, b) kernel launch instead of per-object launches. The
        optional (n, k) is the adapted chunk-level code for queued writes
        (same prefix semantics as :meth:`encode_file`).
        """
        if not payloads:
            return []
        codec = codec or codec_mod.get_codec()
        n_strips = self._n_strips(n, k)
        data = np.stack([self._strip_data(p) for p in payloads])
        coded = np.asarray(codec.encode(data, self.N, self.K, n_out=n_strips))
        return [coded[i].tobytes() for i in range(len(payloads))]

    def gather_rows(self, k: int, chunks: dict[int, bytes]) -> tuple[np.ndarray, list[int]]:
        """(K, b) surviving strip rows + their strip ids from any >= k
        chunk-level fetches at level k.

        ``chunks`` maps chunk index (at level k) -> chunk bytes. Exactly the
        first k (by index order) are used; extras are ignored (they are the
        redundant tasks the proxy cancels late). Every chunk level yields the
        same (K, b) row block (k chunks cover k·m = K strips), which is what
        lets reads served at *different* levels share one batched decode.
        """
        _, _, m = self.code_for_k(k)
        if len(chunks) < k:
            raise ValueError(f"need >= {k} chunks, got {len(chunks)}")
        use = sorted(chunks)[:k]
        strip_ids: list[int] = []
        rows = np.empty((k * m, self.strip_bytes), dtype=np.uint8)
        for slot, ci in enumerate(use):
            blob = np.frombuffer(chunks[ci], dtype=np.uint8)
            if blob.size != m * self.strip_bytes:
                raise ValueError(f"chunk {ci}: got {blob.size}B, want {m * self.strip_bytes}B")
            rows[slot * m : (slot + 1) * m] = blob.reshape(m, self.strip_bytes)
            strip_ids.extend(range(ci * m, (ci + 1) * m))
        return rows, strip_ids

    def gather_rows_batch(
        self, items: Sequence[tuple[int, dict[int, bytes]]]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Stack :meth:`gather_rows` over (k_level, chunks) pairs into the
        (batch, K, b) rows + (batch, K) present arrays one batched decode
        consumes — shared by :meth:`reconstruct_batch` and the fused serving
        step's raw-chunk assembly."""
        rows = np.empty((len(items), self.K, self.strip_bytes), dtype=np.uint8)
        present = np.empty((len(items), self.K), dtype=np.int64)
        for i, (k, chunks) in enumerate(items):
            rows[i], ids = self.gather_rows(k, chunks)
            present[i] = ids
        return rows, present

    def reconstruct(self, k: int, chunks: dict[int, bytes], payload_len: int | None = None,
                    codec: "codec_mod.Codec | None" = None) -> bytes:
        """Rebuild the file from any >= k chunk-level fetches at level k."""
        return self.reconstruct_batch([(k, chunks, payload_len)], codec=codec)[0]

    def reconstruct_batch(
        self,
        items: Sequence[tuple[int, dict[int, bytes], int | None]],
        codec: "codec_mod.Codec | None" = None,
    ) -> list[bytes]:
        """Rebuild many files of this class in ONE batched decode.

        ``items`` is a sequence of (k_level, chunks, payload_len) triples.
        All reads of one layout share the strip-level (N, K) code no matter
        which chunk level k served them, so the whole admission round — with
        heterogeneous chunk levels *and* heterogeneous erasure patterns —
        collapses into a single ``codec.decode`` call with per-item
        ``present`` masks (the proxy's read-side amortization, the mirror of
        :meth:`encode_files` on the write side).
        """
        if not items:
            return []
        rows, present = self.gather_rows_batch([(k, c) for k, c, _ in items])
        codec = codec or codec_mod.get_codec()
        data = np.asarray(codec.decode(rows, present, self.N, self.K))
        out: list[bytes] = []
        for i, (_, _, payload_len) in enumerate(items):
            blob = data[i].reshape(-1).tobytes()
            out.append(blob if payload_len is None else blob[:payload_len])
        return out


def layout_for_file(file_bytes: int, k_max: int, r_max: int) -> SharedKeyLayout:
    """Choose strip size so K = k_max strips cover the file (paper §V-A uses
    k_max = 6, r_max = 2 for 3MB files -> 0.5MB strips, (12, 6) strip code)."""
    strip = -(-file_bytes // k_max)  # ceil
    return SharedKeyLayout(K=k_max, r=r_max, strip_bytes=strip)
