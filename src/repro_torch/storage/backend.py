"""Emulated key-value object stores with the APIs the paper requires.

The paper's two access modes (§III):
  * Unique Key  — basic ``put`` / ``get`` (every store has these),
  * Shared Key  — "partial read" (:meth:`get_range`, S3 getObject+setRange)
                  and "partial write" (:meth:`upload_part` +
                  :meth:`complete_multipart`, S3 multipart upload).

Implementations: in-memory, file-backed, plus wrappers injecting latency
(from the §III-C delay model) and faults (lost objects / failed reads) used
by the erasure-coded checkpoint tests.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from repro_torch.core.delay_model import DelayParams


class StorageError(KeyError):
    pass


class ObjectStore:
    """Abstract key-value store with ranged and multipart access."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        blob = self.get(key)
        if offset < 0 or offset + length > len(blob):
            raise StorageError(f"range [{offset}, {offset + length}) outside {key}")
        return blob[offset : offset + length]

    def upload_part(self, key: str, part_id: int, data: bytes) -> None:
        raise NotImplementedError

    def complete_multipart(self, key: str, part_ids: list[int]) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def keys(self) -> list[str]:
        raise NotImplementedError


class MemoryStore(ObjectStore):
    def __init__(self):
        self._objects: dict[str, bytes] = {}
        self._parts: dict[str, dict[int, bytes]] = {}
        self._lock = threading.Lock()

    def put(self, key, data):
        with self._lock:
            self._objects[key] = bytes(data)

    def get(self, key):
        with self._lock:
            try:
                return self._objects[key]
            except KeyError:
                raise StorageError(key) from None

    def upload_part(self, key, part_id, data):
        with self._lock:
            self._parts.setdefault(key, {})[part_id] = bytes(data)

    def complete_multipart(self, key, part_ids):
        with self._lock:
            parts = self._parts.pop(key, {})
            missing = [p for p in part_ids if p not in parts]
            if missing:
                raise StorageError(f"{key}: missing parts {missing}")
            self._objects[key] = b"".join(parts[p] for p in part_ids)

    def delete(self, key):
        with self._lock:
            self._objects.pop(key, None)
            self._parts.pop(key, None)

    def exists(self, key):
        with self._lock:
            return key in self._objects

    def keys(self):
        with self._lock:
            return sorted(self._objects)


class FileStore(ObjectStore):
    """Objects as files under a root dir; ranged reads via seek (no full
    object load — the point of partial-read APIs)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_")
        return os.path.join(self.root, safe)

    def put(self, key, data):
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._path(key))

    def get(self, key):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise StorageError(key) from None

    def get_range(self, key, offset, length):
        try:
            with open(self._path(key), "rb") as f:
                f.seek(offset)
                out = f.read(length)
        except FileNotFoundError:
            raise StorageError(key) from None
        if len(out) != length:
            raise StorageError(f"short read on {key}")
        return out

    def upload_part(self, key, part_id, data):
        self.put(f"{key}.part{part_id}", data)

    def complete_multipart(self, key, part_ids):
        chunks = []
        for p in part_ids:
            chunks.append(self.get(f"{key}.part{p}"))
        self.put(key, b"".join(chunks))
        for p in part_ids:
            self.delete(f"{key}.part{p}")

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def exists(self, key):
        return os.path.exists(self._path(key))

    def keys(self):
        return sorted(os.listdir(self.root))


class LatencyStore(ObjectStore):
    """Injects §III-C task delays: sleep(Δ(B) + Exp(1/μ(B))) · time_scale.

    ``time_scale`` compresses emulated seconds to wall seconds so tests run
    fast while preserving relative timing (default 1 ms wall per emulated s).
    """

    def __init__(
        self,
        inner: ObjectStore,
        read_params: DelayParams,
        write_params: DelayParams | None = None,
        *,
        time_scale: float = 1e-3,
        seed: int = 0,
    ):
        self.inner = inner
        self.read_params = read_params
        self.write_params = write_params or read_params
        self.time_scale = time_scale
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.emulated_busy_s = 0.0  # accumulated emulated task time

    def _delay(self, params: DelayParams, nbytes: int) -> float:
        mb = nbytes / 2**20
        with self._lock:
            d = float(params.sample(self._rng, mb))
            self.emulated_busy_s += d
        return d

    def _sleep(self, d: float):
        if self.time_scale > 0:
            time.sleep(d * self.time_scale)

    def put(self, key, data):
        self._sleep(self._delay(self.write_params, len(data)))
        self.inner.put(key, data)

    def get(self, key):
        out = self.inner.get(key)
        self._sleep(self._delay(self.read_params, len(out)))
        return out

    def get_range(self, key, offset, length):
        out = self.inner.get_range(key, offset, length)
        self._sleep(self._delay(self.read_params, length))
        return out

    def upload_part(self, key, part_id, data):
        self._sleep(self._delay(self.write_params, len(data)))
        self.inner.upload_part(key, part_id, data)

    def complete_multipart(self, key, part_ids):
        self.inner.complete_multipart(key, part_ids)

    def delete(self, key):
        self.inner.delete(key)

    def exists(self, key):
        return self.inner.exists(key)

    def keys(self):
        return self.inner.keys()


class FaultyStore(ObjectStore):
    """Drops reads with probability p_fail and can lose objects outright —
    the failure model the erasure-coded checkpoint layer must survive."""

    def __init__(self, inner: ObjectStore, *, p_fail: float = 0.0, seed: int = 0):
        self.inner = inner
        self.p_fail = p_fail
        self._rng = np.random.default_rng(seed)
        self._lost: set[str] = set()
        self._lock = threading.Lock()

    def lose_object(self, key: str) -> None:
        with self._lock:
            self._lost.add(key)

    def _maybe_fail(self, key: str):
        with self._lock:
            if key in self._lost:
                raise StorageError(f"{key}: object lost")
            if self.p_fail > 0 and self._rng.random() < self.p_fail:
                raise StorageError(f"{key}: transient read failure")

    def put(self, key, data):
        self.inner.put(key, data)
        with self._lock:
            self._lost.discard(key)

    def get(self, key):
        self._maybe_fail(key)
        return self.inner.get(key)

    def get_range(self, key, offset, length):
        self._maybe_fail(key)
        return self.inner.get_range(key, offset, length)

    def upload_part(self, key, part_id, data):
        self.inner.upload_part(key, part_id, data)

    def complete_multipart(self, key, part_ids):
        self.inner.complete_multipart(key, part_ids)

    def delete(self, key):
        self.inner.delete(key)

    def exists(self, key):
        with self._lock:
            if key in self._lost:
                return False
        return self.inner.exists(key)

    def keys(self):
        with self._lock:
            lost = set(self._lost)
        return [k for k in self.inner.keys() if k not in lost]
