"""The benchmark's own object store: an emulated S3 behind the proxy.

It holds objects in memory and implements the port's ``ObjectStore``
interface (ranged reads and multipart writes, as S3 offers them). With its
delay on, each read task sleeps Δ(B) + Exp(1/μ(B)) real seconds times
``time_scale`` for a task of B MB, the paper's task-delay model (§III-C,
Eq. 1). The constants are a frozen copy of the §V-A calibration for the
(read, 3 MB) class, so the store does not change when the program's copy
does. Writes take no delay: only set-up writes, before the window.

The exponential tails are the unit exponential's quantiles at
(i + 1/2) / BLOCK, a block of them in an order drawn from the run's seed,
then the next block in another, taken one per task in turn. Every BLOCK
tasks in a row draw the same tails, so every seed draws the same tails in
another order, up to the last, partial block of a window's few thousand.

Set-up stores objects with the delay off; the window runs with it on.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.storage.backend import ObjectStore, StorageError


@dataclasses.dataclass(frozen=True)
class Delay:
    """Δ(B) = Δ̄ + Δ̃·B and a tail of mean Ψ̄ + Ψ̃·B, in seconds and MB."""

    delta_bar: float
    delta_tilde: float
    psi_bar: float
    psi_tilde: float

    def floor_s(self, mb: float) -> float:
        return self.delta_bar + self.delta_tilde * mb

    def tail_s(self, mb: float) -> float:
        return self.psi_bar + self.psi_tilde * mb

    def mean_s(self, mb: float) -> float:
        return self.floor_s(mb) + self.tail_s(mb)


#: §V-A, the (read, 3 MB) class at L = 16, as calibrated in the port's
#: ``core/delay_model.py`` (``PAPER_READ_3MB``).
PAPER_READ_3MB = Delay(delta_bar=0.050, delta_tilde=0.018, psi_bar=0.015, psi_tilde=0.030)

DELAYS = {"paper_read_3mb": PAPER_READ_3MB}

#: unit exponential tails in a block, each drawn once before any is again
BLOCK = 1 << 10
#: blocks in the pool (a window issues some thousands of tasks)
BLOCKS = 64
POOL = BLOCK * BLOCKS


class EmulatedS3(ObjectStore):
    def __init__(self, read: Delay, *, seed_rng: np.random.Generator, time_scale: float = 1.0):
        self.read_delay = read
        self.time_scale = time_scale
        self.delay_on = False
        quantiles = -np.log1p(-(np.arange(BLOCK) + 0.5) / BLOCK)
        self._tails = np.concatenate([seed_rng.permutation(quantiles) for _ in range(BLOCKS)])
        self._next = 0
        self._objects: dict[str, bytes] = {}
        self._parts: dict[str, dict[int, bytes]] = {}
        self._lock = threading.Lock()
        #: delay-on read tasks: (bytes, seconds drawn, monotonic start), in
        #: the order drawn
        self.tasks: list[tuple[int, float, float]] = []

    def _sleep(self, nbytes: int) -> None:
        if not self.delay_on:
            return
        mb = nbytes / 2**20
        with self._lock:
            unit = float(self._tails[self._next % POOL])
            self._next += 1
            d = self.read_delay.floor_s(mb) + unit * self.read_delay.tail_s(mb)
            self.tasks.append((nbytes, d, time.monotonic()))
        time.sleep(d * self.time_scale)

    def put(self, key, data):
        with self._lock:
            self._objects[key] = bytes(data)

    def get(self, key):
        with self._lock:
            blob = self._objects.get(key)
        if blob is None:
            raise StorageError(key)
        self._sleep(len(blob))
        return blob

    def get_range(self, key, offset, length):
        with self._lock:
            blob = self._objects.get(key)
        if blob is None:
            raise StorageError(key)
        if offset < 0 or offset + length > len(blob):
            raise StorageError(f"range [{offset}, {offset + length}) outside {key}")
        out = blob[offset:offset + length]
        self._sleep(length)
        return out

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
