"""Deterministic data pipeline with storage-backed, erasure-coded shards.

The port of the reference package's ``repro/data/pipeline.py``. Two tiers:
  * :class:`SyntheticTokens` — seeded synthetic next-token batches, drawn
    with numpy exactly as the reference draws them (byte-equal batches).
    Deterministic per (seed, step, data_shard), so restarts resume
    bit-identically.
  * :class:`CodedShardReader` — token shards stored in the object store as
    Shared-Key coded objects and fetched through the port's TOFEC proxy, so
    each read's decode runs through the codec (K1 on the card): redundant
    ranged reads absorb storage stragglers and failures, with a background
    prefetch thread.
"""

from __future__ import annotations

import queue as _queue
import threading

import numpy as np

from repro_torch.coding import codec as codec_mod
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.storage.proxy import Proxy, store_coded_object


class SyntheticTokens:
    """Deterministic synthetic LM batches: tokens + aligned next-token labels.

    The underlying stream is a per-shard counter-seeded PRNG: batch ``step``
    for shard ``(shard_id, n_shards)`` never depends on wall clock or
    iteration history — checkpoint/restart and elastic re-sharding resume
    exactly. Batches are host numpy arrays.
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, *, seed: int = 0,
                 shard_id: int = 0, n_shards: int = 1):
        if shape.batch % n_shards != 0:
            raise ValueError(f"batch {shape.batch} not divisible by {n_shards} shards")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.local_batch = shape.batch // n_shards

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_id])
        )
        B, S = self.local_batch, self.shape.seq
        stream = rng.integers(0, self.cfg.vocab, size=(B, S + 1), dtype=np.int64)
        out = {
            "tokens": stream[:, :S].astype(np.int32),
            "labels": stream[:, 1:].astype(np.int32),
        }
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (B, self.cfg.encoder_seq, self.cfg.d_model), dtype=np.float32
            )
        if self.cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (B, self.cfg.vision_patches, self.cfg.d_model), dtype=np.float32
            )
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class CodedShardReader:
    """Reads tokenized shards from the object store via the TOFEC proxy.

    Shards are Shared-Key coded objects (one per shard id). A background
    thread prefetches ``prefetch`` shards ahead; a failed or slow chunk is
    absorbed by the (n, k) code rather than stalling the trainer. Each read
    is decoded by the proxy's codec.
    """

    def __init__(self, proxy: Proxy, layout: SharedKeyLayout, shard_keys: list[str],
                 *, tokens_per_shard: int, prefetch: int = 2):
        self.proxy = proxy
        self.layout = layout
        self.shard_keys = shard_keys
        self.tokens_per_shard = tokens_per_shard
        self._q: _queue.Queue = _queue.Queue(maxsize=prefetch)
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def write_shards(store, layout: SharedKeyLayout, shards: list[np.ndarray], prefix: str,
                     *, codec: codec_mod.Codec | None = None):
        """Code and store each shard as int32 tokens under
        ``{prefix}/shard{i:05d}``; returns the keys. ``codec`` defaults to
        :func:`repro_torch.coding.codec.get_codec` (the card)."""
        keys = []
        for i, arr in enumerate(shards):
            key = f"{prefix}/shard{i:05d}"
            store_coded_object(store, key, layout, arr.astype(np.int32).tobytes(), codec=codec)
            keys.append(key)
        return keys

    def _loop(self):
        idx = 0
        while not self._stop:
            key = self.shard_keys[idx % len(self.shard_keys)]
            res = self.proxy.read(key, self.layout, payload_len=self.tokens_per_shard * 4)
            if res.ok:
                arr = np.frombuffer(res.data, np.int32)
                try:
                    self._q.put((key, arr), timeout=1.0)
                    idx += 1
                except _queue.Full:
                    continue
            # on failure: retry the same shard (redundancy usually absorbs it)

    def next_shard(self, timeout: float = 30.0) -> tuple[str, np.ndarray]:
        return self._q.get(timeout=timeout)

    def close(self):
        self._stop = True
