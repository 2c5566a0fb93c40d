"""The port's object stores and proxy: the copied stores against the
reference's (same seeds, same draws), and the proxy's read and write paths
through the port's codec on the CPU (cases of tests/test_storage.py and
tests/test_proxy_batched.py)."""

import numpy as np
import pytest
import torch

from repro.core.delay_model import PAPER_READ_3MB as REF_READ
from repro.storage import backend as ref_backend
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, GreedyPolicy, StaticPolicy
from repro_torch.storage import (
    FaultyStore,
    FileStore,
    LatencyStore,
    MemoryStore,
    Proxy,
    StorageError,
    store_coded_object,
)

LAYOUT = SharedKeyLayout(K=6, r=2, strip_bytes=128)
CODEC = Codec("kernel", device=torch.device("cpu"))


def _payloads(rng, count, nbytes):
    return [rng.bytes(nbytes) for _ in range(count)]


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_store_range_and_multipart(kind, tmp_path):
    s = MemoryStore() if kind == "memory" else FileStore(str(tmp_path / "store"))
    s.put("a", b"hello world")
    assert s.get("a") == b"hello world" and s.get_range("a", 6, 5) == b"world"
    s.delete("a")
    assert not s.exists("a")
    with pytest.raises(StorageError):
        s.get("a")
    for part, blob in [(0, b"AA"), (2, b"CC"), (1, b"BB")]:
        s.upload_part("obj", part, blob)
    s.complete_multipart("obj", [0, 1, 2])
    assert s.get("obj") == b"AABBCC"


def test_latency_and_faulty_stores_draw_like_reference():
    """Same seeds, same emulated delays and the same failure pattern."""
    port = LatencyStore(MemoryStore(), PAPER_READ_3MB, time_scale=0.0, seed=1)
    ref = ref_backend.LatencyStore(ref_backend.MemoryStore(), REF_READ, time_scale=0.0, seed=1)
    for s in (port, ref):
        s.put("x", b"z" * 4096)
        for off in range(0, 4096, 512):
            s.get_range("x", off, 512)
    assert port.emulated_busy_s == ref.emulated_busy_s > 0
    outcomes = []
    for mk, inner in ((FaultyStore, MemoryStore()),
                      (ref_backend.FaultyStore, ref_backend.MemoryStore())):
        s = mk(inner, p_fail=0.3, seed=2)
        s.put("x", b"data")
        seq = []
        for _ in range(40):
            try:
                s.get_range("x", 0, 2)
                seq.append(True)
            except Exception:
                seq.append(False)
        outcomes.append(seq)
    assert outcomes[0] == outcomes[1] and not all(outcomes[0])


def test_proxy_read_many_heterogeneous_erasures():
    rng = np.random.default_rng(0)
    inner = MemoryStore()
    payloads = _payloads(rng, 8, LAYOUT.file_bytes - 11)
    keys = [f"obj/{i}" for i in range(8)]
    for key, p in zip(keys, payloads):
        store_coded_object(inner, key, LAYOUT, p, codec=CODEC)
    proxy = Proxy(FaultyStore(inner, p_fail=0.15, seed=1), StaticPolicy(12, 6), L=8,
                  codec=CODEC)
    try:
        results = proxy.read_many(keys, LAYOUT, payload_len=len(payloads[0]))
        assert all(r.ok for r in results)
        assert [r.data for r in results] == payloads
    finally:
        proxy.close()


def test_proxy_mixed_chunk_levels_and_raw_reads():
    rng = np.random.default_rng(3)
    inner = MemoryStore()
    payloads = _payloads(rng, 6, LAYOUT.file_bytes)
    keys = [f"mix/{i}" for i in range(6)]
    for key, p in zip(keys, payloads):
        store_coded_object(inner, key, LAYOUT, p, codec=CODEC)

    class _CyclePolicy(StaticPolicy):
        """Cycles the chunk level so one round mixes k = 6, 3, 2, 1."""

        def __init__(self):
            super().__init__(12, 6)
            self._cycle = [(12, 6), (6, 3), (4, 2), (2, 1), (3, 3), (2, 2)]
            self._i = 0

        def select(self, *, q, idle, cls_id=0, now=None):
            out = self._cycle[self._i % len(self._cycle)]
            self._i += 1
            return out

    proxy = Proxy(inner, _CyclePolicy(), L=8, codec=CODEC)
    try:
        results = proxy.read_many(keys, LAYOUT, payload_len=LAYOUT.file_bytes)
        assert sorted({r.k for r in results}) == [1, 2, 3, 6]
        assert [r.data for r in results] == payloads
        raw = proxy.read(keys[0], LAYOUT, payload_len=LAYOUT.file_bytes, raw=True)
        assert raw.ok and raw.data is None and len(raw.chunks) >= raw.k
        assert LAYOUT.reconstruct(raw.k, raw.chunks, LAYOUT.file_bytes, codec=CODEC) == \
            payloads[0]
    finally:
        proxy.close()


def test_proxy_write_flush_then_read():
    rng = np.random.default_rng(4)
    proxy = Proxy(MemoryStore(), GreedyPolicy(k_max=6, r_max=2.0), L=16, codec=CODEC)
    payloads = _payloads(rng, 5, LAYOUT.file_bytes - 7)
    try:
        for i, p in enumerate(payloads):
            assert proxy.write(f"w/{i}", LAYOUT, p).ok
        proxy.flush_writes(timeout=30)
        for i, p in enumerate(payloads):
            res = proxy.read(f"w/{i}", LAYOUT, payload_len=len(p))
            assert res.ok and res.data == p
    finally:
        proxy.close()
