"""The port's data pipeline (``repro_torch.data``) against the reference's
on the CPU: ``SyntheticTokens`` batches byte for byte, and
``CodedShardReader`` shards stored and read back through the proxy as the
reference stores and reads them. Mirrors
``tests/test_train_ckpt.py::test_synthetic_data_deterministic_and_sharded``."""

import dataclasses

import numpy as np
import pytest

from repro.core import StaticPolicy as RefStaticPolicy
from repro.data import CodedShardReader as RefCodedShardReader
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.models import get as ref_get
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.storage import MemoryStore as RefMemoryStore
from repro.storage import Proxy as RefProxy
from repro.coding.layout import layout_for_file as ref_layout_for_file
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import layout_for_file
from repro_torch.core import StaticPolicy
from repro_torch.data import CodedShardReader, SyntheticTokens
from repro_torch.models import get
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.storage import FaultyStore, MemoryStore, Proxy

CODEC = Codec("kernel", device="cpu")
SHAPE = ShapeSpec("tiny_train", "train", seq=32, batch=2)


def test_synthetic_data_deterministic_and_sharded():
    cfg = get("qwen1.5-0.5b", smoke=True).cfg
    a = SyntheticTokens(cfg, SHAPE, seed=7).batch_at(3)
    b = SyntheticTokens(cfg, SHAPE, seed=7).batch_at(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    s0 = SyntheticTokens(cfg, ShapeSpec("t", "train", 32, 4), seed=7, shard_id=0, n_shards=2)
    s1 = SyntheticTokens(cfg, ShapeSpec("t", "train", 32, 4), seed=7, shard_id=1, n_shards=2)
    assert not np.array_equal(s0.batch_at(0)["tokens"], s1.batch_at(0)["tokens"])


@pytest.mark.parametrize("family", ["dense", "encdec", "vlm"])
@pytest.mark.parametrize("seed,shard_id,n_shards", [(0, 0, 1), (7, 1, 2), (3, 3, 4)])
def test_synthetic_batches_equal_the_references(family, seed, shard_id, n_shards):
    """Every array of steps 0, 1 and 9, byte for byte, for each family's
    extra inputs (frames, patches) too."""
    ref_cfg = dataclasses.replace(ref_get("qwen1.5-0.5b").cfg, family=family, encoder_seq=6,
                                  vision_patches=5)
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    port = SyntheticTokens(cfg, ShapeSpec("t", "train", 4096, 8), seed=seed,
                           shard_id=shard_id, n_shards=n_shards)
    ref = RefSyntheticTokens(ref_cfg, RefShapeSpec("t", "train", 4096, 8), seed=seed,
                             shard_id=shard_id, n_shards=n_shards)
    for step in (0, 1, 9):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            assert got[key].tobytes() == want[key].tobytes(), (step, key)
    first = next(iter(port))
    assert first["tokens"].tobytes() == port.batch_at(0)["tokens"].tobytes()


def test_synthetic_tokens_refuse_an_uneven_split():
    with pytest.raises(ValueError, match="not divisible"):
        SyntheticTokens(get("qwen1.5-0.5b", smoke=True).cfg, SHAPE, n_shards=3)


def test_coded_shard_reader_gives_the_references_arrays():
    """Three shards of 2 × 4,097 tokens written with the (12, 6) shared-key
    layout: the stored objects equal the reference's, and the reader,
    through the port's proxy over a store that fails 10 % of its reads,
    hands out the reference reader's arrays in its order."""
    rng = np.random.default_rng(11)
    shards = [rng.integers(0, 151936, (2, 4097)).astype(np.int32) for _ in range(3)]
    nbytes = shards[0].size * 4
    layout, ref_layout = layout_for_file(nbytes, 6, 2), ref_layout_for_file(nbytes, 6, 2)
    store, ref_store = MemoryStore(), RefMemoryStore()
    keys = CodedShardReader.write_shards(store, layout, shards, "data", codec=CODEC)
    ref_keys = RefCodedShardReader.write_shards(ref_store, ref_layout, shards, "data")
    assert keys == ref_keys == ["data/shard00000", "data/shard00001", "data/shard00002"]
    for key in keys:
        assert store.get(key) == ref_store.get(key)

    faulty = FaultyStore(store, p_fail=0.1, seed=2)
    proxy = Proxy(faulty, StaticPolicy(12, 6), L=8, codec=CODEC)
    ref_proxy = RefProxy(ref_store, RefStaticPolicy(12, 6), L=8)
    reader = CodedShardReader(proxy, layout, keys, tokens_per_shard=2 * 4097)
    ref_reader = RefCodedShardReader(ref_proxy, ref_layout, ref_keys,
                                     tokens_per_shard=2 * 4097)
    try:
        for i in range(4):
            key, arr = reader.next_shard(timeout=60)
            ref_key, want = ref_reader.next_shard(timeout=60)
            assert key == ref_key == keys[i % 3]
            assert arr.dtype == np.int32 and arr.tobytes() == want.tobytes()
            assert arr.tobytes() == shards[i % 3].tobytes()
    finally:
        reader.close()
        ref_reader.close()
        for r in (reader, ref_reader):  # let an in-flight read finish first
            r._thread.join(timeout=30)
            assert not r._thread.is_alive()
        proxy.close()
        ref_proxy.close()
