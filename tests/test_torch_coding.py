"""The port's coding layer (gf256, rs, codec, layout) against the reference
package's, byte for byte, on the CPU."""

import numpy as np
import pytest
import torch

from repro.coding import gf256 as ref_gf256
from repro.coding import layout as ref_layout
from repro.coding import rs as ref_rs
from repro.coding.codec import Codec as RefCodec
from repro_torch.coding import gf256, layout, rs
from repro_torch.coding.codec import Codec, available_backends, get_codec

BACKENDS = ["numpy", "torch", "kernel"]
# The (n, k) grid of tests/test_codec.py, with the degenerate corners.
NK_GRID = [(1, 1), (2, 1), (4, 1), (3, 3), (4, 3), (6, 3), (12, 6), (5, 4), (8, 4)]
# Codes also run through the reference's Pallas backend (interpret mode).
PALLAS_NK = [(2, 1), (6, 3), (12, 6)]


def _codec(name):
    return Codec(name, device="cpu")


def test_gf256_tables_and_bitmatrices_equal_reference():
    np.testing.assert_array_equal(gf256.exp_table(), ref_gf256.exp_table())
    np.testing.assert_array_equal(gf256.log_table(), ref_gf256.log_table())
    np.testing.assert_array_equal(gf256._bitmatrix_cache(), ref_gf256._bitmatrix_cache())
    rng = np.random.default_rng(0)
    mats = rng.integers(0, 256, (3, 5, 7), dtype=np.uint8)
    np.testing.assert_array_equal(gf256.expand_bitmatrix_batched(mats),
                                  ref_gf256.expand_bitmatrix_batched(mats))
    a = rng.integers(1, 256, (6, 6), dtype=np.uint8)
    np.testing.assert_array_equal(gf256.mul(a, a.T), ref_gf256.mul(a, a.T))
    np.testing.assert_array_equal(gf256.inv(a), ref_gf256.inv(a))


def test_rs_matrices_equal_reference():
    rng = np.random.default_rng(1)
    for n, k in NK_GRID + [(256, 128), (20, 7)]:
        np.testing.assert_array_equal(rs.cauchy_parity_matrix(n, k),
                                      ref_rs.cauchy_parity_matrix(n, k))
        np.testing.assert_array_equal(rs.generator_matrix(n, k), ref_rs.generator_matrix(n, k))
        for _ in range(4):
            present = tuple(int(i) for i in rng.permutation(n)[:k])
            np.testing.assert_array_equal(rs.decode_matrix(n, k, present),
                                          ref_rs.decode_matrix(n, k, present))


@pytest.fixture(scope="module")
def grid_cases():
    """Seeded encode/decode cases with the reference's numpy answers."""
    rng = np.random.default_rng(2)
    ref = RefCodec("numpy")
    cases = []
    for n, k in NK_GRID:
        B = int(rng.integers(1, 150))
        batch = int(rng.integers(1, 5))
        data = rng.integers(0, 256, size=(batch, k, B), dtype=np.uint8)
        coded = ref.encode(data, n, k)
        present = np.stack([np.sort(rng.choice(n, size=k, replace=False))
                            for _ in range(batch)])
        rows = np.stack([coded[i][present[i]] for i in range(batch)])
        cases.append((n, k, data, coded, present, rows))
    return cases


@pytest.mark.parametrize("backend", BACKENDS)
def test_encode_decode_equal_reference_over_grid(backend, grid_cases):
    c = _codec(backend)
    for n, k, data, coded, present, rows in grid_cases:
        np.testing.assert_array_equal(c.encode(data, n, k), coded)
        np.testing.assert_array_equal(c.decode(rows, present, n, k), data)
        for n_out in {k, (n + k) // 2, n}:
            np.testing.assert_array_equal(c.encode(data, n, k, n_out=n_out),
                                          coded[:, :n_out])


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_equal_reference_pallas_backend(backend):
    """Same bytes as the reference's Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(3)
    ref, c = RefCodec("pallas", interpret=True), _codec(backend)
    for n, k in PALLAS_NK:
        data = rng.integers(0, 256, size=(3, k, 70), dtype=np.uint8)
        np.testing.assert_array_equal(c.encode(data, n, k), np.asarray(ref.encode(data, n, k)))
        present = np.stack([rng.permutation(n)[:k] for _ in range(3)])
        rows = rng.integers(0, 256, size=(3, k, 70), dtype=np.uint8)
        np.testing.assert_array_equal(c.decode(rows, present, n, k),
                                      np.asarray(ref.decode(rows, present, n, k)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_rank2_and_blob_helpers_equal_reference(backend):
    rng = np.random.default_rng(4)
    ref, c = RefCodec("numpy"), _codec(backend)
    data = rng.integers(0, 256, size=(3, 50), dtype=np.uint8)
    np.testing.assert_array_equal(c.encode(data, 6, 3), ref.encode(data, 6, 3))
    n, k = 7, 3
    payloads = [rng.integers(0, 256, size=sz, dtype=np.uint8) for sz in (1, 17, 1000, 257)]
    for got, want in zip(c.encode_blobs(payloads, n=n, k=k),
                         ref.encode_blobs(payloads, n=n, k=k)):
        np.testing.assert_array_equal(got, want)
    for p in payloads:
        strips = c.encode_blob(p, n=n, k=k)
        present = tuple(np.sort(rng.choice(n, size=k, replace=False)))
        got = c.decode_blob(strips[list(present)], present, n=n, k=k, payload_len=p.size)
        np.testing.assert_array_equal(got, p)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_tensor_inputs_stay_tensors(backend):
    rng = np.random.default_rng(5)
    c = _codec(backend)
    data = rng.integers(0, 256, size=(2, 4, 33), dtype=np.uint8)
    out = c.encode(torch.from_numpy(data), 8, 4)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), RefCodec("numpy").encode(data, 8, 4))
    # the numpy oracle reads a tensor through the host and answers in numpy
    assert isinstance(_codec("numpy").encode(torch.from_numpy(data), 8, 4), np.ndarray)


@pytest.mark.parametrize("backend,ref_backend", [("numpy", "numpy"), ("torch", "jnp"),
                                                 ("kernel", "pallas")])
def test_bucket_keys_equal_reference_and_bound_first_uses(backend, ref_backend):
    rng = np.random.default_rng(6)
    c = _codec(backend)
    ref = RefCodec(ref_backend, interpret=True) if ref_backend == "pallas" else RefCodec(ref_backend)
    stream = [(n, k) for k in (2, 4) for n in (k, k + 1, k + 2, 2 * k)]
    buckets = set()
    for n, k in stream:
        for B, batch in rng.integers(1, 3000, size=(8, 2)):
            for kind in ("enc", "dec"):
                assert c.bucket_key(kind, n, k, B, batch) == ref.bucket_key(kind, n, k, B, batch)
    for n, k in stream * 2:  # revisiting every code adds no bucket
        B, batch = int(rng.integers(60, 128)), 2
        data = rng.integers(0, 256, size=(batch, k, B), dtype=np.uint8)
        coded = c.encode(data, n, k)
        if n > k:
            buckets.add(c.bucket_key("enc", n, k, B, batch))
        present = tuple(range(n - k, n))
        np.testing.assert_array_equal(c.decode(coded[:, list(present)], present, n, k), data)
        buckets.add(c.bucket_key("dec", n, k, B, batch))
    assert c.stats.traces <= len(buckets)
    assert c.stats.calls > 2 * len(buckets)


def test_layout_encode_and_reconstruct_equal_reference_across_chunk_levels():
    rng = np.random.default_rng(7)
    lay = layout.SharedKeyLayout(K=6, r=2, strip_bytes=100)
    ref_lay = ref_layout.SharedKeyLayout(K=6, r=2, strip_bytes=100)
    c, ref = _codec("kernel"), RefCodec("numpy")
    payloads = [rng.bytes(int(rng.integers(1, lay.file_bytes + 1))) for _ in range(6)]
    objs = lay.encode_files(payloads, codec=c)
    assert objs == ref_lay.encode_files(payloads, codec=ref)
    for n, k in [(4, 2), (5, 3)]:  # adapted chunk-level codes: strip prefixes
        assert lay.encode_files(payloads, codec=c, n=n, k=k) == \
            ref_lay.encode_files(payloads, codec=ref, n=n, k=k)
    items = []
    for obj, p in zip(objs, payloads):
        k = int(rng.choice(lay.supported_k()))
        n_max, _, _ = lay.code_for_k(k)
        chunks = {}
        for ci in rng.permutation(n_max)[:k]:
            off, ln = lay.chunk_range(k, int(ci))
            chunks[int(ci)] = obj[off:off + ln]
        items.append((k, chunks, len(p)))
    got = lay.reconstruct_batch(items, codec=c)
    assert got == ref_lay.reconstruct_batch(items, codec=ref) == payloads


def test_registry_and_no_silent_cpu_fallback():
    assert set(BACKENDS) <= set(available_backends())
    with pytest.raises(ValueError):
        Codec("no-such-backend")
    assert get_codec("numpy") is get_codec("numpy")
    assert get_codec("kernel", device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    for make in (lambda: Codec("kernel"), lambda: get_codec(),
                 lambda: Codec("torch", device="cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
