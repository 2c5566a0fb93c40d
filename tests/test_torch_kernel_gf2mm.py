"""The port's gf2mm kernel module on the CPU: the K1 and K2 wrappers (which
run their plain versions on CPU tensors) against the reference's Pallas
kernels in interpret mode, the other plain versions against the reference's
oracles, the wrappers' input checks, and no silent CPU fallback.

Tolerance: none. Every comparison is exact (mod-2 and GF(256) products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.coding import gf256 as ref_gf256
from repro.kernels.gf2mm import gf2mm as ref_gf2mm
from repro.kernels.gf2mm import ops as ref_ops
from repro.kernels.gf2mm import ref as ref_ref
from repro_torch.coding import rs
from repro_torch.kernels.gf2mm import ops, ref
from repro_torch.kernels.gf2mm.gf2mm import gf2_matmul, gf2_rs_matmul_bytes

# (k, 8m, B, batch): a spread over k ∈ {1, 3, 6, 16}, 8m ∈ {8, 48, 64, 136},
# B ∈ {57, 128, 700}, batch ∈ {1, 3}, kept small because each case runs the
# reference kernel in interpret mode.
K1_CASES = [
    (1, 8, 57, 1),
    (1, 136, 700, 3),
    (3, 48, 128, 3),
    (3, 64, 57, 1),
    (6, 48, 700, 1),
    (6, 64, 128, 3),
    (6, 136, 57, 3),
    (16, 8, 700, 3),
    (16, 64, 128, 1),
    (16, 136, 57, 1),
]


@pytest.mark.parametrize("k,m8,B,batch", K1_CASES)
def test_k1_equals_reference_pallas_kernel(k, m8, B, batch):
    rng = np.random.default_rng(k * 1000 + m8 * 10 + batch)
    if m8 % 16:  # random 0/1 matrices
        bitmats = rng.integers(0, 2, (batch, m8, 8 * k), dtype=np.uint8)
    else:  # GF(2) expansions of random GF(256) coding matrices
        bitmats = ref_gf256.expand_bitmatrix_batched(
            rng.integers(0, 256, (batch, m8 // 8, k), dtype=np.uint8))
    data = rng.integers(0, 256, (batch, k, B), dtype=np.uint8)
    want = np.asarray(ref_gf2mm.gf2_rs_matmul_bytes(jnp.asarray(bitmats), jnp.asarray(data),
                                                    interpret=True))
    before = gf2_rs_matmul_bytes.launches
    got = gf2_rs_matmul_bytes(torch.from_numpy(bitmats), torch.from_numpy(data))
    assert got.dtype == torch.uint8 and got.shape == (batch, m8 // 8, B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert gf2_rs_matmul_bytes.launches == before  # the CPU path launches nothing


# The shape × dtype grid of the reference's own K2 test.
K2_SHAPES = [(8, 8, 16), (48, 48, 256), (128, 128, 128), (130, 200, 513), (256, 2048, 1024)]


@pytest.mark.parametrize("M,K,N", K2_SHAPES)
@pytest.mark.parametrize("in_dtype", [np.uint8, np.int8, np.float32])
def test_k2_equals_reference_pallas_kernel(M, K, N, in_dtype):
    rng = np.random.default_rng(M * 7 + K * 3 + N)
    a = rng.integers(0, 2, size=(M, K)).astype(in_dtype)
    b = rng.integers(0, 2, size=(K, N)).astype(in_dtype)
    want = np.asarray(ref_gf2mm.gf2_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True))
    before = gf2_matmul.launches
    got = gf2_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.uint8 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert gf2_matmul.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("M,K,N,in_dtype,lo,hi", [
    (8, 8, 16, np.int8, -3, 4),
    (48, 48, 256, np.int8, -3, 4),
    (130, 200, 513, np.int8, -3, 4),
    (8, 8, 16, np.uint8, 0, 256),
    (48, 48, 256, np.uint8, 0, 256),
    (130, 200, 513, np.uint8, 0, 256),
])
def test_k2_counts_entries_by_lowest_bit(M, K, N, in_dtype, lo, hi):
    """Integer entries beyond 0/1 count by their lowest bit, in the port as
    in the reference. The reference's bf16 products and float32 sums stay
    exact here: K ≤ 200, so every sum is at most 200 · 255² < 2**24."""
    rng = np.random.default_rng(M * 11 + K + N + hi)
    a = rng.integers(lo, hi, size=(M, K)).astype(in_dtype)
    b = rng.integers(lo, hi, size=(K, N)).astype(in_dtype)
    want = np.asarray(ref_gf2mm.gf2_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = gf2_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    low = (a.astype(np.int64) & 1) @ (b.astype(np.int64) & 1) & 1
    np.testing.assert_array_equal(got.numpy(), low)


@pytest.mark.parametrize("bm,bn,bk", [(128, 128, 128), (128, 256, 256), (256, 512, 128)])
def test_k2_equals_reference_at_every_reference_block_shape(bm, bn, bk):
    """The reference's block sweep: only the reference's TPU tiles vary; the
    port has no tile arguments, and its result must not move."""
    rng = np.random.default_rng(bm + bn + bk)
    M, K, N = 96, 320, 640
    a = rng.integers(0, 2, size=(M, K), dtype=np.uint8)
    b = rng.integers(0, 2, size=(K, N), dtype=np.uint8)
    want = ref_gf2mm.gf2_matmul(jnp.asarray(a), jnp.asarray(b), block_m=bm, block_n=bn,
                                block_k=bk, interpret=True)
    np.testing.assert_array_equal(gf2_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(want))


def test_k2_views_and_out_dtype():
    """A transposed (non-contiguous) operand, and the out_dtype argument, as
    in the reference's ``out_dtype``."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2, size=(40, 24), dtype=np.uint8)
    bt = rng.integers(0, 2, size=(72, 24), dtype=np.uint8)  # B stored transposed
    b = torch.from_numpy(bt).T
    assert not b.is_contiguous()
    want = np.asarray(ref_gf2mm.gf2_matmul(jnp.asarray(a), jnp.asarray(bt.T), out_dtype=jnp.int32,
                                           interpret=True))
    got = gf2_matmul(torch.from_numpy(a), b, out_dtype=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("a,b,exc", [
    (np.zeros((2, 2), np.uint8), torch.zeros(2, 2), TypeError),
    (torch.zeros(2, 2, 2), torch.zeros(2, 2), ValueError),
    (torch.zeros(2, 3), torch.zeros(2, 2), ValueError),
])
def test_k2_wrapper_rejects_bad_inputs(a, b, exc):
    with pytest.raises(exc):
        gf2_matmul(a, b)


def test_plain_versions_equal_reference_oracles():
    rng = np.random.default_rng(1)
    for M, K, N in [(8, 8, 16), (48, 48, 256), (130, 200, 513)]:
        a = rng.integers(0, 2, size=(M, K)).astype(np.float32)
        b = rng.integers(0, 2, size=(K, N)).astype(np.uint8)
        np.testing.assert_array_equal(ref.gf2_matmul_ref(a, b).numpy(),
                                      np.asarray(ref_ref.gf2_matmul_ref(a, b)))
    g = rng.integers(0, 256, size=(5, 7), dtype=np.uint8)
    d = rng.integers(0, 256, size=(7, 33), dtype=np.uint8)
    np.testing.assert_array_equal(ref.gf256_mul_ref(g[:, :1], d[:1]).numpy(),
                                  np.asarray(ref_ref.gf256_mul_ref(g[:, :1], d[:1])))
    np.testing.assert_array_equal(ref.gf256_matmul_ref(g, d).numpy(),
                                  np.asarray(ref_ref.gf256_matmul_ref(g, d)))
    planes = ref.bytes_to_bitplanes_ref(d)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(ref_ref.bytes_to_bitplanes_ref(d)))
    np.testing.assert_array_equal(ref.bitplanes_to_bytes_ref(planes).numpy(), d)
    np.testing.assert_array_equal(ref.bitplanes_to_bytes_ref(planes).numpy(),
                                  np.asarray(ref_ref.bitplanes_to_bytes_ref(np.asarray(planes))))
    par = rs.cauchy_parity_matrix(12, 7)
    np.testing.assert_array_equal(ref.rs_parity_ref(par, d).numpy(),
                                  np.asarray(ref_ref.rs_parity_ref(par, d)))


def test_ops_equal_reference_ops():
    rng = np.random.default_rng(2)
    n, k = 12, 6
    data = rng.integers(0, 256, size=(k, 200), dtype=np.uint8)
    coded = ops.rs_encode(data, n=n, k=k, device="cpu")
    np.testing.assert_array_equal(
        coded, np.asarray(ref_ops.rs_encode(jnp.asarray(data), n=n, k=k, interpret=True)))
    present = (1, 3, 6, 8, 10, 11)
    rows = torch.from_numpy(coded[list(present)])
    got = ops.rs_decode(rows, n=n, k=k, present=present)  # device from the tensor
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), data)
    payload = rng.integers(0, 256, size=10_001, dtype=np.uint8)
    strips = ops.encode_blob(payload, n=10, k=4, device="cpu")
    np.testing.assert_array_equal(strips, ref_ops.encode_blob(payload, n=10, k=4))
    present = (0, 5, 7, 9)
    np.testing.assert_array_equal(
        ops.decode_blob(strips[list(present)], present, n=10, k=4, payload_len=payload.size,
                        device="cpu"), payload)


@pytest.mark.parametrize("bitmats,data,exc", [
    (torch.zeros(1, 8, 8, dtype=torch.uint8), torch.zeros(1, 1, 4, dtype=torch.int32), TypeError),
    (torch.zeros(1, 8, 8), torch.zeros(1, 1, 4, dtype=torch.uint8), TypeError),
    (np.zeros((1, 8, 8), np.uint8), torch.zeros(1, 1, 4, dtype=torch.uint8), TypeError),
    (torch.zeros(8, 8, dtype=torch.uint8), torch.zeros(1, 4, dtype=torch.uint8), ValueError),
    (torch.zeros(1, 8, 16, dtype=torch.uint8), torch.zeros(1, 1, 4, dtype=torch.uint8), ValueError),
    (torch.zeros(1, 12, 8, dtype=torch.uint8), torch.zeros(1, 1, 4, dtype=torch.uint8), ValueError),
    (torch.zeros(2, 8, 8, dtype=torch.uint8), torch.zeros(1, 1, 4, dtype=torch.uint8), ValueError),
    (torch.zeros(1, 8, 8, dtype=torch.uint8), torch.zeros(1, 1, 8, dtype=torch.uint8)[:, :, ::2],
     ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bitmats, data, exc):
    with pytest.raises(exc):
        gf2_rs_matmul_bytes(bitmats, data)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data = np.zeros((6, 16), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        ops.rs_encode(data, n=12, k=6, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.rs_encode(data, n=12, k=6)  # the default device is the card
