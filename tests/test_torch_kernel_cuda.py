"""K1 and K2 (the CUDA kernels behind ``gf2_rs_matmul_bytes`` and
``gf2_matmul``) on the card, against their plain PyTorch versions. Each test is marked ``cuda`` and skips where no
CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.coding import gf256, rs
from repro_torch.coding.codec import Codec
from repro_torch.kernels.gf2mm import gf2mm
from repro_torch.kernels.gf2mm.gf2mm import gf2_matmul, gf2_rs_matmul_bytes
from repro_torch.kernels.gf2mm.ref import gf2_matmul_ref, gf2_rs_matmul_bytes_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(rng, batch, m, k, B, device):
    mats = rng.integers(0, 256, (batch, m, k), dtype=np.uint8)
    bitmats = torch.from_numpy(gf256.expand_bitmatrix_batched(mats)).to(device)
    data = torch.from_numpy(rng.integers(0, 256, (batch, k, B), dtype=np.uint8)).to(device)
    return bitmats, data


# The tensor-core kernel's paths: k <= 8 holds A in registers with k32 steps
# and a k16 step for k % 4 in {1, 2} (a short k32 step for k % 4 == 3);
# k > 8 reads A from a shared tile. m not a multiple of 8 leaves rows of A
# zero and their stores skipped; B % 64 != 0 masks the last warp step, and
# B % 16 != 0 takes the byte-wise loads and stores.
@pytest.mark.parametrize("batch,m,k,B", [
    (1, 1, 1, 1),
    (3, 6, 6, 1001),       # ragged B: byte-wise edge everywhere
    (2, 17, 3, 4101),      # m not a multiple of the 8-row tile, partial column block
    (4, 8, 6, 16384),      # aligned: 16-byte loads and stores
    (2, 128, 256, 4096),   # k = 256, the field's limit
    (1, 256, 16, 160),     # 32 row tiles
    (2, 8, 1, 520),
    (2, 8, 2, 64),
    (2, 8, 3, 65),
    (2, 8, 4, 520),
    (2, 8, 5, 63),
    (2, 8, 7, 520),
    (2, 8, 8, 65),
    (2, 9, 9, 64),
    (1, 9, 33, 520),
    (3, 1, 6, 64),
    (2, 9, 6, 63),
    (2, 17, 6, 520),
    (128, 8, 6, 4160),     # the write path's batch at a small B, two column blocks
])
def test_k1_matches_plain_version(cuda, batch, m, k, B):
    rng = np.random.default_rng(batch * 1000 + m * 10 + k)
    bitmats, data = _case(rng, batch, m, k, B, cuda)
    before = gf2_rs_matmul_bytes.launches
    got = gf2_rs_matmul_bytes(bitmats, data)
    torch.cuda.synchronize()
    assert gf2_rs_matmul_bytes.launches == before + 1
    assert torch.equal(got, gf2_rs_matmul_bytes_ref(bitmats, data))


def test_k1_misaligned_data_pointer(cuda):
    """A contiguous view at an odd storage offset takes the byte-wise path."""
    rng = np.random.default_rng(7)
    bitmats, data = _case(rng, 2, 8, 6, 2048, cuda)
    buf = torch.empty(data.numel() + 1, dtype=torch.uint8, device=cuda)
    view = buf[1:].view(data.shape)
    view.copy_(data)
    assert view.is_contiguous() and view.data_ptr() % 16 == 1
    got = gf2_rs_matmul_bytes(bitmats, view)
    assert torch.equal(got, gf2_rs_matmul_bytes_ref(bitmats, data))


@pytest.mark.parametrize("k", [6, 9])
def test_k1_misaligned_out_pointer(cuda, k):
    """out one byte into a flat buffer, through the C entry point (the
    wrapper allocates its own aligned out): the byte-wise stores, and not a
    byte written outside out."""
    rng = np.random.default_rng(10 + k)
    bitmats, data = _case(rng, 2, 8, k, 2048, cuda)
    want = gf2_rs_matmul_bytes_ref(bitmats, data)
    obuf = torch.zeros(want.numel() + 2, dtype=torch.uint8, device=cuda)
    out = obuf[1:-1].view(want.shape)
    assert out.data_ptr() % 16 == 1
    gf2mm._launch("gf2_rs_bytes", bitmats.data_ptr(), data.data_ptr(), out.data_ptr(), 2, 64, k,
                  2048)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and int(obuf[0]) == 0 and int(obuf[-1]) == 0


def test_k1_zero_data_rows_give_zero_rows(cuda):
    """k = 0: an empty XOR, every output byte zero."""
    bitmats = torch.zeros((2, 16, 0), dtype=torch.uint8, device=cuda)
    data = torch.zeros((2, 0, 100), dtype=torch.uint8, device=cuda)
    got = gf2_rs_matmul_bytes(bitmats, data)
    assert got.shape == (2, 2, 100) and not got.any()
    assert torch.equal(got, gf2_rs_matmul_bytes_ref(bitmats, data))


def test_k1_counts_entries_by_lowest_bit(cuda):
    """bitmats entries other than 0/1 count by their lowest bit, like the
    plain version's exact float32 sums reduced mod 2."""
    rng = np.random.default_rng(8)
    _, data = _case(rng, 2, 8, 6, 512, cuda)
    bitmats = torch.from_numpy(rng.integers(0, 256, (2, 64, 48), dtype=np.uint8)).to(cuda)
    got = gf2_rs_matmul_bytes(bitmats, data)
    assert torch.equal(got, gf2_rs_matmul_bytes_ref(bitmats, data))


def test_kernel_codec_on_card_matches_numpy_oracle(cuda):
    rng = np.random.default_rng(9)
    c = Codec("kernel", device=cuda)
    for n, k in [(2, 1), (12, 6), (5, 4)]:
        data = rng.integers(0, 256, (3, k, 777), dtype=np.uint8)
        want = np.stack([rs.encode(data[i], n, k) for i in range(3)])
        np.testing.assert_array_equal(c.encode(data, n, k), want)
        present = np.stack([np.sort(rng.permutation(n)[:k]) for _ in range(3)])
        rows = torch.from_numpy(np.stack([want[i][present[i]] for i in range(3)])).to(cuda)
        got = c.decode(rows, present, n, k)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(), data)


# K2 at the cases chip_smoke.py checks — the (12, 6) code's parity
# bit-matrix over the bitplanes of one 3 MiB object, a (256, 128) code over
# 64 KiB strips, a shape ragged on every dimension in two input dtypes — and
# at the tensor-core kernel's edges: K not a multiple of 16, 32 or the
# 128-deep k-tile, a deep K over 32 k-tiles, M of 1, 17 and 48 rows of one
# 128-row block, N = 513 (byte-wise B and out), K = 0, and entries beyond
# 0/1 that count by their lowest bit (int8 in -3..3, uint8 in 0..255).
@pytest.mark.parametrize("M,K,N,dtype,lo,hi", [
    (48, 48, 524_288, torch.uint8, 0, 2),
    (1024, 1024, 65_536, torch.uint8, 0, 2),
    (130, 200, 513, torch.int8, 0, 2),
    (130, 200, 513, torch.float32, 0, 2),
    (64, 33, 1024, torch.uint8, 0, 2),
    (100, 200, 4096, torch.uint8, 0, 2),
    (64, 4096, 4096, torch.uint8, 0, 2),
    (1, 256, 2048, torch.uint8, 0, 2),
    (17, 96, 640, torch.uint8, 0, 2),
    (48, 48, 8192, torch.uint8, 0, 2),
    (40, 64, 513, torch.uint8, 0, 2),
    (5, 0, 100, torch.uint8, 0, 2),
    (130, 200, 513, torch.int8, -3, 4),
    (96, 256, 2048, torch.int8, -3, 4),
    (130, 200, 513, torch.uint8, 0, 256),
    (96, 256, 2048, torch.uint8, 0, 256),
])
def test_k2_matches_plain_version(cuda, M, K, N, dtype, lo, hi):
    g = torch.Generator(device=cuda).manual_seed(M + K + N + lo)
    a = torch.randint(lo, hi, (M, K), generator=g, device=cuda).to(dtype)
    b = torch.randint(lo, hi, (K, N), generator=g, device=cuda).to(dtype)
    before = gf2_matmul.launches
    got = gf2_matmul(a, b)
    torch.cuda.synchronize()
    assert gf2_matmul.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == (M, N)
    assert torch.equal(got, gf2_matmul_ref(a, b).to(torch.uint8))


def test_k2_transposed_view_and_out_dtype(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randint(0, 2, (96, 320), generator=g, device=cuda, dtype=torch.uint8)
    bt = torch.randint(0, 2, (640, 320), generator=g, device=cuda, dtype=torch.uint8)
    before = gf2_matmul.launches
    got = gf2_matmul(a, bt.T, out_dtype=torch.int32)
    assert gf2_matmul.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, gf2_matmul_ref(a, bt.T))


@pytest.mark.parametrize("M,K,N", [(48, 48, 4096), (130, 200, 1024)])
def test_k2_misaligned_pointers(cuda, M, K, N):
    """B as a contiguous (K, N) view one byte into a flat buffer, through the
    wrapper; then B and out both one byte in, through the C entry point (the
    wrapper allocates its own aligned out). Both take the byte-wise path."""
    g = torch.Generator(device=cuda).manual_seed(11 + K)
    a = torch.randint(0, 2, (M, K), generator=g, device=cuda, dtype=torch.uint8)
    b = torch.randint(0, 2, (K, N), generator=g, device=cuda, dtype=torch.uint8)
    want = gf2_matmul_ref(a, b).to(torch.uint8)
    buf = torch.empty(K * N + 1, dtype=torch.uint8, device=cuda)
    view = buf[1:].view(K, N)
    view.copy_(b)
    assert view.is_contiguous() and view.data_ptr() % 16 == 1
    before = gf2_matmul.launches
    got = gf2_matmul(a, view)
    torch.cuda.synchronize()
    assert gf2_matmul.launches == before + 1
    assert torch.equal(got, want)
    obuf = torch.zeros(M * N + 1, dtype=torch.uint8, device=cuda)
    out = obuf[1:].view(M, N)
    assert out.data_ptr() % 16 == 1
    gf2mm._launch("gf2_matmul", a.data_ptr(), view.data_ptr(), out.data_ptr(), M, K, N)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and int(obuf[0]) == 0
