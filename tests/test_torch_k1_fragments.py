"""A numpy model of K1's tensor-core design (``csrc/gf2_rs_bytes.cu``),
register by register, against the reference's Pallas kernel in interpret
mode.

The CUDA kernel runs only on a card. This model reproduces, for every lane
of a warp, the words the kernel puts in its ``mma.sync`` fragments and the
arithmetic it does on them, so that a wrong index map shows here on the CPU:

* A: the item's bit-matrix, packed into the m16n8k32 (and m16n8k16) A
  fragment registers. On the register path (k ≤ 8) mma row
  ``16·mt + 8·h + g`` holds output bits π and π + 4 (π = 2·mt + h) of byte
  row g, as ``(bitmats[8g + π] & 1) + 128·(bitmats[8g + π + 4] & 1)``, two
  m-tiles in all; on the general path (k > 8) it holds bit-row
  ``8·g + j`` (j = 2·mt + h) weighted ``(bitmats & 1) << j``, four m-tiles;
* B: one nibble of one data byte per register, spread to four byte lanes by
  ``* 0x00204081`` — masked to exactly 0/1 per lane on the register path,
  with whatever the upper bits of each lane hold on the general path;
* the s32 block products, with the PTX fragment layouts of m16n8k32 and
  m16n8k16 ``.row.col.s32.u8.u8.s32``;
* the epilogues — ``y = Σ (acc_π & 0x81) << π``, then one shift and mask
  for two columns at once, on the register path; ``v |= acc_j & (1 << j)``
  on the general path — and the column permutation that makes each lane's
  16 output bytes of one row contiguous.

Tolerance: none; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.coding import gf256 as ref_gf256
from repro.kernels.gf2mm import gf2mm as ref_gf2mm

SPREAD = np.uint32(0x00204081)
LANES = np.arange(32)
G, L4 = LANES >> 2, LANES & 3


def step_plan(k: int) -> list[tuple[int, int]]:
    """(first data row, depth in bit-columns) of each mma k-step: k ≤ 8 runs
    k32 steps of 4 data rows and one k16 step for a remainder of 1 or 2 rows
    (the kernel's register path); k > 8 runs k32 steps only (its shared-tile
    path). Rows past k have zero A columns and are never read."""
    if k > 8:
        return [(4 * s, 32) for s in range(-(-k // 4))]
    plan = [(4 * s, 32) for s in range(k // 4)]
    if k % 4 == 3:
        plan.append((4 * (k // 4), 32))
    elif k % 4:
        plan.append((4 * (k // 4), 16))
    return plan


def a_words(bm: np.ndarray, m: int, rg: int, mt: int, t0: int, depth: int,
            pairs: bool) -> np.ndarray:
    """A fragment words (32 lanes, depth // 8) of m-tile mt for the k-step
    that starts at data row t0, for one item's bitmats (8m, 8k)."""
    k8 = bm.shape[1]
    words = np.zeros((32, depth // 8), np.uint32)
    for r in range(depth // 8):
        h, half = r & 1, r >> 1
        j = 2 * mt + h
        for lane in range(32):
            orow = 8 * rg + G[lane]
            if orow >= m:
                continue  # a row past m is zero in A
            for i in range(4):
                kk = 8 * t0 + 16 * half + 4 * L4[lane] + i
                if kk >= k8:
                    continue
                if pairs:
                    entry = (int(bm[8 * orow + j, kk]) & 1) | (int(bm[8 * orow + j + 4, kk]) & 1) << 7
                else:
                    entry = (int(bm[8 * orow + j, kk]) & 1) << j
                words[lane, r] |= np.uint32(entry) << np.uint32(8 * i)
    return words


def chunk_words(data: np.ndarray, t: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Each lane's 16-byte chunk (as 4 little-endian words) of data row t[lane]
    at physical column col[lane]; zero past B and for rows past k."""
    k, B = data.shape
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        if t[lane] >= k:
            continue
        for c in range(16):
            if col[lane] + c < B:
                out[lane, c >> 2] |= np.uint32(data[t[lane], col[lane] + c]) << (8 * (c & 3))
    return out


def b_word(w: np.ndarray, j: int, clean: bool) -> np.ndarray:
    """B register of n-tile j from the lane's chunk words: byte 2j + (g & 1),
    nibble 4·(l4 & 1), spread so bit q0 + i lands in bit 0 of byte lane i
    (and nothing else in the lane when ``clean``)."""
    shift = (8 * (G & 1) + 4 * (L4 & 1) + 16 * (j & 1)).astype(np.uint32)
    b = ((w[:, j >> 1] >> shift) & np.uint32(0xF)) * SPREAD
    return b & np.uint32(0x01010101) if clean else b


def unbytes(word: np.ndarray, i: int) -> np.ndarray:
    return ((word >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.int64)


def mma(a: np.ndarray, b: np.ndarray, depth: int) -> np.ndarray:
    """One m16n8k{depth} u8·u8 → s32 product on fragment registers, in the
    PTX layouts; returns each lane's 4 accumulators (32, 4)."""
    A = np.zeros((16, depth), np.int64)
    Bm = np.zeros((depth, 8), np.int64)
    for lane in range(32):
        g, l4 = G[lane], L4[lane]
        for r in range(depth // 8):  # A: row g + 8(r & 1), k 4·l4 + i + 16(r >> 1)
            for i in range(4):
                A[g + 8 * (r & 1), 4 * l4 + i + 16 * (r >> 1)] = unbytes(a[lane, r], i)
        for r in range(depth // 16):  # B: k 4·l4 + i + 16r, column g
            for i in range(4):
                Bm[4 * l4 + i + 16 * r, g] = unbytes(b[lane, r], i)
    D = A @ Bm
    assert D.max() < 2**31
    return np.stack([D[G + 8 * (i >> 1), 2 * L4 + (i & 1)] for i in range(4)], axis=1)


def epilogue(acc: np.ndarray, pairs: bool) -> list[np.ndarray]:
    """The two output bytes (columns 2·l4 and 2·l4 + 1) of every lane from
    its n-tile accumulators acc (m-tiles, 32, 4)."""
    if not pairs:  # one AND-OR per accumulator
        return [np.bitwise_or.reduce([acc[mt, :, 2 * h + e] & (1 << (2 * mt + h))
                                      for mt in range(4) for h in range(2)]) for e in range(2)]
    y = [sum((acc[mt, :, 2 * h + e] & 0x81) << (2 * mt + h) for mt in range(2) for h in range(2))
         for e in range(2)]
    w2 = y[0] | (y[1] << 16)
    z = (w2 & 0x000F000F) | ((w2 >> 3) & 0x00F000F0)
    return [z & 0xFF, (z >> 16) & 0xFF]


def model_k1(bitmats: np.ndarray, data: np.ndarray) -> np.ndarray:
    """K1 as the kernel computes it, warp chunk by warp chunk of 64 columns."""
    batch, m8, _ = bitmats.shape
    _, k, B = data.shape
    m = m8 // 8
    out = np.zeros((batch, m, B), np.uint8)
    plan = step_plan(k)
    pairs = k <= 8  # the register path
    mts = 2 if pairs else 4
    for item in range(batch):
        for rg in range(-(-m // 8)):
            afr = {(mt, s): a_words(bitmats[item], m, rg, mt, t0, depth, pairs)
                   for mt in range(mts) for s, (t0, depth) in enumerate(plan)}
            for col0 in range(0, B, 64):
                o = np.zeros((32, 4), np.uint32)
                for j in range(8):
                    acc = np.zeros((mts, 32, 4), np.int64)
                    for s, (t0, depth) in enumerate(plan):
                        # B rows of this step: lane holds data rows t0 + l4 // 2 (+ 2)
                        b = np.stack([b_word(chunk_words(data[item], t0 + (L4 >> 1) + 2 * r,
                                                         col0 + 16 * (G >> 1)), j, pairs)
                                      for r in range(depth // 16)], axis=1)
                        for mt in range(mts):
                            acc[mt] += mma(afr[mt, s], b, depth)
                    for e, v in enumerate(epilogue(acc, pairs)):
                        assert v.max() < 256
                        o[:, j >> 1] |= v.astype(np.uint32) << np.uint32(8 * (2 * (j & 1) + e))
                for lane in range(32):  # one 16-byte store: row g, columns 16·l4 ...
                    orow = 8 * rg + G[lane]
                    for c in range(16):
                        col = col0 + 16 * L4[lane] + c
                        if orow < m and col < B:
                            out[item, orow, col] = unbytes(o[lane:lane + 1, c >> 2], c & 3)[0]
    return out


def test_nibble_spread_puts_each_bit_in_bit_0_of_its_lane():
    x = np.arange(256, dtype=np.uint32)
    for q0 in (0, 4):
        spread = ((x >> np.uint32(q0)) & np.uint32(0xF)) * SPREAD
        for i in range(4):
            np.testing.assert_array_equal((spread >> np.uint32(8 * i)) & 1, (x >> (q0 + i)) & 1)
        assert (spread & np.uint32(0xFEFEFEFE)).any()  # the upper bits of a lane are not zero


def test_column_permutation_gives_each_lane_16_contiguous_bytes():
    cols = {(int(l4), 2 * j + e): 16 * int(l4) + 2 * j + e
            for l4 in range(4) for j in range(8) for e in range(2)}
    assert sorted(cols.values()) == list(range(64))
    # the B lane of column n = g reads the byte the C lane of that column writes
    for g in range(8):
        for j in range(8):
            assert 16 * (g >> 1) + 2 * j + (g & 1) == cols[(g >> 1, 2 * j + (g & 1))]


def test_paired_rows_keep_their_counts_apart_at_the_largest_sum():
    """k = 8, every entry 1 and every data bit 1: each row's count is 64,
    the largest the register path meets; it must stay below bit 7."""
    bitmats = np.ones((1, 64, 64), np.uint8)
    data = np.full((1, 8, 64), 0xFF, np.uint8)
    want = np.asarray(ref_gf2mm.gf2_rs_matmul_bytes(jnp.asarray(bitmats), jnp.asarray(data),
                                                    interpret=True))
    np.testing.assert_array_equal(model_k1(bitmats, data), want)


@pytest.mark.parametrize("k,m8,B,batch", [
    (1, 8, 57, 1),
    (2, 64, 130, 1),
    (3, 48, 64, 2),
    (4, 136, 65, 1),
    (5, 64, 200, 1),
    (6, 64, 129, 2),
    (7, 8, 63, 1),
    (8, 72, 70, 1),
    (9, 64, 100, 1),
])
def test_model_equals_reference_pallas_kernel(k, m8, B, batch):
    rng = np.random.default_rng(100 * k + m8 + B)
    if m8 % 16:  # random entries: only the lowest bit may count
        bitmats = rng.integers(0, 256, (batch, m8, 8 * k), dtype=np.uint8)
    else:  # GF(2) expansions of random GF(256) coding matrices
        bitmats = ref_gf256.expand_bitmatrix_batched(
            rng.integers(0, 256, (batch, m8 // 8, k), dtype=np.uint8))
    data = rng.integers(0, 256, (batch, k, B), dtype=np.uint8)
    want = np.asarray(ref_gf2mm.gf2_rs_matmul_bytes(jnp.asarray(bitmats & 1), jnp.asarray(data),
                                                    interpret=True))
    np.testing.assert_array_equal(model_k1(bitmats, data), want)


def test_ablation_anchors_are_in_the_kernel_source():
    """k1_ablation.py removes phases by text substitution; every anchor it
    needs must be in the kernel source, once per site it edits."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import k1_ablation

    text = open(k1_ablation.SOURCE).read()
    for name, subs in k1_ablation.VARIANTS.items():
        src = k1_ablation.variant_source(text, subs)
        assert (src == text) == (name == "full"), name
