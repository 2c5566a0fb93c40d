"""The decode attention's kernel (``kernels/attention/csrc/decode_attention.cu``)
on the card against its plain version run there. Each test is marked
``cuda`` and skips where no CUDA card is present; the file imports neither
jax nor the reference package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_attention_cuda.py

The kernel keeps the plain version's rounding points (float32 scores, an
exact float32 softmax, p rounded to the cache's dtype, a float32 P·V rounded
once) and sums in another order. Both are held to the float64 P·V of the
plain version's own rounded p: the kernel's distance from it may be at most
twice the plain version's largest (the output's last rounding can go the
other way at a near tie) plus Smax · 2⁻²⁴ · Σₛ |pₛ vₛ|, the bound of any
order of a float32 sum of Smax terms. Shapes: zamba2-2.7b's batch and chat
sites, Nemotron-3-Nano's GQA layer (16 query heads a KV head), gemma2's
window with its softcap over a ring that has wrapped, a cache with empty
slots and a window that masks some, the first token (pos 0), and a float32
smoke shape."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import decode_attention as da

pytestmark = pytest.mark.cuda

EMPTY = -(2**30)
#: name -> (B, Smax, Hkv, G, hd, dtype, pos, empty slots, window, softcap)
SHAPES = {
    "zamba2_batch": (32, 192, 32, 1, 80, torch.bfloat16, 191, 0, 4096, None),
    "zamba2_chat": (32, 1056, 32, 1, 80, torch.bfloat16, 1055, 0, 4096, None),
    "nemotron": (64, 640, 2, 16, 128, torch.bfloat16, 639, 0, None, None),
    "gemma2_wrapped": (2, 4096, 4, 2, 256, torch.bfloat16, 5000, 0, 4096, 50.0),
    "empty_slots": (4, 300, 8, 4, 128, torch.bfloat16, 100, 40, 80, None),
    "pos0": (8, 64, 4, 2, 64, torch.bfloat16, 0, 0, None, None),
    "float32_smoke": (3, 27, 2, 2, 16, torch.float32, 30, 0, 8, 30.0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    """q (B, H, hd), the caches, slot_pos of a ring after positions
    0..pos (``empty`` of its written slots cleared again), pos on the device."""
    B, Smax, Hkv, G, hd, dtype, pos, empty, window, cap = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Hkv * G, hd), generator=g, device=device).to(dtype)
    ck, cv = (torch.randn((B, Smax, Hkv, hd), generator=g, device=device).to(dtype)
              for _ in range(2))
    sp = np.full(Smax, EMPTY, np.int32)
    for p in range(max(0, pos + 1 - Smax), pos + 1):
        sp[p % Smax] = p
    written = np.flatnonzero(sp >= 0)
    sp[np.random.default_rng(seed).choice(written[written != pos % Smax], empty,
                                          replace=False)] = EMPTY
    slot_pos = torch.from_numpy(sp).to(device)
    return q, ck, cv, slot_pos, torch.tensor(pos, dtype=torch.int32, device=device)


def _rounded_p(q, ck, slot_pos, pos, window, cap):
    """The plain version's p, rounded to the cache's dtype, on the card."""
    B, H, hd = q.shape
    Hkv = ck.shape[2]
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, H // Hkv, hd).float(), ck.float())
    s = da.tanh_cap(s / math.sqrt(hd), cap)
    mask = (slot_pos <= pos) & (slot_pos >= 0)
    if window is not None:
        mask &= slot_pos > pos - window
    return torch.softmax(torch.where(mask, s, da.MASKED), dim=-1).to(ck.dtype)


def _errors(got, want_p, cv):
    """(largest |got − o64|, o64's float32 order bound per element): o64 the
    float64 P·V of the plain version's rounded p."""
    B, H, hd = got.shape
    Hkv = cv.shape[2]
    terms = want_p.double()[..., None] * cv.double().permute(0, 2, 1, 3)[:, :, None]
    o64 = terms.sum(dim=3).reshape(B, H, hd)
    order = cv.shape[1] * 2.0 ** -24 * terms.abs().sum(dim=3).reshape(B, H, hd)
    return (got.double() - o64).abs(), order


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_holds_to_the_plain_version(cuda, name):
    shape = SHAPES[name]
    window, cap = shape[-2:]
    q, ck, cv, sp, pos = _inputs(shape, cuda)
    launches = da.decode_attention.launches
    got = da.decode_attention(q, ck, cv, sp, pos, window=window, softcap=cap)
    assert da.decode_attention.launches == launches + 1
    plain = da.decode_attention_plain(q, ck, cv, sp, pos, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    p = _rounded_p(q, ck, sp, pos, window, cap)
    err, order = _errors(got, p, cv)
    plain_err, _ = _errors(plain, p, cv)
    bound = 2 * plain_err.max() + order
    assert bool((err <= bound).all()), (float(err.max()), float(plain_err.max()))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("name", ["zamba2_chat", "nemotron", "zamba2_batch"])
def test_kernel_allocates_no_copy_of_the_cache(cuda, name):
    """Around the call the allocator's peak grows by the output and the
    split path's float32 scratch (scores and partial outputs) alone; the
    plain version's grows by more than the cache."""
    shape = SHAPES[name]
    q, ck, cv, sp, pos = _inputs(shape, cuda)
    B, Smax, Hkv, hd = ck.shape
    cut = da.plan(B * Hkv, Smax, q.shape[1] // Hkv, hd, q.element_size(),
                  torch.cuda.get_device_properties(cuda).multi_processor_count)
    scratch = (4 * B * q.shape[1] * (Smax + cut.n_split * hd)) if cut.n_split > 1 else 0
    cache_bytes = ck.numel() * ck.element_size()

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - base
        del out
        return grown

    kernel = peak(lambda: da.decode_attention(q, ck, cv, sp, pos, window=shape[-2]))
    plain = peak(lambda: da.decode_attention_plain(q, ck, cv, sp, pos, window=shape[-2]))
    assert kernel <= q.numel() * q.element_size() + scratch + 3 * 512, kernel
    assert kernel < cache_bytes and plain > cache_bytes, (kernel, plain, cache_bytes)


def test_replayed_from_a_graph_it_reads_pos_and_the_cache_on_the_device(cuda):
    """Captured once, replayed after the inputs change in place (a new
    token's q, K, V and slot, and pos): each replay equals an eager call on
    the same inputs; no call syncs with the host."""
    shape = SHAPES["nemotron"][:6] + (300, 0, None, None)
    q, ck, cv, sp, pos = _inputs(shape, cuda)
    out = torch.empty_like(q)
    g = torch.Generator(device=cuda).manual_seed(9)
    replayed, eager = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        da.decode_attention(q, ck, cv, sp, pos, out=out)
        graph = torch.cuda.CUDAGraph()
        launches = da.decode_attention.launches
        with torch.cuda.graph(graph):
            da.decode_attention(q, ck, cv, sp, pos, out=out)
        captured = da.decode_attention.launches - launches
        for slot in range(301, 304):
            q.copy_(torch.randn(q.shape, generator=g, device=cuda))
            ck[:, slot].copy_(torch.randn(ck[:, slot].shape, generator=g, device=cuda))
            cv[:, slot].copy_(torch.randn(cv[:, slot].shape, generator=g, device=cuda))
            sp[slot:slot + 1].fill_(slot)
            pos.fill_(slot)
            graph.replay()
            replayed.append(out.clone())
            eager.append(da.decode_attention(q, ck, cv, sp, pos))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert captured == 1 and da.decode_attention.launches == launches + 4
    for step, (a, b) in enumerate(zip(replayed, eager)):
        assert torch.equal(a, b), step
