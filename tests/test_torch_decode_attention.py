"""The decode attention's wrapper (``kernels/attention/decode_attention.py``)
on the CPU: its input checks raise before any launch, its plain version is
the port's decode attention as it was before the kernel, bit for bit, on the
smoke configs of every family that decodes through it, and its cut of each
published decode shape fits one H100 block. The kernel itself runs only on
a card (``tests/test_torch_decode_attention_cuda.py``)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import decode_attention as da
from repro_torch.models import get
from repro_torch.models import layers as ly


def _before_the_kernel(params, cfg, x, cache_k, cache_v, slot_pos, pos, window=None):
    """``models.layers.decode_attention`` as it was written before the
    kernel, kept here verbatim as the yardstick of its CPU path."""
    B = x.shape[0]
    hd = cfg.hd
    positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
    q, k_new, v_new = ly._project_qkv(params, cfg, x, positions)
    Smax = cache_k.shape[1]
    slot = torch.remainder(pos, Smax).reshape(1).to(torch.int64)
    cache_k.index_copy_(1, slot, k_new)
    cache_v.index_copy_(1, slot, v_new)
    slot_pos.index_copy_(0, slot, pos.reshape(1).to(slot_pos.dtype))
    Hkv, G = cfg.n_kv_heads, cfg.q_per_kv
    qh = q.reshape(B, 1, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.to(torch.float32), cache_k.to(torch.float32))
    s = (cfg.attn_softcap * torch.tanh(s / math.sqrt(hd) / cfg.attn_softcap)
         if cfg.attn_softcap else s / math.sqrt(hd))
    mask = (slot_pos <= pos) & (slot_pos >= 0)
    if window is not None:
        mask &= slot_pos > pos - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cache_v.dtype), cache_v)
    return o.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]


def _ring(Smax: int, pos: int, empty=()) -> np.ndarray:
    """slot_pos of a ring after positions 0..pos-1: slot s holds the latest
    position ≡ s (mod Smax) below pos, or none yet; ``empty`` slots hold none."""
    sp = np.full(Smax, ly.EMPTY_POS, np.int32)
    for p in range(max(0, pos - Smax), pos):
        sp[p % Smax] = p
    sp[list(empty)] = ly.EMPTY_POS
    return sp


#: (model, window) of every family that decodes through it: the dense family
#: with a window and a softcap (gemma2), zamba2's shared attention over its
#: local window, Nemotron's NoPE GQA, whisper's decoder self-attention
MODELS = [("gemma2-2b", 8), ("gemma2-2b", None), ("zamba2-2.7b", 8),
          ("nemotron3-nano-30b-a3b", None), ("whisper-base", None), ("yi-6b", 5)]
#: (Smax, pos, empty slots): a ring that has wrapped, the first token, and a
#: cache with slots never written
RINGS = [(8, 19, (5,)), (8, 0, ()), (12, 4, (1, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ring", RINGS, ids=["wrapped", "pos0", "empty"])
@pytest.mark.parametrize("model,window", MODELS)
def test_cpu_path_equals_the_decode_attention_before_the_kernel(model, window, ring, dtype):
    cfg = dataclasses.replace(get(model, smoke=True).cfg,
                              dtype={torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype])
    gen = torch.Generator().manual_seed(3)
    params = ly.init_attention(gen, cfg)
    Smax, pos, empty = ring
    B = 3
    x = torch.randn((B, 1, cfg.d_model), generator=gen).to(dtype)
    cache = [torch.randn((B, Smax, cfg.n_kv_heads, cfg.hd), generator=gen).to(dtype)
             for _ in range(2)] + [torch.from_numpy(_ring(Smax, pos, empty))]
    want_cache = [t.clone() for t in cache]
    p = torch.tensor(pos, dtype=torch.int32)
    want = _before_the_kernel(params, cfg, x, *want_cache, p, window)
    launches = da.decode_attention.launches
    got = ly.decode_attention(params, cfg, x, *cache, p, window=window)
    assert da.decode_attention.launches == launches  # the CPU runs the plain version
    assert got.dtype == want.dtype and torch.equal(got, want)
    for g, w in zip(cache, want_cache):
        assert torch.equal(g, w)


def test_plain_version_takes_an_out_and_sixteen_heads_a_kv_head():
    """Nemotron's published grouping (16 query heads a KV head of 128) at a
    small batch and ring, through ``out``."""
    gen = torch.Generator().manual_seed(4)
    B, Smax, Hkv, G, hd = 2, 24, 2, 16, 128
    q = torch.randn((B, Hkv * G, hd), generator=gen).bfloat16()
    ck, cv = (torch.randn((B, Smax, Hkv, hd), generator=gen).bfloat16() for _ in range(2))
    sp = torch.from_numpy(_ring(Smax, 30, (3,)))
    pos = torch.tensor(29, dtype=torch.int32)
    out = torch.empty_like(q)
    got = da.decode_attention(q, ck, cv, sp, pos, out=out)
    assert got is out
    s = torch.einsum("bhgd,bkhd->bhgk", q.float().reshape(B, Hkv, G, hd), ck.float())
    s = torch.where((sp >= 0) & (sp <= pos), s / math.sqrt(hd), da.MASKED)
    p = torch.softmax(s, dim=-1).bfloat16()
    want = torch.einsum("bhgk,bkhd->bhgd", p, cv).reshape(B, Hkv * G, hd)
    assert torch.equal(got, want)


def _valid(device="meta", **over):
    """Inputs the wrapper takes: q (2, 8, 16), caches (2, 6, 4, 16) bfloat16,
    slot_pos (6,) and pos () int32, on ``device`` (``meta``: shapes and
    dtypes, no storage)."""
    B, Smax, Hkv, H, hd = (over.pop(k, d) for k, d in
                           (("B", 2), ("Smax", 6), ("Hkv", 4), ("H", 8), ("hd", 16)))
    args = {"q": torch.empty((B, H, hd), dtype=torch.bfloat16, device=device),
            "cache_k": torch.empty((B, Smax, Hkv, hd), dtype=torch.bfloat16, device=device),
            "cache_v": torch.empty((B, Smax, Hkv, hd), dtype=torch.bfloat16, device=device),
            "slot_pos": torch.empty((Smax,), dtype=torch.int32, device=device),
            "pos": torch.empty((), dtype=torch.int32, device=device)}
    args.update(over)
    return args


#: (case, inputs, error, message) — each one fault in otherwise valid inputs
BAD = {
    "float16": (lambda: _valid(**{k: torch.empty((2, 6, 4, 16), dtype=torch.float16,
                                                  device="meta") for k in ("cache_k",
                                                                           "cache_v")}),
                TypeError, "share one dtype"),
    "q_dtype_unlike_the_cache": (lambda: _valid(q=torch.empty((2, 8, 16), device="meta")),
                                 TypeError, "share one dtype"),
    "slot_pos_int64": (lambda: _valid(slot_pos=torch.empty((6,), dtype=torch.int64,
                                                           device="meta")),
                       TypeError, "slot_pos must be int32"),
    "pos_int64": (lambda: _valid(pos=torch.empty((), dtype=torch.int64, device="meta")),
                  TypeError, "pos must be int32"),
    "pos_a_python_int": (lambda: _valid(pos=5), TypeError, "pos must be a torch.Tensor"),
    "cache_not_contiguous": (lambda: _valid(cache_k=torch.empty(
        (2, 4, 6, 16), dtype=torch.bfloat16, device="meta").transpose(1, 2)),
        ValueError, "cache_k must be contiguous"),
    "heads_not_a_multiple": (lambda: _valid(H=6), ValueError, "multiple of the cache's 4 KV"),
    "q_batch_unlike_the_cache": (lambda: _valid(q=torch.empty((3, 8, 16), dtype=torch.bfloat16,
                                                              device="meta")),
                                 ValueError, "q must be"),
    "hd_12": (lambda: _valid(hd=12), ValueError, "multiple of 8 from 8 to 256"),
    "hd_264": (lambda: _valid(hd=264), ValueError, "multiple of 8 from 8 to 256"),
    "slot_pos_short": (lambda: _valid(slot_pos=torch.empty((5,), dtype=torch.int32,
                                                           device="meta")),
                       ValueError, "slot_pos must be"),
    "host_pos": (lambda: _valid(pos=torch.tensor(3, dtype=torch.int32)), ValueError,
                 "one device"),
    "window_0": (lambda: {**_valid(), "window": 0}, ValueError, "window"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_checks_raise_before_any_launch(case, monkeypatch):
    make, error, message = BAD[case]

    def no_launch():
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(da, "_launcher", no_launch)
    launches = da.decode_attention.launches
    with pytest.raises(error, match=message):
        da.decode_attention(**make())
    assert da.decode_attention.launches == launches


def test_meta_tensors_take_the_plain_version():
    """The launch plan runs the decode step on ``meta`` tensors to count its
    work: shapes and dtype come out, and nothing is launched."""
    launches = da.decode_attention.launches
    out = da.decode_attention(**_valid(), window=4, softcap=50.0)
    assert out.device.type == "meta" and out.shape == (2, 8, 16) and out.dtype == torch.bfloat16
    assert da.decode_attention.launches == launches


#: (blocks = B · Hkv, Smax, G, hd, itemsize) of the cells' and published
#: configs' decode: zamba2 batch and chat, Nemotron, gemma2's window at four
#: rows, qwen and grok at eight, mistral-nemo, whisper, the smoke configs
#: (hd 16, float32 too), and rows too long for one block's scores
SHAPES = [(1024, 192, 1, 80, 2), (1024, 1056, 1, 80, 2), (128, 640, 16, 128, 2),
          (16, 4096, 2, 256, 2), (128, 1056, 1, 64, 2), (64, 4096, 6, 128, 2),
          (8, 4096, 4, 128, 2), (256, 448, 1, 64, 2), (6, 27, 1, 16, 2), (6, 27, 2, 16, 4),
          (1024, 32768, 16, 256, 4), (1, 1, 1, 8, 4), (8, 100000, 8, 128, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_one_block(shape):
    blocks, Smax, G, hd, itemsize = shape
    cut = da.plan(*shape, 132)
    assert cut.gt == (1 if G <= 4 else 8) and cut.gp % cut.gt == 0 and G <= cut.gp < G + cut.gt
    assert cut.chunk * cut.n_split >= Smax > cut.chunk * (cut.n_split - 1)
    assert cut.n_split == 1 or cut.chunk % cut.ts == 0
    # a row is split only where the blocks fill under half the card or its scores need it
    assert cut.n_split == 1 or 2 * blocks < 132 or cut.smem[0] > da.SMEM_MAX
    assert cut.rs % 16 == 0 and hd * itemsize <= cut.rs < hd * itemsize + 128
    assert cut.dp & (cut.dp - 1) == 0 and cut.dp <= 32 and cut.ts % 2 == 0
    assert cut.dp * cut.ts // 2 * (cut.gp // cut.gt) <= da.THREADS
    assert (hd * itemsize // 16) * (cut.gp // cut.gt) <= da.THREADS
    used = cut.smem[:1] if cut.n_split == 1 else cut.smem[1:]
    assert max(used) <= da.SMEM_MAX


def test_plan_splits_a_row_where_the_pairs_leave_the_card_idle():
    """The cells' shapes run whole; gemma2's window at four rows (16 pairs)
    runs in 16 chunks of 256 slots."""
    assert da.plan(1024, 192, 1, 80, 2, 132).n_split == 1
    assert da.plan(1024, 1056, 1, 80, 2, 132).n_split == 1
    assert da.plan(128, 640, 16, 128, 2, 132).n_split == 1
    assert da.plan(16, 4096, 2, 256, 2, 132)[-3:-1] == (256, 16)


def test_plan_refuses_what_one_block_cannot_hold():
    with pytest.raises(ValueError, match="threads can sum"):
        da.plan(1, 64, 128, 256, 4, 132)


def test_counts_read_the_cache_once():
    """A zamba2 batch site: K and V (31.5 MB each) read once, q and the
    output once, slot_pos and pos."""
    ops, nbytes = da.attention_counts(32, 32, 32, 192, 80, 2)
    assert nbytes == 2 * 32 * 192 * 32 * 80 * 2 + 2 * 32 * 32 * 80 * 2 + 4 * 192 + 4
    assert ops == 4 * 32 * 32 * 192 * 80
