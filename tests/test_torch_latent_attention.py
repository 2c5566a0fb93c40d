"""The latent attention wrapper (MLA's absorbed decode attention) on the CPU:
its plain version against a frozen copy of the attention body that
``models/mla.py::absorbed_attention`` ran before the kernel, bit for bit; the
input checks; the kernel's plan and its cut of the slots. The kernel itself
runs only on a card (``tests/test_torch_latent_attention_cuda.py``)."""

import dataclasses

import pytest
import torch

from repro_torch.kernels.attention import latent_attention as la
from repro_torch.kernels.attention.decode_attention import MASKED
from repro_torch.models import get, mla
from repro_torch.kernels.products import bmm_f32

CPU = torch.device("cpu")


def _frozen_body(q, latent, valid, scale, kvr):
    """absorbed_attention's body from the scores through P·c_kv, as it was."""
    s = bmm_f32(q, latent.transpose(1, 2))
    s = s.mul_(scale).masked_fill_(~valid, MASKED)
    p = torch.softmax(s, dim=-1)
    return bmm_f32(p.to(latent.dtype), latent[..., :kvr]).to(latent.dtype)


def _frozen_absorbed(params, cfg, q_nope, q_pe, latent, valid):
    H, dn, kvr = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_kv_rank
    w = params["wkv_b"].view(kvr, H, -1)
    w_uk = w[:, :, :dn].permute(1, 2, 0)
    w_uv = w[:, :, dn:].transpose(0, 1)
    q_lat = bmm_f32(q_nope.transpose(0, 1), w_uk).to(latent.dtype).transpose(0, 1)
    s = bmm_f32(torch.cat([q_lat, q_pe.to(latent.dtype)], dim=-1), latent.transpose(1, 2))
    s = s.mul_(mla.softmax_scale(cfg)).masked_fill_(~valid, MASKED)
    p = torch.softmax(s, dim=-1)
    o_lat = bmm_f32(p.to(latent.dtype), latent[..., :kvr])
    return bmm_f32(o_lat.to(latent.dtype).transpose(0, 1), w_uv).transpose(0, 1)


def _inputs(B, H, Smax, width, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, width), generator=gen).to(dtype)
    latent = torch.randn((B, Smax, width), generator=gen).to(dtype)
    return q, latent


@pytest.mark.parametrize("B,H,Smax,width,kvr,pos,dtype", [
    (3, 4, 11, 24, 16, 7, torch.float32),  # the smoke config's widths
    (3, 4, 11, 24, 16, 7, torch.bfloat16),
    (2, 4, 9, 24, 16, 0, torch.bfloat16),  # one slot
    (2, 3, 40, 576, 512, 39, torch.bfloat16),  # DeepSeek-V3's widths, every slot
    (1, 5, 70, 576, 512, 33, torch.bfloat16),
    (2, 2, 33, 576, 512, 32, torch.float32),
])
def test_plain_equals_the_old_attention_body(B, H, Smax, width, kvr, pos, dtype):
    q, latent = _inputs(B, H, Smax, width, dtype, seed=B * 100 + Smax)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    scale = mla.softmax_scale(get("deepseek-v3").cfg)
    want = _frozen_body(q, latent, torch.arange(Smax) <= pos_t, scale, kvr)
    got = la.latent_attention(q, latent, pos_t, scale, value_width=kvr)
    assert got.dtype == dtype and got.shape == (B, H, kvr)
    assert torch.equal(got, want)
    out = torch.empty_like(want)
    assert la.latent_attention(q, latent, pos_t, scale, value_width=kvr, out=out) is out
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 10])
def test_absorbed_attention_on_the_smoke_config_equals_the_old(dtype, pos):
    base = get("deepseek-v3", smoke=True).cfg
    cfg = dataclasses.replace(base, dtype="float32" if dtype == torch.float32 else "bfloat16")
    gen = torch.Generator().manual_seed(7 + pos)
    params = mla.init_mla(gen, cfg, CPU)
    B, Smax, H = 3, 11, cfg.n_heads
    latent = torch.randn((B, Smax, mla.latent_width(cfg)), generator=gen).to(dtype)
    q_nope = torch.randn((B, H, cfg.mla_nope_dim), generator=gen).to(dtype)
    q_pe = torch.randn((B, H, cfg.mla_rope_dim), generator=gen).to(dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    want = _frozen_absorbed(params, cfg, q_nope, q_pe, latent, torch.arange(Smax) <= pos_t)
    got = mla.absorbed_attention(params, cfg, q_nope, q_pe, latent, pos_t)
    assert torch.equal(got, want)


def test_meta_tensors_take_the_plain_version():
    q = torch.empty((2, 128, 576), dtype=torch.bfloat16, device="meta")
    latent = torch.empty((2, 4352, 576), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    got = la.latent_attention(q, latent, pos, 0.1)
    assert got.device.type == "meta" and got.shape == (2, 128, 512)
    assert got.dtype == torch.bfloat16


def _bad_inputs():
    q, latent = _inputs(2, 4, 9, 24, torch.float32, seed=1)
    pos = torch.tensor(3, dtype=torch.int32)
    return {
        "q's dtype": (TypeError, dict(q=q.bfloat16())),
        "pos int64": (TypeError, dict(pos=pos.long())),
        "not a tensor": (TypeError, dict(pos=3)),
        "out's dtype": (TypeError, dict(out=torch.empty((2, 4, 16), dtype=torch.bfloat16))),
        "latent 2-d": (ValueError, dict(latent=latent[0])),
        "no slots": (ValueError, dict(latent=latent[:, :0])),
        "q's width": (ValueError, dict(q=q[..., :16].contiguous())),
        "q's rows": (ValueError, dict(q=q[:1])),
        "value width": (ValueError, dict(value_width=25)),
        "pos 1-d": (ValueError, dict(pos=pos.reshape(1))),
        "out's shape": (ValueError, dict(out=torch.empty((2, 4, 24)))),
        "q not contiguous": (ValueError, dict(q=q.transpose(0, 1).contiguous().transpose(0, 1))),
        "latent not contiguous": (ValueError,
                                  dict(latent=latent.transpose(1, 2).contiguous().transpose(1, 2))),
        "pos on the host": (ValueError, dict(q=q.to("meta"), latent=latent.to("meta"))),
        "q elsewhere": (ValueError, dict(q=q.to("meta"))),
    }, dict(q=q, latent=latent, pos=pos, scale=0.1, value_width=16)


@pytest.mark.parametrize("case", sorted(_bad_inputs()[0]))
def test_the_wrapper_refuses_what_it_cannot_take(case):
    bad, good = _bad_inputs()
    error, change = bad[case]
    args = {**good, **change}
    with pytest.raises(error):
        la.latent_attention(args.pop("q"), args.pop("latent"), args.pop("pos"), args.pop("scale"),
                            **args)


@pytest.mark.parametrize("dtype,width,value_width,ok", [
    (torch.bfloat16, 576, 512, True),
    (torch.float32, 576, 512, False),  # the kernel is bfloat16 only
    (torch.bfloat16, 24, 16, False),  # DeepSeek-V3's widths only
    (torch.bfloat16, 576, 256, False),
])
def test_the_kernel_takes_deepseeks_bfloat16_latent_only(dtype, width, value_width, ok):
    q = torch.empty((2, 128, width), dtype=dtype, device="meta")
    latent = torch.empty((2, 64, width), dtype=dtype, device="meta")
    if ok:
        la.check_kernel_takes(q, latent, value_width)
    else:
        with pytest.raises(ValueError):
            la.check_kernel_takes(q, latent, value_width)


@pytest.mark.parametrize("B,H,Smax", [(32, 128, 4352), (1, 128, 4352), (2, 16, 40),
                                      (64, 128, 4352), (200, 128, 4352), (5, 80, 1000),
                                      (1, 64, 1), (3, 128, 100)])
def test_plan_fills_the_card_within_one_wave(B, H, Smax):
    n_sm = 132
    blocks = B * -(-H // la.HEADS_A_BLOCK)
    tiles = -(-Smax // la.TILE)
    n = la.plan(B, H, Smax, n_sm)
    assert 1 <= n <= tiles
    if n > 1:
        assert blocks * n <= n_sm
    assert n == tiles or blocks * (n + 1) > n_sm  # no more blocks fit in the wave
    if (B, H, Smax) == (32, 128, 4352):
        assert n == 2  # DeepSeek's decode cell: 128 blocks on 132 SMs


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 66])
@pytest.mark.parametrize("pos", [0, 31, 32, 63, 100, 4096, 4351])
def test_the_splits_cover_slots_0_to_pos_once(pos, n_split):
    ranges = la.split_ranges(pos, n_split)
    assert len(ranges) == n_split
    covered = [s for lo, hi in ranges for s in range(lo, hi)]
    assert covered == list(range(pos + 1))
    sizes = [hi - lo for lo, hi in ranges]
    assert all(lo % la.TILE == 0 for lo, hi in ranges if hi > lo)  # whole tiles
    assert sizes == sorted(sizes, key=lambda n: n == 0)  # empty runs come last
