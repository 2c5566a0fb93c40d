"""The deepseek_v3 family on the card, at its published widths cut to 4
layers (the 3 dense layers and one expert layer with one GPU's 8 of 256
experts). Each test is marked ``cuda`` and skips where no CUDA card is
present; the file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_deepseek_cuda.py

The decode step replayed from a CUDA graph gives the eager step's logits
bit for bit (the same kernels on the same inputs), and the same expert
counts; an eager step reads the bfloat16 latent cache in place, with no
wider copy of it; the prefill's fused attention on bfloat16 operands is a
float32 softmax with P and the output rounded to bfloat16."""

import dataclasses
import math

import pytest
import torch

from repro_torch.models import get, mla
from repro_torch.models.registry import Arch
from repro_torch.serve.engine import DecodeBucket, ServingEngine
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

NAME = "deepseek-v3"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _arch():
    base = get(NAME)
    return Arch(dataclasses.replace(base.cfg, n_layers=4, n_experts=8, router_experts=256),
                base.module)


def test_replayed_decode_equals_eager_at_published_widths(cuda):
    arch = _arch()
    params = arch.init(torch.Generator(device=cuda).manual_seed(0))
    assert ServingEngine(arch, params).uses_graphs
    B, S, steps = 32, 16, 3
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, arch.cfg.vocab, (B, S), generator=gen, device=cuda,
                         dtype=torch.int32)
    logits, cache = arch.prefill_tokens(params, toks, max_seq=S + steps + 1)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    pristine = tree_map(torch.clone, cache)

    eager, t, c = [], tok, cache
    for _ in range(steps):
        lg, c = arch.decode_step(params, t, c)
        eager.append(lg.clone())
        t = torch.argmax(lg, dim=-1).to(torch.int32)

    bucket = DecodeBucket(arch, params, tok, pristine)
    bucket.capture(torch.cuda.graph_pool_handle())
    bucket.load(tok, pristine)
    replayed = [bucket.step().clone() for _ in range(steps)]
    for i, (a, b) in enumerate(zip(eager, replayed)):
        assert torch.equal(a, b), (i, float((a - b).abs().max()))
    assert torch.equal(bucket.state["counters"], c["counters"])
    assert torch.equal(bucket.state["latent"], c["latent"])
    routed, held, hit, peak, calls = c["counters"].tolist()
    assert calls == steps + 1 and routed == (B * S + B * steps) * 8
    assert 0 < held < routed and hit <= 8 * calls and peak * 8 >= held


def test_a_decode_step_reads_the_latent_cache_in_place(cuda):
    """At 32 rows and 4,352 slots a layer's latent is 160 MB of bfloat16; a
    float32 copy of it would be 321 MB. An eager step's allocations peak
    below that: the projections' and the experts' outputs and the latent
    attention's float32 partials; no tensor of every slot's scores."""
    arch = _arch()
    params = arch.init(torch.Generator(device=cuda).manual_seed(2))
    B, S, max_seq = 32, 64, 4352
    toks = torch.randint(0, arch.cfg.vocab, (B, S), device=cuda, dtype=torch.int32,
                         generator=torch.Generator(device=cuda).manual_seed(3))
    logits, cache = arch.prefill_tokens(params, toks, max_seq=max_seq)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    arch.decode_step(params, tok, cache)  # cuBLAS's workspaces, outside the reading
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptr = cache["latent"].data_ptr()
    arch.decode_step(params, tok, cache)
    torch.cuda.synchronize()
    layer_f32 = B * max_seq * 576 * 4
    assert torch.cuda.max_memory_allocated() - base < layer_f32
    assert cache["latent"].data_ptr() == ptr


@pytest.mark.parametrize("S", [1000, 4096])
def test_prefill_attention_on_the_card_is_a_float32_softmax(cuda, S):
    """At MLA's widths (q·k 192, v 128) and scale, bfloat16 operands, S
    causal positions (1,000 fills no tile whole), against a float64 softmax
    of the same operands. Rounding P to bfloat16 for P·V moves an output by
    at most u · Σ p|v| and rounding the output by u · |o|, u = 2⁻⁸ (the
    float32 scores and sums add ~2⁻²⁰ of Σ p|v|): the bound."""
    cfg = get(NAME).cfg
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, H, dqk, dv = 2, 16, cfg.mla_nope_dim + cfg.mla_rope_dim, cfg.mla_v_dim
    q, k = (torch.randn((B, S, H, dqk), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((B, S, H, dv), generator=gen, device=cuda).to(torch.bfloat16)
    scale = mla.softmax_scale(cfg)
    got = mla.attend(q, k, v, scale)
    assert got.shape == (B, S, H, dv) and got.dtype == torch.bfloat16
    want = torch.empty((B, S, H, dv), dtype=torch.float64, device=cuda)
    pv_abs = torch.empty_like(want)
    for h in range(H):  # one head at a time: (B, S, S) float64 scores
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].double(), k[:, :, h].double()) * scale
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=cuda).triu(1), -math.inf)
        p = torch.softmax(s, dim=-1)
        want[:, :, h] = p @ v[:, :, h].double()
        pv_abs[:, :, h] = p @ v[:, :, h].double().abs()
    bound = 2.0 ** -8 * (pv_abs + want.abs()) + 2.0 ** -20 * pv_abs
    ratio = float(((got.double() - want).abs() / bound).max())
    assert ratio <= 1.0, ratio
