"""The latent attention kernel (``kernels/attention/csrc/latent_attention.cu``,
K5) on the card. Each test is marked ``cuda`` and skips where no CUDA card
is present; the file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_latent_attention_cuda.py

The kernel keeps the plain version's rounding points but one: p is rounded
to bfloat16 against a running max of the block's slots, not after the
division by the whole row's sum. Both are held to the float64 P·c_kv of the
plain version's own rounded p. The kernel's distance from it may be at most
(``float64_reference``, beside the wrapper, computes both)

    2 · (the plain version's largest distance)   its own last rounding, which
                                                 may go the other way at a tie
  + 2⁻⁸ · Σₛ pₛ|vₛ|                              p rounded against another
                                                 max: each of the two roundings
                                                 is within 2⁻⁹ of the exact p
  + 2 · e_x · Σₛ pₛ|vₛ|                           the scores' float32 order: e_x
                                                 = scale · 576 · 2⁻²⁴ · maxₛ
                                                 Σ_d |q_d k_sd| bounds the move
                                                 of an exponent, 2 e_x that of p
  + Smax · 2⁻²⁴ · Σₛ pₛ|vₛ|                       any order of a float32 sum

The multiple 2 of the first term is K4's. Shapes: DeepSeek-V3's decode cell
(32 rows, 128 heads, 4,352 slots) at the first slot, two tiles, the round's
first and last steps; ragged ones (80 and 200 heads: a block of 16 and of 8;
1,000 and 77 slots: a partial last tile)."""

import dataclasses

import pytest
import torch

from repro_torch.kernels.attention import latent_attention as la
from repro_torch.models import get, mla
from repro_torch.models.registry import Arch
from repro_torch.serve.engine import DecodeBucket

pytestmark = pytest.mark.cuda

SCALE = mla.softmax_scale(get("deepseek-v3").cfg)
#: (B, H, Smax, pos)
CASES = [(32, 128, 4352, 0), (32, 128, 4352, 63), (32, 128, 4352, 4096),
         (32, 128, 4352, 4351), (5, 80, 1000, 517), (5, 80, 1000, 999), (3, 200, 77, 76)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(B, H, Smax, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, H, la.WIDTH), generator=g, device=device).bfloat16()
    latent = torch.randn((B, Smax, la.WIDTH), generator=g, device=device).bfloat16()
    return q, latent


@pytest.mark.parametrize("B,H,Smax,pos", CASES)
def test_kernel_holds_to_the_float64_product_of_the_plain_p(cuda, B, H, Smax, pos):
    q, latent = _inputs(B, H, Smax, cuda, seed=pos)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    got = la.latent_attention(q, latent, pos_t, SCALE)
    assert got.shape == (B, H, la.VALUE_WIDTH) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    o64, _, bound, _ = la.float64_reference(q, latent, pos, SCALE)
    err = (got.double() - o64).abs()
    assert bool((err <= bound).all()), (float(err.max()), float((err / bound).max()))


def test_slots_above_pos_are_never_read(cuda):
    """NaNs in every slot above pos change nothing."""
    q, latent = _inputs(4, 128, 600, cuda, seed=3)
    pos = torch.tensor(300, dtype=torch.int32, device=cuda)
    want = la.latent_attention(q, latent, pos, SCALE).clone()
    latent[:, 301:] = float("nan")
    assert torch.equal(la.latent_attention(q, latent, pos, SCALE), want)


def test_one_call_allocates_no_score_tensor(cuda):
    """Around a call at the cell's shape the allocator's peak grows by the
    output and the splits' float32 partials alone: less than B · H · Smax
    bfloat16 scores; the plain version's grows by more."""
    B, H, Smax = 32, 128, 4352
    q, latent = _inputs(B, H, Smax, cuda)
    pos = torch.tensor(Smax - 1, dtype=torch.int32, device=cuda)

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - base
        del out
        return grown

    kernel = peak(lambda: la.latent_attention(q, latent, pos, SCALE))
    plain = peak(lambda: la.latent_attention_plain(q, latent, pos, SCALE))
    scores = B * H * Smax * 2
    assert kernel < scores < plain, (kernel, scores, plain)


def test_replayed_from_a_graph_it_reads_pos_and_the_latent_on_the_device(cuda):
    """Captured once, replayed after the inputs change in place (a new
    token's q, its latent slot, pos): each replay equals an eager call on the
    same inputs; no call syncs with the host."""
    q, latent = _inputs(5, 128, 1000, cuda, seed=5)
    pos = torch.tensor(300, dtype=torch.int32, device=cuda)
    out = torch.empty((5, 128, la.VALUE_WIDTH), dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    replayed, eager = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        la.latent_attention(q, latent, pos, SCALE, out=out)
        graph = torch.cuda.CUDAGraph()
        launches = la.latent_attention.launches
        with torch.cuda.graph(graph):
            la.latent_attention(q, latent, pos, SCALE, out=out)
        captured = la.latent_attention.launches - launches
        for slot in (301, 302, 700):
            q.copy_(torch.randn(q.shape, generator=g, device=cuda))
            latent[:, slot].copy_(torch.randn(latent[:, slot].shape, generator=g, device=cuda))
            pos.fill_(slot)
            graph.replay()
            replayed.append(out.clone())
            eager.append(la.latent_attention(q, latent, pos, SCALE))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert captured == 1 and la.latent_attention.launches == launches + 4
    for step, (a, b) in enumerate(zip(replayed, eager)):
        assert torch.equal(a, b), step


def test_a_captured_deepseek_step_launches_it_once_a_layer(cuda):
    """The cell's 16-layer stage at published widths: the bucket's two
    warm-up steps and its captured step launch K5 16 times each; a replay
    launches it from the graph, with no host call."""
    base = get("deepseek-v3")
    arch = Arch(dataclasses.replace(base.cfg, n_layers=16, n_experts=8, router_experts=256),
                base.module)
    params = arch.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, arch.cfg.vocab, (8, 16), device=cuda, dtype=torch.int32,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    logits, cache = arch.prefill_tokens(params, toks, max_seq=24)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    bucket = DecodeBucket(arch, params, tok, cache)
    before = la.latent_attention.launches
    bucket.capture(torch.cuda.graph_pool_handle())
    assert la.latent_attention.launches - before == 3 * 16
    before = la.latent_attention.launches
    for _ in range(3):
        bucket.step()
    torch.cuda.synchronize()
    assert la.latent_attention.launches == before
