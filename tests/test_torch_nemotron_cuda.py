"""The nemotron_h family on the card, at its published widths with one
GPU's 32 of 128 experts. Each test is marked ``cuda`` and skips where no
CUDA card is present; the file imports neither jax nor the reference
package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_nemotron_cuda.py

The decode step replayed from a CUDA graph gives the eager step's logits
bit for bit (the same kernels on the same inputs: the sort-based dispatch
and the grouped expert product are deterministic), and the same expert
counts."""

import dataclasses

import pytest
import torch

from repro_torch.kernels.attention.decode_attention import decode_attention
from repro_torch.kernels.ssm.mamba2_step import mamba2_step
from repro_torch.models import get
from repro_torch.models.registry import Arch
from repro_torch.serve.engine import DecodeBucket, ServingEngine
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

NAME = "nemotron3-nano-30b-a3b"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_replayed_decode_equals_eager_at_published_widths(cuda):
    base = get(NAME)
    arch = Arch(dataclasses.replace(base.cfg, n_experts=32, router_experts=128), base.module)
    params = arch.init(torch.Generator(device=cuda).manual_seed(0))
    assert ServingEngine(arch, params).uses_graphs
    B, S, steps = 64, 16, 3
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
    before = mamba2_step.launches, decode_attention.launches
    bucket.capture(torch.cuda.graph_pool_handle())
    # the warm-up steps and the captured one each launch one Mamba2 step kernel a Mamba2
    # layer and one decode attention kernel an attention layer
    assert mamba2_step.launches - before[0] == 23 * (DecodeBucket.WARMUP + 1)
    assert decode_attention.launches - before[1] == 6 * (DecodeBucket.WARMUP + 1)
    bucket.load(tok, pristine)
    replayed = [bucket.step().clone() for _ in range(steps)]
    for i, (a, b) in enumerate(zip(eager, replayed)):
        assert torch.equal(a, b), (i, float((a - b).abs().max()))
    assert torch.equal(bucket.state["counters"], c["counters"])
    routed, held, hit, peak, calls = c["counters"].tolist()
    assert calls == 23 * (steps + 1) and routed == 23 * (B * S + B * steps) * 6
    assert 0 < held < routed and hit <= 32 * calls and peak * 32 >= held
