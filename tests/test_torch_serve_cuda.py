"""The port's dense LM and closed loop on the card against the port on the
CPU, at the smoke configs in float32. Each test is marked ``cuda`` and
skips where no CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_serve_cuda.py

Logits agree to atol = rtol = 1e-4 (float32 on two devices: other
reduction orders). Generated tokens are compared where every step of the
row so far had a CPU top-1/top-2 logit margin above 1e-3 (at least 90 % of
positions must qualify); the closed loop's picks are exact."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy
from repro_torch.models import get
from repro_torch.models.registry import Arch
from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
from repro_torch.storage import MemoryStore, Proxy

pytestmark = pytest.mark.cuda

DENSE = ["gemma2-2b", "mistral-nemo-12b", "yi-6b", "qwen1.5-0.5b"]
CPU = torch.device("cpu")
CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
PROMPT_LEN = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _f32(name):
    arch = get(name, smoke=True)
    return Arch(cfg=dataclasses.replace(arch.cfg, dtype="float32"), module=arch.module)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_on_the_card_equal_the_cpu(cuda, name):
    arch = _f32(name)
    params = arch.init(torch.Generator().manual_seed(1))
    dev_params = _to(params, cuda)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (2, 16)).astype(np.int32))
    lc, cc = arch.prefill(params, {"tokens": toks}, max_seq=24)
    lg, cg = arch.prefill(dev_params, {"tokens": toks.to(cuda)}, max_seq=24)
    assert lg.device.type == "cuda" and cg["k"].device.type == "cuda"
    _close(lg, lc)
    for _ in range(2):
        nxt = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (2, 1)).astype(np.int32))
        lc, cc = arch.decode_step(params, nxt, cc)
        lg, cg = arch.decode_step(dev_params, nxt.to(cuda), cg)
        _close(lg, lc)
    for leaf in ("k", "v"):
        _close(cg[leaf], cc[leaf])
    assert torch.equal(cg["slot_pos"].cpu(), cc["slot_pos"]) and int(cg["pos"]) == int(cc["pos"])


def _loop(arch, params, store, layout, device):
    codec = Codec("kernel", device=device)
    write_pol = FeedbackPolicy(layout.N, layout.K)
    proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=codec, write_policy=write_pol)
    step = FusedServingStep.for_policy(ServePolicy.tofec(), CLS, 16, codec=codec)
    eng = ServingEngine(arch, params, max_seq=64)
    return eng, proxy, ClosedLoopServer(eng, proxy, layout, step, prompt_len=PROMPT_LEN)


def test_closed_loop_on_the_card_equals_the_cpu(cuda):
    arch = _f32("qwen1.5-0.5b")
    params = arch.init(torch.Generator().manual_seed(2))
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store = MemoryStore()
    rng = np.random.default_rng(6)
    keys, prompts = [], []
    for i in range(4):
        toks = rng.integers(0, arch.cfg.vocab, size=(PROMPT_LEN,)).astype(np.int32)
        ServingEngine.store_prompt(store, f"p/{i}", layout, toks, codec=Codec("numpy"))
        keys.append(f"p/{i}")
        prompts.append(toks)
    _, cpu_proxy, cpu_server = _loop(arch, params, store, layout, CPU)
    _, dev_proxy, dev_server = _loop(arch, _to(params, cuda), store, layout, cuda)
    # The CPU's top-1/top-2 margins on the same prompts and steps.
    logits, cache = arch.prefill(params, {"tokens": torch.from_numpy(np.stack(prompts))},
                                 max_seq=64)
    margins = []
    for _ in range(3):
        top2 = torch.topk(logits[:, 0], 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).numpy())
        logits, cache = arch.decode_step(params, torch.argmax(logits, -1).to(torch.int32), cache)
    qualified = np.cumprod(np.stack(margins, 1) > 1e-3, axis=1).astype(bool)
    assert qualified.mean() >= 0.9
    try:
        for r in range(2):
            want = cpu_server.serve_round(keys, steps=3)
            got = dev_server.serve_round(keys, steps=3)
            assert got.ok == want.ok == [True] * 4
            assert got.next_code == want.next_code, r
            np.testing.assert_array_equal(got.tokens[qualified], want.tokens[qualified])
        assert dev_server.traces == cpu_server.traces == 1
    finally:
        cpu_proxy.close()
        dev_proxy.close()
