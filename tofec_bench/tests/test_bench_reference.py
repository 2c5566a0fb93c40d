"""The plain zamba2 reference against the port's hybrid model at the smoke
shapes on the CPU, in float32: prefill, and decode steps through the cache
(ring KV of the sliding window included), on the benchmark's own weights."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tofec_bench.drivers import closed_loop
from tofec_bench.harness import spec, weights
from tofec_bench.reference import zamba2 as ref
from tofec_bench.tests.small import SMOKE_MODEL

CPU = torch.device("cpu")


def _config(dtype: str) -> dict:
    cfg = json.load(open(spec.ROOT / "tofec_bench/configs/zamba2-2.7b.json"))
    cfg["model"].update(SMOKE_MODEL, dtype=dtype)
    return cfg


@pytest.mark.parametrize("prompt", [5, 16])
def test_reference_matches_the_port_in_float32(prompt):
    cfg = _config("float32")
    arch = closed_loop.arch_for(cfg)
    params = weights.seeded_params(arch, 11, CPU)
    gen = torch.Generator().manual_seed(prompt)
    V = cfg["model"]["vocab"]
    toks = torch.randint(0, V, (3, prompt + 4), generator=gen, dtype=torch.int32)
    logits, cache = arch.prefill_tokens(params, toks[:, :prompt], max_seq=prompt + 4)
    port = [logits[:, 0]]
    for i in range(3):
        logits, cache = arch.decode_step(params, toks[:, prompt + i:prompt + i + 1], cache)
        port.append(logits[:, 0])
    port = torch.stack(port, 1)
    want = ref.logits(params, cfg, toks[:, :prompt + 3].long(),
                      list(range(prompt - 1, prompt + 3)))
    scale = want.abs().max()
    assert torch.allclose(port, want, atol=2e-5 * scale, rtol=0), \
        float((port - want).abs().max() / scale)


def test_segsum_is_the_sum_of_each_segment():
    a = torch.randn(2, 7, dtype=torch.float64)
    s = ref._segsum(a)
    for t in range(7):
        for u in range(7):
            want = a[:, u + 1:t + 1].sum(-1) if u <= t else torch.full((2,), -np.inf,
                                                                       dtype=torch.float64)
            assert torch.allclose(s[:, t, u], want)


def test_fp8_control_rounds_every_product():
    x = torch.randn(4, 64)
    w = torch.randn(64, 32)
    ops = ref._Ops("fp8")
    got = ops.mm(x, w)
    assert not torch.allclose(got, x @ w, rtol=1e-3)
    assert torch.allclose(got, x @ w, rtol=0.2, atol=0.2 * (x @ w).abs().max())
    with pytest.raises(ValueError):
        ref._Ops("int4")


def test_weights_follow_their_laws():
    cfg = _config("bfloat16")
    arch = closed_loop.arch_for(cfg)
    params = weights.seeded_params(arch, 5, CPU)
    meta = arch.init(device="meta")
    m = params["layers"]["mamba"]
    assert m["w_in"].shape == meta["layers"]["mamba"]["w_in"].shape
    assert m["w_in"].dtype == torch.bfloat16 and m["A_log"].dtype == torch.float32
    a = -torch.exp(m["A_log"])
    assert a.min() >= -16.0 and a.max() <= -1.0
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert dt.min() >= 0.99e-3 and dt.max() <= 0.101
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    w = params["shared"]["mlp"]["wi"].float()
    assert abs(float(w.std()) * cfg["model"]["d_model"] ** 0.5 - 1.0) < 0.1
    again = weights.seeded_params(arch, 5, CPU)
    assert torch.equal(again["layers"]["mamba"]["w_in"], m["w_in"])


def test_full_model_has_the_published_parameter_count():
    cfg = json.load(open(spec.ROOT / "tofec_bench/configs/zamba2-2.7b.json"))
    arch = closed_loop.arch_for(cfg)
    from repro_torch.tree import tree_leaves

    n = sum(t.numel() for t in tree_leaves(arch.init(device="meta")))
    assert n == cfg["parameters"] == 2_964_860_480
    assert dataclasses.asdict(arch.cfg)["n_layers"] == 54
