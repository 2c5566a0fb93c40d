"""The plain Nemotron-H reference against the port's nemotron_h family at
its smoke shapes on the CPU, in float32: prefill, and decode steps through
the cache, on the benchmark's own weights; the new leaves' laws; the
configuration file against the published config.

Tolerance: 2e-5 of the largest logit, as for zamba2 (the port's chunked
scan and cached decode against the reference's whole-sequence sums, in
float32: readings 4.4e-7 and 4.6e-7 at the two prompt lengths)."""

import dataclasses
import json

import pytest
import torch

from tofec_bench.drivers import closed_loop
from tofec_bench.harness import spec, weights
from tofec_bench.reference import nemotron_h as ref

CPU = torch.device("cpu")
FILE = spec.ROOT / "tofec_bench/configs/nemotron3-nano-30b-a3b.json"

#: the port's ``configs/nemotron3_nano_30b_a3b.smoke_config`` shapes: layers
#: ME*EM, B and C in 2 groups of 4 heads, experts 2-5 of 8 held, top 2
SMOKE_MODEL = {"n_layers": 5, "layer_pattern": "ME*EM", "d_model": 64, "n_heads": 4,
               "n_kv_heads": 2, "head_dim": 16, "d_ff": 32, "shared_expert_ff": 48,
               "n_experts": 4, "router_experts": 8, "expert_first": 2, "top_k": 2,
               "vocab": 512, "ssm_state": 16, "ssm_chunk": 8, "mamba_heads": 4,
               "mamba_head_dim": 16, "mamba_groups": 2}


def _config(dtype: str) -> dict:
    cfg = json.loads(FILE.read_text())
    cfg["model"].update(SMOKE_MODEL, dtype=dtype)
    return cfg


@pytest.mark.parametrize("prompt", [5, 16])
def test_reference_matches_the_port_in_float32(prompt):
    """A prompt shorter than one chunk of 8, and one of two chunks."""
    cfg = _config("float32")
    arch = closed_loop.arch_for(cfg)
    params = weights.seeded_params(arch, 11, CPU)
    gen = torch.Generator().manual_seed(prompt)
    toks = torch.randint(0, cfg["model"]["vocab"], (3, prompt + 4), generator=gen,
                         dtype=torch.int32)
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
    assert int(cache["counters"][0]) == 2 * 3 * (prompt + 3) * 2


def test_the_new_leaves_follow_their_laws():
    cfg = _config("bfloat16")
    arch = closed_loop.arch_for(cfg)
    params = weights.seeded_params(arch, 5, CPU)
    mixer, experts = params["mamba"]["mixer"], params["moe"]["moe"]
    assert torch.equal(mixer["b_conv"], torch.zeros_like(mixer["b_conv"]))
    assert torch.equal(experts["b_corr"], torch.zeros_like(experts["b_corr"]))
    assert experts["router"].dtype == experts["b_corr"].dtype == torch.float32
    assert mixer["b_conv"].dtype == torch.bfloat16 and mixer["b_conv"].ndim == 2
    scale = mixer["norm"]["scale"].float()
    assert 0.05 < float(scale.std()) < 0.2 and scale.shape == (2, 64)
    a = -torch.exp(mixer["A_log"])
    assert a.min() >= -16.0 and a.max() <= -1.0
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert dt.min() >= 0.99e-3 and dt.max() <= 0.101
    assert torch.equal(mixer["D"], torch.ones_like(mixer["D"]))
    w = experts["wi"].float()
    assert abs(float(w.std()) * cfg["model"]["d_model"] ** 0.5 - 1.0) < 0.1


def test_the_file_holds_the_published_config_and_the_cut():
    cfg = json.loads(FILE.read_text())
    pub = cfg["published"]
    for key, value in pub.items():
        assert cfg[key] == value or key in cfg["reduced"], key
    assert cfg["reduced"] == ["n_routed_experts"] and cfg["n_routed_experts"] == 32
    assert pub["n_routed_experts"] == 128 and cfg["experts_held"]["published"] == 128
    m = cfg["model"]
    assert (m["n_experts"], m["router_experts"], m["expert_first"]) == (32, 128, 0)
    assert m["layer_pattern"] == pub["hybrid_override_pattern"]
    assert (m["d_model"], m["vocab"], m["top_k"], m["d_ff"], m["shared_expert_ff"]) == (
        pub["hidden_size"], pub["vocab_size"], pub["num_experts_per_tok"],
        pub["moe_intermediate_size"], pub["moe_shared_expert_intermediate_size"])
    assert (m["mamba_heads"], m["mamba_head_dim"], m["mamba_groups"], m["ssm_state"]) == (
        pub["mamba_num_heads"], pub["mamba_head_dim"], pub["n_groups"], pub["ssm_state_size"])
    arch = closed_loop.arch_for(cfg)
    from repro_torch.tree import tree_leaves

    n = sum(t.numel() for t in tree_leaves(arch.init(device="meta")))
    assert n == cfg["parameters"] == 9_546_834_240
    whole = dataclasses.replace(arch.cfg, n_experts=128)
    assert sum(t.numel() for t in tree_leaves(arch.module.init(whole, device="meta"))) == \
        cfg["parameters_published"]


def test_fp8_control_moves_the_logits():
    """The control is the same model a precision lower: its logits move
    (float8 products, and the routing choices they flip) but follow the
    float32 ones (correlation 0.96 at this seed)."""
    cfg = _config("float32")
    arch = closed_loop.arch_for(cfg)
    params = weights.seeded_params(arch, 3, CPU)
    toks = torch.randint(0, 512, (2, 9), generator=torch.Generator().manual_seed(0))
    want = ref.logits(params, cfg, toks, [7, 8])
    got = ref.logits(params, cfg, toks, [7, 8], precision="fp8")
    assert not torch.allclose(got, want, rtol=1e-3)
    assert torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1] > 0.9
