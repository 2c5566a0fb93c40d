"""The plain DeepSeek-V3 reference against the port's deepseek_v3 family at
its smoke shapes on the CPU, in float32: prefill, and decode steps through
the latent cache, on the benchmark's own weights; the configuration file
against the published config and the catalog's parameter count.

Tolerance: 2e-5 of the largest logit, as for zamba2 and Nemotron-H (the
port's chunked, row-grouped prefill and absorbed decode against the
reference's whole-sequence decompressed sums, in float32: readings
6.6e-7 and 7.8e-7 at the two prompt lengths)."""

import dataclasses
import json

import pytest
import torch

from tofec_bench.drivers import closed_loop
from tofec_bench.harness import spec, weights
from tofec_bench.reference import deepseek_v3 as ref

CPU = torch.device("cpu")
FILE = spec.ROOT / "tofec_bench/configs/deepseek-v3.json"

#: the port's ``configs/deepseek_v3.smoke_config`` shapes: 2 dense and 3
#: expert layers, experts 4-7 of 16 held, top 4 from the best 2 of 4 groups,
#: small MLA widths (values 12 wide, keys 16), YaRN over 64 positions
SMOKE_MODEL = {"n_layers": 5, "dense_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
               "mla_q_rank": 24, "mla_kv_rank": 16, "mla_nope_dim": 8, "mla_rope_dim": 8,
               "mla_v_dim": 12, "yarn_original": 64, "d_ff": 96, "moe_ff": 32,
               "shared_expert_ff": 32, "n_experts": 4, "router_experts": 16, "expert_first": 4,
               "top_k": 4, "n_group": 4, "topk_group": 2, "vocab": 512}


def _config(dtype: str) -> dict:
    cfg = json.loads(FILE.read_text())
    cfg["model"].update(SMOKE_MODEL, dtype=dtype)
    return cfg


def test_the_smoke_shapes_are_the_ports():
    from repro_torch.configs import deepseek_v3

    arch = closed_loop.arch_for(_config("bfloat16"))
    assert arch.cfg == deepseek_v3.smoke_config()


@pytest.mark.parametrize("prompt", [5, 20])
def test_reference_matches_the_port_in_float32(prompt):
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
    # every expert layer routes each row's prompt and 3 decoded tokens, 4 choices each
    assert int(cache["counters"][0]) == 3 * 3 * (prompt + 3) * 4


def test_the_new_leaves_follow_their_laws():
    cfg = _config("bfloat16")
    arch = closed_loop.arch_for(cfg)
    params = weights.seeded_params(arch, 5, CPU)
    attn, experts = params["moe"]["attn"], params["moe"]["moe"]
    assert torch.equal(experts["b_corr"], torch.zeros_like(experts["b_corr"]))
    assert experts["router"].dtype == experts["b_corr"].dtype == torch.float32
    assert tuple(experts["wg"].shape) == (3, 4, 64, 32)
    assert tuple(attn["wkv_b"].shape) == (3, 16, 4 * (8 + 12))
    scale = attn["kv_norm"]["scale"].float()
    assert 0.05 < float(scale.std()) < 0.2 and scale.shape == (3, 16)
    w = attn["wkv_b"].float()
    assert abs(float(w.std()) * 16 ** 0.5 - 1.0) < 0.1  # fan-in: the latent's width


def test_the_file_holds_the_published_config_and_the_cut():
    cfg = json.loads(FILE.read_text())
    pub = cfg["published"]
    for key, value in pub.items():
        assert cfg[key] == value or key in cfg["reduced"], key
    assert cfg["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"]) == (16, 8)
    assert (pub["num_hidden_layers"], pub["n_routed_experts"]) == (61, 256)
    assert cfg["experts_held"]["published"] == 256 and cfg["layers_held"]["published"] == 61
    m = cfg["model"]
    assert (m["n_layers"], m["n_experts"], m["router_experts"], m["expert_first"]) == (
        16, 8, 256, 0)
    assert (m["d_model"], m["vocab"], m["top_k"], m["d_ff"], m["moe_ff"], m["shared_expert_ff"],
            m["dense_layers"], m["n_group"], m["topk_group"], m["routed_scale"],
            m["n_heads"], m["norm_eps"]) == (
        pub["hidden_size"], pub["vocab_size"], pub["num_experts_per_tok"],
        pub["intermediate_size"], pub["moe_intermediate_size"],
        pub["n_shared_experts"] * pub["moe_intermediate_size"], pub["first_k_dense_replace"],
        pub["n_group"], pub["topk_group"], pub["routed_scaling_factor"],
        pub["num_attention_heads"], pub["rms_norm_eps"])
    assert (m["mla_q_rank"], m["mla_kv_rank"], m["mla_nope_dim"], m["mla_rope_dim"],
            m["mla_v_dim"], m["rope_theta"]) == (
        pub["q_lora_rank"], pub["kv_lora_rank"], pub["qk_nope_head_dim"],
        pub["qk_rope_head_dim"], pub["v_head_dim"], pub["rope_theta"])
    y = pub["rope_scaling"]
    assert (m["yarn_factor"], m["yarn_original"], m["yarn_beta_fast"], m["yarn_beta_slow"],
            m["yarn_mscale"], m["yarn_mscale_all_dim"]) == (
        y["factor"], y["original_max_position_embeddings"], y["beta_fast"], y["beta_slow"],
        y["mscale"], y["mscale_all_dim"])
    assert pub["scoring_func"] == "sigmoid" and pub["norm_topk_prob"]
    arch = closed_loop.arch_for(cfg)
    from repro_torch.tree import tree_leaves

    n = sum(t.numel() for t in tree_leaves(arch.init(device="meta")))
    assert n == cfg["parameters"] == 11_212_957_952
    whole = dataclasses.replace(arch.cfg, n_layers=61, n_experts=256)
    assert sum(t.numel() for t in tree_leaves(arch.module.init(whole, device="meta"))) == \
        cfg["parameters_published"] == 671_026_419_200


def test_fp8_control_moves_the_logits():
    """The control is the same model a precision lower: its logits move
    (float8 products, and the routing choices they flip) but follow the
    float32 ones."""
    cfg = _config("float32")
    arch = closed_loop.arch_for(cfg)
    params = weights.seeded_params(arch, 3, CPU)
    toks = torch.randint(0, 512, (2, 9), generator=torch.Generator().manual_seed(0))
    want = ref.logits(params, cfg, toks, [7, 8])
    got = ref.logits(params, cfg, toks, [7, 8], precision="fp8")
    assert not torch.allclose(got, want, rtol=1e-3)
    assert torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1] > 0.9
