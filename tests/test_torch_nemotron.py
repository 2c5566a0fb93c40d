"""The port's nemotron_h family (``repro_torch.models.nemotron_h``) on the
CPU at its smoke config (layers ``ME*EM``: every kind; 4 Mamba2 heads of 16
with B and C in 2 groups; experts 2-5 of the router's 8 held, top 2), in
float32, and the Mamba2 generalisation it rests on, at zamba2's smoke
config.

The reference package has no such family, so the port is held against
itself and against the benchmark's plain reference
(``tofec_bench/reference/nemotron_h.py``; the prefill and decode against it
are in ``tofec_bench/tests/test_bench_reference_nemotron.py``). Tolerances,
float32: 1e-6 of the output's largest magnitude where two computations
sum the same products in another order (the expert shares against the
uncut layer, the reference's per-expert loop), 1e-5 where a prefill's
chunked scan meets decode steps' exact recurrence."""

import dataclasses

import pytest
import torch

from repro_torch.configs import zamba2_2_7b
from repro_torch.models import get, moe, nemotron_h, ssm
from repro_torch.models import layers as ly
from repro_torch.models.registry import Arch, arch_names
from repro_torch.serve.engine import ServingEngine
from repro_torch.tree import tree_leaves
from tofec_bench.reference import nemotron_h as ref

NAME = "nemotron3-nano-30b-a3b"
CPU = torch.device("cpu")


def _arch(**changes) -> Arch:
    base = get(NAME, smoke=True)
    return Arch(dataclasses.replace(base.cfg, dtype="float32", **changes), base.module)


def _close(got, want, rel):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * scale, \
        float((got - want).abs().max()) / scale


def test_registry_serves_the_port_only_family_beside_the_mirrored_ten():
    assert NAME not in arch_names()
    arch = get(NAME)
    assert arch.module is nemotron_h and nemotron_h.CUDA_GRAPH_DECODE
    assert [k for k, _ in nemotron_h.layer_kinds(arch.cfg)].count("moe") == 23
    assert arch.cfg.layer_pattern.count("*") == 6 and arch.cfg.layer_pattern.count("M") == 23
    bad = dataclasses.replace(arch.cfg, layer_pattern="ME*")
    with pytest.raises(ValueError, match="layer_pattern"):
        nemotron_h.layer_kinds(bad)


def test_published_parameter_counts_on_meta():
    """Whole, and with one of four GPUs' 32 experts held: every expert layer
    keeps its router over all 128 and its shared expert."""
    arch = get(NAME)
    whole = sum(t.numel() for t in tree_leaves(arch.init(device="meta")))
    held = Arch(dataclasses.replace(arch.cfg, n_experts=32, router_experts=128), arch.module)
    p = held.init(device="meta")
    assert whole == 31_577_940_288
    assert sum(t.numel() for t in tree_leaves(p)) == 9_546_834_240
    assert tuple(p["moe"]["moe"]["wi"].shape) == (23, 32, 2688, 1856)
    assert tuple(p["moe"]["moe"]["router"].shape) == (23, 2688, 128)
    assert p["moe"]["moe"]["router"].dtype == torch.float32
    assert tuple(p["mamba"]["mixer"]["w_in"].shape) == (23, 2688, 2 * 4096 + 2 * 8 * 128 + 64)


def _moe_params(cfg, seed):
    p = moe.init_routed_moe(torch.Generator().manual_seed(seed), cfg, CPU)
    p["b_corr"] = torch.randn(p["b_corr"].shape, generator=torch.Generator().manual_seed(9))
    return p


def test_held_shares_add_up_to_the_uncut_layer():
    """Four chips' shares of 2 experts each, with the shared expert counted
    once, give the layer with all 8 experts held, and the reference's."""
    cfg = _arch(n_experts=8, expert_first=0).cfg
    p = _moe_params(cfg, 3)
    x = torch.randn((3, 7, cfg.d_model), generator=torch.Generator().manual_seed(4))
    xt = x.reshape(-1, cfg.d_model)
    uncut = moe.routed_moe(p, cfg, x).reshape(-1, cfg.d_model)
    parts = moe.shared_expert(p, cfg, xt)
    for chip in range(4):
        share = dataclasses.replace(cfg, n_experts=2, expert_first=2 * chip, router_experts=8)
        sl = slice(2 * chip, 2 * chip + 2)
        parts = parts + moe.held_experts({**p, "wi": p["wi"][sl], "wo": p["wo"][sl]}, share, xt)
    _close(parts, uncut, 1e-6)
    m = {"n_experts": 8, "top_k": cfg.top_k, "routed_scale": cfg.routed_scale}
    _close(ref._moe(p, m, x, ref._Ops("fp32")).reshape(-1, cfg.d_model), uncut, 1e-6)


def test_dispatch_runs_one_row_per_routed_pair(monkeypatch):
    """The grouped product gets B·S·K rows, not E_held·B·S slots, and the
    counters count the pairs."""
    cfg = _arch().cfg
    p = _moe_params(cfg, 5)
    rows = []
    real = moe.grouped_mm

    def spy(a, b, ends):
        rows.append((a.shape[0], b.shape[0], ends.shape[0]))
        return real(a, b, ends)

    monkeypatch.setattr(moe, "grouped_mm", spy)
    B, S, K, E = 3, 11, cfg.top_k, cfg.n_experts
    counters = torch.zeros(len(moe.COUNTERS), dtype=torch.int64)
    moe.routed_moe(p, cfg, torch.randn((B, S, cfg.d_model)), counters)
    assert rows == [(B * S * K, E, E)] * 2
    routed, held, hit, peak, calls = counters.tolist()
    assert (routed, calls) == (B * S * K, 1) and 0 < held < routed and 0 < hit <= E
    assert held <= peak * E


def test_decode_steps_continue_the_prefill():
    arch = _arch()
    params = arch.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, arch.cfg.vocab, (3, 14), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    marks = []
    logits, cache = arch.prefill_tokens(params, toks[:, :10], max_seq=14, marks=marks)
    assert [k for k, _ in marks] == ["start", "mamba", "moe", "attn", "moe", "mamba"]
    routed = 2 * 3 * 10 * arch.cfg.top_k
    assert cache["counters"][0] == routed and cache["counters"][4] == 2
    for i in range(3):
        logits, cache = arch.decode_step(params, toks[:, 10 + i:11 + i], cache)
    assert int(cache["pos"]) == 13 and cache["counters"][4] == 2 + 2 * 3
    assert cache["k"].shape == (1, 3, 14, 2, 16) and len(cache["mamba"][1]) == 2
    whole, _ = arch.prefill_tokens(params, toks[:, :13], max_seq=14)
    _close(logits, whole, 1e-5)


def test_the_engine_reads_the_prefill_and_decode_counts_apart():
    arch = _arch()
    params = arch.init(torch.Generator().manual_seed(0))
    eng = ServingEngine(arch, params, max_seq=16)
    assert not eng.uses_graphs
    gen = eng.generate(torch.randint(0, 512, (2, 8), generator=torch.Generator().manual_seed(2),
                                     dtype=torch.int32).numpy(), steps=4)
    assert gen.shape == (2, 4) and eng.eager_steps == 3
    pre, post = (c.tolist() for c in eng.counters)
    assert pre[0] == 2 * 2 * 8 * 2 and pre[4] == 2
    assert post[0] - pre[0] == 3 * 2 * 2 * 2 and post[4] - pre[4] == 3 * 2


def test_attention_without_rope_ignores_positions():
    cfg = _arch().cfg
    p = ly.init_attention(torch.Generator().manual_seed(0), cfg, CPU)
    x = torch.randn((2, 5, cfg.d_model))
    q = ly.project_q(p, cfg, x, torch.arange(5)[None] + 100)
    assert torch.equal(q, (x @ p["wq"]).reshape(2, 5, cfg.n_heads, cfg.hd))
    roped = dataclasses.replace(cfg, use_rope=True)
    assert not torch.equal(ly.project_q(p, roped, x, torch.arange(5)[None] + 100), q)


def test_grouped_b_and_c_are_shared_by_their_heads():
    """With G = H / 2, heads 2g and 2g + 1 read group g's B and C."""
    cfg = _arch().cfg
    H, G, N = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    t = torch.arange(2 * 3 * G * N, dtype=torch.float32).reshape(2, 3, G * N)
    per_head = ssm._per_head(t, cfg, (2, 3))
    assert per_head.shape == (2, 3, H, N)
    for h in range(H):
        assert torch.equal(per_head[:, :, h], t.reshape(2, 3, G, N)[:, :, h // (H // G)])


#: zamba2's smoke Mamba2 block and decode step (float32, A_log and dt_bias
#: drawn), read from the code before the Mamba2 layer took its own sizes:
#: Σ of the block's output, its last position's first 3 channels, Σ of the
#: S state, Σ of the decode step's output, Σ of its S state
ZAMBA2_PIN = (-1.6917318626801716, (-0.11700806021690369, -0.007681883405894041,
                                    -0.05844547599554062),
              1.2482963850279702, 0.8276303343300242, 1.5236319512605405)


def test_zamba2_mamba2_block_is_pinned():
    cfg = dataclasses.replace(zamba2_2_7b.smoke_config(), dtype="float32")
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups) == (4, 32, 4)
    p = ssm.init_mamba2(torch.Generator().manual_seed(3), cfg, CPU)
    assert set(p) == {"w_in", "conv", "A_log", "D", "dt_bias", "w_out"}
    g = torch.Generator().manual_seed(4)
    p["A_log"] = torch.randn(p["A_log"].shape, generator=g) * 0.5
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=g)
    x = torch.randn((2, 11, cfg.d_model), generator=g)
    y, st = ssm.mamba2_block(p, cfg, x)
    y2, st2 = ssm.mamba2_decode_step(p, cfg, x[:, :1], st)
    got = (float(y.double().sum()), tuple(float(v) for v in y[0, -1, :3]),
           float(st[1].double().sum()), float(y2.double().sum()), float(st2[1].double().sum()))
    assert got[0] == pytest.approx(ZAMBA2_PIN[0], rel=1e-6)
    assert got[1] == pytest.approx(ZAMBA2_PIN[1], rel=1e-6)
    assert got[2:] == pytest.approx(ZAMBA2_PIN[2:], rel=1e-6)
