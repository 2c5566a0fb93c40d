"""The port's deepseek_v3 family (``repro_torch.models.deepseek_v3``) on the
CPU at its smoke config (2 dense and 3 expert layers; 16 experts in 4
groups, the top 4 from the best 2 groups, experts 4-7 held; MLA with a
query rank, values narrower than keys, YaRN over 64 original positions), in
float32, and the pieces it adds to shared code: latent attention in both
forms, the prefill's fused attention with values narrower than keys,
group-limited routing, SwiGLU experts, YaRN's frequencies.

The reference package has no such family, so the port is held against the
benchmark's plain reference (``tofec_bench/reference/deepseek_v3.py``) and
against closed forms. Tolerances, float32: 2e-5 of the largest logit where
the port's row-grouped prefill and absorbed decode meet the reference's
whole-sequence decompressed sums (readings below 1e-6); 1e-5
where two attention forms sum the same products in another order; 1e-6
where the expert shares meet the uncut layer; bit for bit where a shared
function is to be unchanged (Nemotron's routing and experts)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_v3 as ds_config
from repro_torch.configs import nemotron3_nano_30b_a3b
from repro_torch.models import deepseek_v3, get, mla, moe
from repro_torch.models import layers as ly
from repro_torch.models.registry import Arch, arch_names
from repro_torch.serve.engine import ServingEngine, greedy_step
from repro_torch.tree import tree_leaves, tree_map
from tofec_bench.reference import deepseek_v3 as ref

NAME = "deepseek-v3"
CPU = torch.device("cpu")


def _arch(**changes) -> Arch:
    base = get(NAME, smoke=True)
    return Arch(dataclasses.replace(base.cfg, dtype="float32", **changes), base.module)


def _model(cfg) -> dict:
    return {"model": {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}}


def _close(got, want, rel):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * scale, \
        float((got - want).abs().max()) / scale


def test_registry_serves_the_port_only_family_beside_the_mirrored_ten():
    assert NAME not in arch_names()
    arch = get(NAME)
    assert arch.module is deepseek_v3 and deepseek_v3.CUDA_GRAPH_DECODE
    assert deepseek_v3.PREFILL_MARKS and deepseek_v3.COUNTERS == moe.COUNTERS
    assert ds_config.smoke_config().family == "deepseek_v3"
    with pytest.raises(NotImplementedError, match="served only"):
        arch.train_loss({}, {})


def test_published_parameter_counts_on_meta():
    """Whole, 671.03 B without the MTP module; and the benchmark's stage of 16
    layers with one of 32 GPUs' 8 experts held, each expert layer keeping its
    router over all 256 and its shared expert."""
    arch = get(NAME)
    assert sum(t.numel() for t in tree_leaves(arch.init(device="meta"))) == 671_026_419_200
    stage = Arch(dataclasses.replace(arch.cfg, n_layers=16, n_experts=8, router_experts=256),
                 arch.module)
    p = stage.init(device="meta")
    assert sum(t.numel() for t in tree_leaves(p)) == 11_212_957_952
    assert tuple(p["moe"]["moe"]["wg"].shape) == (13, 8, 7168, 2048)
    assert tuple(p["moe"]["moe"]["router"].shape) == (13, 7168, 256)
    assert tuple(p["dense"]["mlp"]["wg"].shape) == (3, 7168, 18432)
    assert tuple(p["moe"]["attn"]["wkv_b"].shape) == (13, 512, 128 * 256)
    assert tuple(p["dense"]["attn"]["wq_b"].shape) == (3, 1536, 128 * 192)
    cache = stage.init_cache(32, 4352, device="meta")
    assert tuple(cache["latent"].shape) == (16, 32, 4352, 576)
    assert cache["latent"].numel() * 2 == 2_566_914_048  # 2.57 GB of bfloat16


@pytest.mark.parametrize("prompt, group_tokens, chunk", [(5, 16384, 1024), (20, 20, 8)])
def test_prefill_and_decode_match_the_reference(monkeypatch, prompt, group_tokens, chunk):
    """Prefill then 3 decode steps through the latent cache against the
    reference's full forward pass: one row group and one chunk, and rows
    walked one at a time over chunks of 8 (padded, the causal chunks
    skipped)."""
    monkeypatch.setattr(deepseek_v3, "PREFILL_TOKENS", group_tokens)
    arch = _arch(attn_q_chunk=chunk, attn_kv_chunk=chunk)
    params = arch.init(torch.Generator().manual_seed(0))
    for stack in ("dense", "moe"):  # norms off zero, so (1 + scale) is tested
        for leaf in ("ln1", "ln2"):
            params[stack][leaf]["scale"].normal_(0.0, 0.1,
                                                 generator=torch.Generator().manual_seed(3))
    toks = torch.randint(0, arch.cfg.vocab, (3, prompt + 3),
                         generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    logits, cache = arch.prefill_tokens(params, toks[:, :prompt], max_seq=prompt + 3)
    ptr = cache["latent"].data_ptr()
    port = [logits[:, 0]]
    for i in range(3):
        logits, cache = arch.decode_step(params, toks[:, prompt + i:prompt + i + 1], cache)
        port.append(logits[:, 0])
    assert cache["latent"].data_ptr() == ptr and int(cache["pos"]) == prompt + 3
    want = ref.logits(params, _model(arch.cfg), toks.long(), list(range(prompt - 1, prompt + 3)))
    _close(torch.stack(port, 1), want, 2e-5)


def test_row_groups_give_the_whole_batchs_prefill(monkeypatch):
    arch = _arch()
    params = arch.init(torch.Generator().manual_seed(4))
    toks = torch.randint(0, arch.cfg.vocab, (5, 6), generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32)
    whole, wc = arch.prefill_tokens(params, toks, max_seq=9)
    monkeypatch.setattr(deepseek_v3, "PREFILL_TOKENS", 12)  # rows of 2, 2 and 1
    marks = []
    parts, pc = arch.prefill_tokens(params, toks, max_seq=9, marks=marks)
    _close(parts, whole, 1e-6)
    _close(pc["latent"], wc["latent"], 1e-6)
    # the pairs are the batch's; experts hit and peaks are counted a layer call
    assert torch.equal(pc["counters"][:2], wc["counters"][:2])
    assert int(pc["counters"][4]) == 3 * int(wc["counters"][4])  # 3 groups of layer calls
    # one "start", then every group's layers: its start goes to its first step
    assert [k for k, _ in marks] == ["start"] + (["mla", "mlp"] * 2 + ["mla", "moe"] * 3) * 3


def test_absorbed_decode_equals_decompressed_attention_on_the_same_cache():
    """The absorbed form (q through W_UKᵀ, scores on the latent, P·c_kv
    through W_UV) against the per-head keys and values the latent
    decompresses to, in float64."""
    cfg = _arch().cfg
    H, dn, dr, dv, r = 4, 8, 8, 12, 16
    gen = torch.Generator().manual_seed(6)
    p = mla.init_mla(gen, cfg, CPU)
    B, Smax, pos = 3, 11, 7
    latent = torch.randn((B, Smax, r + dr), generator=gen)
    q_nope = torch.randn((B, H, dn), generator=gen)
    q_pe = torch.randn((B, H, dr), generator=gen)
    got = mla.absorbed_attention(p, cfg, q_nope, q_pe, latent,
                                 torch.tensor(pos, dtype=torch.int32))
    w = p["wkv_b"].double().view(r, H, dn + dv)
    lat = latent.double()[:, :pos + 1]
    k = torch.cat([torch.einsum("bsc,chd->bshd", lat[..., :r], w[..., :dn]),
                   lat[..., None, r:].expand(-1, -1, H, dr)], -1)
    v = torch.einsum("bsc,chd->bshd", lat[..., :r], w[..., dn:])
    q = torch.cat([q_nope, q_pe], -1).double()
    s = torch.einsum("bhd,bshd->bhs", q, k) * mla.softmax_scale(cfg)
    want = torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1), v)
    assert got.shape == (B, H, dv)
    _close(got.double(), want, 1e-5)


def test_a_decode_step_is_one_in_place_greedy_step():
    """The serving engine's graph contract: a greedy step advances every
    buffer in place (latent, counters, token, pos); on the CPU no family
    replays."""
    arch = _arch()
    params = arch.init(torch.Generator().manual_seed(2))
    toks = torch.randint(0, arch.cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    logits, cache = arch.prefill_tokens(params, toks, max_seq=9)
    state = tree_map(torch.clone, {**cache, "tok": torch.argmax(logits, -1).to(torch.int32)})
    before = {id(t): t.data_ptr() for t in tree_leaves(state)}
    with torch.inference_mode():
        greedy_step(arch, params, state)
    assert all(t.data_ptr() == before[id(t)] for t in tree_leaves(state))
    assert int(state["pos"]) == 7 and bool(state["latent"][:, :, 6].abs().sum() > 0)
    assert not ServingEngine(arch, params).uses_graphs


def _brute_route(p, cfg, x):
    """Per token, in float64 and plain Python: each group's score the sum of
    its two best scores + b_corr; the best topk_group groups by a full sort;
    the top_k of scores + b_corr among their experts by a full sort."""
    s = torch.sigmoid(x.double() @ p["router"].double())
    choice = s + p["b_corr"].double()
    size = cfg.n_router // cfg.n_group
    out = []
    for t in range(x.shape[0]):
        c = choice[t].tolist()
        groups = sorted(range(cfg.n_group), reverse=True,
                        key=lambda g: sum(sorted(c[g * size:(g + 1) * size])[-2:]))
        allowed = [e for g in groups[:cfg.topk_group] for e in range(g * size, (g + 1) * size)]
        ids = sorted(allowed, key=lambda e: -c[e])[:cfg.top_k]
        w = np.array([s[t, e].item() for e in ids])
        out.append((ids, w / w.sum() * cfg.routed_scale))
    return out


def test_group_limited_routing_equals_a_per_token_brute_force():
    cfg = _arch().cfg
    p = moe.init_routed_moe(torch.Generator().manual_seed(7), cfg, CPU)
    p["b_corr"] = torch.randn(p["b_corr"].shape, generator=torch.Generator().manual_seed(8)) * 0.1
    x = torch.randn((40, cfg.d_model), generator=torch.Generator().manual_seed(9))
    ids, w = moe.route_sigmoid(p, cfg, x)
    size = cfg.n_router // cfg.n_group
    for t, (want_ids, want_w) in enumerate(_brute_route(p, cfg, x)):
        assert ids[t].tolist() == want_ids
        np.testing.assert_allclose(w[t].double().numpy(), want_w, rtol=1e-6)
        assert len({e // size for e in want_ids}) <= cfg.topk_group


def test_held_shares_add_up_to_the_uncut_layer():
    """Four chips' shares of 4 experts each, with the shared expert counted
    once, give the layer with all 16 experts held, and the reference's."""
    cfg = _arch(n_experts=16, expert_first=0).cfg
    p = moe.init_routed_moe(torch.Generator().manual_seed(3), cfg, CPU)
    p["b_corr"] = torch.randn(p["b_corr"].shape, generator=torch.Generator().manual_seed(9)) * 0.1
    x = torch.randn((3, 7, cfg.d_model), generator=torch.Generator().manual_seed(4))
    xt = x.reshape(-1, cfg.d_model)
    uncut = moe.routed_moe(p, cfg, x).reshape(-1, cfg.d_model)
    parts = moe.shared_expert(p, cfg, xt)
    for chip in range(4):
        share = dataclasses.replace(cfg, n_experts=4, expert_first=4 * chip, router_experts=16)
        sl = slice(4 * chip, 4 * chip + 4)
        held = {**p, "wi": p["wi"][sl], "wg": p["wg"][sl], "wo": p["wo"][sl]}
        parts = parts + moe.held_experts(held, share, xt)
    _close(parts, uncut, 1e-6)
    m = {"n_experts": 16, "top_k": cfg.top_k, "routed_scale": cfg.routed_scale,
         "n_group": cfg.n_group, "topk_group": cfg.topk_group}
    _close(ref._moe(p, m, x, ref._Ops("fp32")).reshape(-1, cfg.d_model), uncut, 1e-6)


# -- Nemotron's routing and experts, as they were before group-limited routing
# and SwiGLU experts came in (frozen copies) --------------------------------


def _route_before(params, cfg, x):
    scores = torch.sigmoid(x.to(torch.float32) @ params["router"])
    ids = torch.topk(scores + params["b_corr"], cfg.top_k, dim=-1).indices
    w = torch.gather(scores, -1, ids)
    return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale


def _held_before(params, cfg, x, counters):
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    ids, w = _route_before(params, cfg, x)
    local = (ids - cfg.expert_first).reshape(-1)
    key = torch.where((local >= 0) & (local < E), local, E)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.int64).scatter_add_(0, key, torch.ones_like(key))
    ends = torch.cumsum(counts[:E], 0, dtype=torch.int32)
    rows = x.index_select(0, order // K)
    h = ly._act(cfg, moe.grouped_mm(rows, params["wi"], ends).to(torch.float32)).to(x.dtype)
    y = moe.grouped_mm(h, params["wo"], ends)
    held = (key.index_select(0, order) < E)[:, None]
    y = torch.where(held, y.to(torch.float32) * w.reshape(-1).index_select(0, order)[:, None],
                    0.0)
    out = torch.empty_like(y).index_copy_(0, order, y).reshape(T, K, d).sum(dim=1)
    c = counts[:E]
    counters.add_(torch.stack([counts.sum(), c.sum(), (c > 0).sum(), c.max(),
                               torch.ones_like(c[0])]))
    return out


def _shared_before(params, cfg, x):
    p = params["shared"]
    h = ly._act(cfg, (x @ p["wi"]).to(torch.float32)).to(x.dtype)
    return (h @ p["wo"]).to(torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nemotrons_routing_and_experts_are_unchanged_bit_for_bit(dtype):
    cfg = dataclasses.replace(nemotron3_nano_30b_a3b.smoke_config(), dtype=dtype)
    assert (cfg.n_group, cfg.glu, cfg.mlp_act) == (1, False, "relu2")
    p = moe.init_routed_moe(torch.Generator().manual_seed(11), cfg, CPU)
    assert "wg" not in p and "wg" not in p["shared"]
    p["b_corr"] = torch.randn(p["b_corr"].shape, generator=torch.Generator().manual_seed(12))
    x = torch.randn((29, cfg.d_model), generator=torch.Generator().manual_seed(13)).to(
        getattr(torch, dtype))
    for a, b in zip(moe.route_sigmoid(p, cfg, x), _route_before(p, cfg, x)):
        assert torch.equal(a, b)
    c_now, c_then = (torch.zeros(len(moe.COUNTERS), dtype=torch.int64) for _ in range(2))
    assert torch.equal(moe.held_experts(p, cfg, x, c_now), _held_before(p, cfg, x, c_then))
    assert torch.equal(c_now, c_then)
    assert torch.equal(moe.shared_expert(p, cfg, x), _shared_before(p, cfg, x))


# -- attention and RoPE --------------------------------------------------------


@pytest.mark.parametrize("S, H", [(1, 4), (5, 4), (10, 4), (15, 2), (16, 1), (33, 3)])
def test_prefill_attention_with_its_own_value_width_is_a_plain_softmax(S, H):
    """q and k 16 wide, v 12, an explicit scale, S causal positions,
    against one float64 softmax."""
    gen = torch.Generator().manual_seed(14)
    B = 2
    q, k = (torch.randn((B, S, H, 16), generator=gen) for _ in range(2))
    v = torch.randn((B, S, H, 12), generator=gen)
    got = mla.attend(q, k, v, 0.3)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * 0.3
    s = s.masked_fill(torch.arange(S)[None, :] > torch.arange(S)[:, None], -math.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.double())
    assert got.shape == (B, S, H, 12) and got.dtype == torch.float32
    _close(got.double(), want, 1e-5)


def _yarn_closed_form(dim, theta, factor, orig, beta_fast, beta_slow):
    """YaRN (arXiv:2309.00071 §3.2) in float64: dimension i turns
    orig · θ^(−2i/dim) / 2π times over the original context; those turning
    more than beta_fast times keep θ^(−2i/dim), fewer than beta_slow take it
    over the factor, and a linear ramp over the rounded correction range
    lies between."""
    def dim_at(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low, high = max(math.floor(dim_at(beta_fast)), 0), min(math.ceil(dim_at(beta_slow)), dim - 1)
    out = []
    for i in range(dim // 2):
        base = theta ** (-2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(base * (1 - ramp) + base / factor * ramp)
    return np.array(out), low, high


def test_yarn_frequencies_and_scale_equal_their_closed_form():
    cfg = ds_config.CONFIG
    want, low, high = _yarn_closed_form(64, 10000.0, 40.0, 4096, 32.0, 1.0)
    assert (low, high) == (10, 23)
    got = ly.yarn_inv_freq(cfg, 64, CPU).double().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    assert got[0] == 1.0 and got[-1] == pytest.approx(10000.0 ** (-62 / 64) / 40, rel=2e-6)
    assert mla.softmax_scale(cfg) == pytest.approx((0.1 * math.log(40) + 1) ** 2 / math.sqrt(192),
                                                   rel=1e-12)
    small = ds_config.smoke_config()
    want, low, high = _yarn_closed_form(8, 10000.0, 40.0, 64, 32.0, 1.0)
    assert (low, high) == (0, 2)  # a fast, a ramped and two slow dimensions
    np.testing.assert_allclose(ly.yarn_inv_freq(small, 8, CPU).double().numpy(), want,
                               rtol=2e-6)
    ref_freq = ref._inv_freq(_model(small)["model"], CPU).double().numpy()
    np.testing.assert_allclose(ref_freq, want, rtol=2e-6)


def test_rope_takes_the_given_frequencies():
    x = torch.randn((2, 5, 3, 8), generator=torch.Generator().manual_seed(15))
    pos = torch.arange(5)[None, :].expand(2, 5)
    plain = torch.exp(-torch.arange(4, dtype=torch.float32) * (math.log(10000.0) / 4))
    assert torch.equal(ly.rope(x, pos, 10000.0, plain), ly.rope(x, pos, 10000.0))
    assert not torch.allclose(ly.rope(x, pos, 10000.0, plain / 40), ly.rope(x, pos, 10000.0))
