"""The port's hybrid family (``repro_torch.models.ssm``'s Mamba2 and
``hybrid``) on the card against the port on the CPU. Each test is marked
``cuda`` and skips where no CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_hybrid_cuda.py

TF32 is off (the products are float32 as on the CPU). float32 runs agree to
1e-4 (two devices, other reduction orders) and bfloat16 runs to the
reference's 0.08. Checkpoint strips coded by K1 equal the plain version's
byte for byte. The decode step replayed from a CUDA graph gives the eager
loop's tokens, and its logits bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.ckpt import save_checkpoint
from repro_torch.coding.codec import Codec, pow2_bucket
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy
from repro_torch.kernels.attention.decode_attention import decode_attention
from repro_torch.kernels.gf2mm import gf2mm
from repro_torch.kernels.ssm.mamba2_step import mamba2_step
from repro_torch.models import get, hybrid, ssm
from repro_torch.models.registry import Arch
from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
from repro_torch.serve.engine import DecodeBucket
from repro_torch.storage import MemoryStore, Proxy
from repro_torch.train import init_opt_state, make_train_step
from repro_torch.tree import tree_flatten, tree_map

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
TOL = {"float32": 1e-4, "bfloat16": 0.08}
NAME = "zamba2-2.7b"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _arch(dtype, smoke=True, **changes):
    arch = get(NAME, smoke=smoke)
    return Arch(cfg=dataclasses.replace(arch.cfg, dtype=dtype, **changes), module=arch.module)


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _close(got, want, tol, what):
    torch.testing.assert_close(got.cpu().double(), want.double(), rtol=tol, atol=tol, msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_and_decode_on_the_card_equal_the_cpu(cuda, dtype):
    """The published Mamba2's widths (d_model 2,560, 32 heads of 160, state
    64, chunks of 256) at batch 1: the block over 300 positions (a padded
    second chunk), then 2 decode steps from its state; outputs and states.
    A_log, D and dt_bias drawn away from their constant init."""
    cfg = _arch(dtype, smoke=False).cfg
    params = ssm.init_mamba2(torch.Generator().manual_seed(1), cfg, CPU)
    rng = np.random.default_rng(2)
    H = cfg.n_heads
    for name, scale in (("A_log", 0.5), ("D", 1.0), ("dt_bias", 1.0)):
        params[name] = torch.from_numpy(rng.normal(size=H).astype(np.float32) * scale)
    x = torch.from_numpy(rng.normal(size=(1, 302, cfg.d_model)).astype(np.float32)).to(
        getattr(torch, dtype))
    dev = _to(params, cuda)
    want, want_st = ssm.mamba2_block(params, cfg, x[:, :300])
    got, st = ssm.mamba2_block(dev, cfg, x[:, :300].to(cuda))
    assert got.device.type == "cuda"
    _close(got, want, TOL[dtype], "block")
    for i, (g, w) in enumerate(zip(st, want_st, strict=True)):
        _close(g, w, TOL[dtype], f"block state {i}")
    for t in (300, 301):
        want, want_st = ssm.mamba2_decode_step(params, cfg, x[:, t:t + 1], want_st)
        got, st = ssm.mamba2_decode_step(dev, cfg, x[:, t:t + 1].to(cuda), st)
        _close(got, want, TOL[dtype], f"decode {t}")
        for i, (g, w) in enumerate(zip(st, want_st, strict=True)):
            _close(g, w, TOL[dtype], f"decode {t} state {i}")


def test_convs_round_on_the_card_as_on_the_cpu(cuda):
    """The prefill conv's bfloat16 sum in tap order gives the CPU's bits on
    the card; the decode conv's float32 sum over 4 taps, rounded once, may
    be reduced in another order there, so it holds to one bfloat16 step."""
    rng = np.random.default_rng(3)
    pad = torch.from_numpy(rng.normal(size=(2, 67, 9216)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(4, 9216)) * 0.1).astype(np.float32)).bfloat16()
    assert torch.equal(ssm.causal_conv(pad.to(cuda), w.to(cuda), 64).cpu(),
                       ssm.causal_conv(pad, w, 64))
    torch.testing.assert_close(ssm.decode_conv(pad[:, :4].to(cuda), w.to(cuda)).cpu(),
                               ssm.decode_conv(pad[:, :4], w), rtol=2.0 ** -8, atol=0.0)


def _prefill_decode(arch, params, device, *, S=20, steps=3, seed=7):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (2, S)).astype(np.int32))
    logits, cache = arch.prefill(params, {"tokens": toks.to(device)}, max_seq=S + steps)
    out = [logits]
    for _ in range(steps):
        nxt = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (2, 1)).astype(np.int32))
        logits, cache = arch.decode_step(params, nxt.to(device), cache)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_on_the_card_equal_the_cpu(cuda, dtype):
    """The smoke zamba2's prefill of 20 tokens (the 8-slot KV ring wrapped)
    and 3 decode steps: logits and the whole cache."""
    arch = _arch(dtype)
    params = arch.init(torch.Generator().manual_seed(8))
    want, want_cache = _prefill_decode(arch, params, CPU)
    got, got_cache = _prefill_decode(arch, _to(params, cuda), cuda)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        _close(g, w, TOL[dtype], f"logits {i}")
    for (path, g), (_, w) in zip(tree_flatten(got_cache), tree_flatten(want_cache), strict=True):
        assert g.dtype == w.dtype, path
        if w.is_floating_point():
            _close(g, w, TOL[dtype], f"cache {path}")
        else:
            assert torch.equal(g.cpu(), w), path


def test_decode_matches_prefill_continuation_on_the_card(cuda):
    """The reference's teacher-forcing check (bfloat16, 0.08) on the card."""
    arch = get(NAME, smoke=True)
    params = arch.init(torch.Generator(device=cuda).manual_seed(9))
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, arch.cfg.vocab, (B, S + 1)).astype(np.int32)).to(cuda)
    _, cache = arch.prefill(params, {"tokens": toks[:, :S]}, max_seq=S + 4)
    step, _ = arch.decode_step(params, toks[:, S:S + 1], cache)
    full, _ = arch.prefill(params, {"tokens": toks}, max_seq=S + 4)
    assert torch.isfinite(step).all()
    torch.testing.assert_close(step, full, rtol=0.08, atol=0.08)


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """One AdamW step in float32 through both attention sites: loss and
    grad norm to 1e-4."""
    arch = _arch("float32")
    params = arch.init(torch.Generator().manual_seed(3))
    stream = np.random.default_rng(4).integers(0, arch.cfg.vocab, size=(2, 33))
    batch = {"tokens": torch.from_numpy(stream[:, :32].astype(np.int32)),
             "labels": torch.from_numpy(stream[:, 1:].astype(np.int32))}
    step = make_train_step(arch)
    _, _, mc = step(tree_map(torch.clone, params), init_opt_state(params), batch)
    dev = _to(params, cuda)
    _, _, mg = step(dev, init_opt_state(dev), _to(batch, cuda))
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 1e-4 * float(mc["grad_norm"])


def test_zamba2_checkpoint_strips_from_k1_equal_the_plain_versions(cuda):
    """A bfloat16 zamba2 training state (float32 A_log, D and dt_bias among
    bfloat16 leaves) coded on the card (K1, one launch per group) and on the
    CPU: every object byte for byte."""
    arch = _arch("bfloat16")
    params = arch.init(torch.Generator().manual_seed(11))
    rng = np.random.default_rng(12)
    opt = init_opt_state(params)
    opt["m"] = tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32)), opt["m"])
    tree = {"params": params, "opt": opt}
    cpu_store, dev_store = MemoryStore(), MemoryStore()
    save_checkpoint(cpu_store, "ck", 3, tree, codec=Codec("kernel", device=CPU))
    before = gf2mm.gf2_rs_matmul_bytes.launches
    manifest = save_checkpoint(dev_store, "ck", 3, _to(tree, cuda), device=cuda)
    groups = {(m["n"], m["k"], pow2_bucket(m["strip_bytes"], 128))
              for m in manifest["leaves"].values()}
    assert gf2mm.gf2_rs_matmul_bytes.launches - before == len(groups)
    assert manifest["leaves"]["params/layers/mamba/A_log"]["dtype"] == "float32"
    assert sorted(dev_store.keys()) == sorted(cpu_store.keys())
    for key in cpu_store.keys():
        assert dev_store.get(key) == cpu_store.get(key), key


# -- the decode step replayed from CUDA graphs ----------------------------------------


def _eager_decode(arch, params, logits, cache, steps):
    """The eager greedy loop on a copy of the cache: (tokens (B, steps),
    each decode step's logits)."""
    cache = tree_map(torch.clone, cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks, logs = [tok[:, 0]], []
    for _ in range(steps - 1):
        logits, cache = arch.decode_step(params, tok, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok[:, 0])
        logs.append(logits)
    return torch.stack(toks, dim=1), logs


def _replay_equals_eager(engine, toks, steps):
    """One round at ``toks``: the replayed bucket's tokens and logits against
    the eager loop's, and ``continue_greedy``'s tokens."""
    arch, params = engine.arch, engine.params
    logits, cache = arch.prefill_tokens(params, toks, max_seq=engine.max_seq)
    want, want_logits = _eager_decode(arch, params, logits, cache, steps)
    got = engine.continue_greedy(logits, tree_map(torch.clone, cache), steps)
    assert torch.equal(got, want)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    bucket = engine.decode_bucket(tok, cache)
    assert bucket.graph is not None
    bucket.load(tok, cache)
    for i, w in enumerate(want_logits):
        assert torch.equal(bucket.step(), w), f"step {i}"
        assert torch.equal(bucket.state["tok"][:, 0], want[:, i + 1]), f"step {i}"


def test_replayed_decode_equals_the_eager_loop_on_the_card(cuda):
    """zamba2's smoke config at two buckets (batch 2 and 4), two rounds each
    (prompts of 12 then 9 tokens on the same buffers): one capture per
    bucket, steps − 1 replays per round."""
    arch = get(NAME, smoke=True)
    engine = ServingEngine(arch, arch.init(torch.Generator(device=cuda).manual_seed(3)),
                           max_seq=20)
    assert engine.uses_graphs
    rng = np.random.default_rng(4)
    steps = 6
    for batch in (2, 4):
        for prompt_len in (12, 9):
            toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (batch, prompt_len))
                                    .astype(np.int32)).to(cuda)
            _replay_equals_eager(engine, toks, steps)
    assert engine.captures == 2
    assert engine.graph_replays == 4 * (steps - 1) and engine.eager_steps == 0


def test_replayed_decode_at_published_width(cuda):
    """The whole zamba2-2.7b (54 layers, 9 sites) at 32 prompts of 128
    tokens, 8 steps: tokens and logits of the replayed step against the
    eager loop's."""
    arch = get(NAME)
    engine = ServingEngine(arch, arch.init(torch.Generator(device=cuda).manual_seed(5)),
                           max_seq=136)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, arch.cfg.vocab, (32, 128))
                            .astype(np.int32)).to(cuda)
    logits, cache = arch.prefill_tokens(engine.params, toks, max_seq=engine.max_seq)
    before = mamba2_step.launches, decode_attention.launches
    engine.decode_bucket(torch.argmax(logits, dim=-1).to(torch.int32), cache)
    # the warm-up steps and the captured one each launch one Mamba2 step kernel a layer
    # and one decode attention kernel a shared-attention site
    assert mamba2_step.launches - before[0] == 54 * (DecodeBucket.WARMUP + 1)
    assert decode_attention.launches - before[1] == 9 * (DecodeBucket.WARMUP + 1)
    _replay_equals_eager(engine, toks, 8)
    assert engine.captures == 1 and engine.graph_replays == 7


def test_the_closed_loop_counts_captures_and_replays_on_the_card(cuda):
    """Two rounds of zamba2's smoke config served through the proxy: one
    shape bucket and one capture in ``traces``, every decode step replayed,
    the ``serve.generate`` spans tagged with the counts."""
    arch = get(NAME, smoke=True)
    engine = ServingEngine(arch, arch.init(torch.Generator(device=cuda).manual_seed(7)),
                           max_seq=20)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=16)
    store = MemoryStore()
    rng = np.random.default_rng(8)
    keys = [f"p/{i}" for i in range(3)]
    prompts = rng.integers(0, arch.cfg.vocab, (3, 16)).astype(np.int32)
    for key, toks in zip(keys, prompts):
        ServingEngine.store_prompt(store, key, layout, toks, codec=Codec("numpy"))
    codec = Codec("kernel", device=cuda)
    proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=codec,
                  write_policy=FeedbackPolicy(layout.N, layout.K))
    cls = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
    step = FusedServingStep.for_policy(ServePolicy.tofec(), cls, 16, codec=codec)
    server = ClosedLoopServer(engine, proxy, layout, step, prompt_len=16)
    obs.reset_trace()
    obs.set_enabled(True)
    before = mamba2_step.launches
    try:
        results = [server.serve_round(keys, steps=4) for _ in range(2)]
        spans = [e for e in obs.get_tracer().events() if e["name"] == "serve.generate"]
    finally:
        obs.set_enabled(None)
        obs.reset_trace()
        proxy.close()
    assert server.traces == 2 and engine.captures == 1
    assert (engine.graph_replays, engine.eager_steps) == (6, 0)
    assert [(e["args"]["graph_replays"], e["args"]["eager_steps"]) for e in spans] == [(3, 0)] * 2
    # only the capture launches the Mamba2 step kernel from the host: a launch a layer
    # in each of its steps; the replays launch it from the graph
    assert mamba2_step.launches - before == arch.cfg.n_layers * (DecodeBucket.WARMUP + 1)
    want = _eager_decode(arch, engine.params, *arch.prefill_tokens(
        engine.params, torch.from_numpy(np.concatenate([prompts, 0 * prompts[:1]])).to(cuda),
        max_seq=20), 4)[0]
    for res in results:
        np.testing.assert_array_equal(res.tokens, want[:3].cpu().numpy())


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A decode step that syncs with the host cannot be captured: the engine
    raises, keeps no bucket, and does not decode eagerly instead."""
    inner = hybrid.decode_step

    def syncing(params, cfg, token, cache):
        int(cache["pos"])  # a host sync, refused while the stream captures
        return inner(params, cfg, token, cache)

    monkeypatch.setattr(hybrid, "decode_step", syncing)
    arch = get(NAME, smoke=True)
    engine = ServingEngine(arch, arch.init(torch.Generator(device=cuda).manual_seed(9)),
                           max_seq=20)
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, arch.cfg.vocab, (2, 12))
                            .astype(np.int32)).to(cuda)
    logits, cache = arch.prefill_tokens(engine.params, toks, max_seq=20)
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        engine.continue_greedy(logits, cache, 3)
    assert (engine.captures, engine.graph_replays, engine.eager_steps) == (0, 0, 0)
    assert not engine._buckets
