"""The port's serving engine and closed loop (``repro_torch.serve``) on the
CPU: mirrors of ``tests/test_serve.py`` and of
``tests/test_fused_serve.py``'s engine and closed-loop tests, and the port's
closed loop against the reference's on the same prompts.

The port codes through ``Codec("kernel", device="cpu")`` (K1's plain
version); the reference through its ``jnp`` codec. Parameters are the
reference's ``arch.init(jax.random.key(s))``, carried across with
``params_from_numpy``. Where the two packages' generated tokens are
compared, the models run in float32 and a position counts only while every
step of its row so far had a reference top-1/top-2 logit margin above
1e-3: a smaller margin is within the frameworks' float32 noise and may pick
another token, after which the row's continuation differs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.coding.codec import Codec as RefCodec
from repro.coding.layout import SharedKeyLayout as RefSharedKeyLayout
from repro.core import FeedbackPolicy as RefFeedbackPolicy
from repro.core import StaticPolicy as RefStaticPolicy
from repro.core.delay_model import PAPER_READ_3MB as REF_READ
from repro.core.delay_model import RequestClass as RefRequestClass
from repro.models import get as ref_get
from repro.models.registry import Arch as RefArch
from repro.serve.engine import ClosedLoopServer as RefClosedLoopServer
from repro.serve.engine import FusedServingStep as RefFusedServingStep
from repro.serve.engine import ServePolicy as RefServePolicy
from repro.serve.engine import ServingEngine as RefServingEngine
from repro.serve.engine import tokens_from_strips as ref_tokens_from_strips
from repro.storage import MemoryStore as RefMemoryStore
from repro.storage import Proxy as RefProxy
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy
from repro_torch.models import get, params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import Arch
from repro_torch.serve import (
    ClosedLoopServer,
    FusedServingStep,
    ServePolicy,
    ServingEngine,
    tokens_from_strips,
)
from repro_torch.storage import MemoryStore, Proxy

CPU = torch.device("cpu")
CODEC = Codec("kernel", device=CPU)
CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
REF_CLS = RefRequestClass("read3mb", 3.0, REF_READ, k_max=6, r_max=2.0, n_max=12)
L = 16
PROMPT_LEN = 16
MARGIN = 1e-3


def _archs(name="qwen1.5-0.5b", seed=0, dtype=None):
    """(reference arch, reference params, port arch, port params) at the
    smoke config, in ``dtype`` (default: the config's)."""
    ref = ref_get(name, smoke=True)
    cfg = ref.cfg if dtype is None else dataclasses.replace(ref.cfg, dtype=dtype)
    ref = RefArch(cfg=cfg, module=ref.module)
    port = Arch(cfg=ModelConfig(**dataclasses.asdict(cfg)), module=get(name, smoke=True).module)
    rp = ref.init(jax.random.key(seed))
    return ref, rp, port, params_from_numpy(jax.tree.map(np.asarray, rp), CPU)


def _store_prompts(rng, vocab, n, layout, stores):
    """``n`` seeded prompts, stored pre-coded in each (store, store_prompt,
    codec) of ``stores``. Returns (keys, prompts)."""
    keys, truth = [], []
    for i in range(n):
        toks = rng.integers(0, vocab, size=(PROMPT_LEN,)).astype(np.int32)
        for store, store_prompt, codec in stores:
            store_prompt(store, f"p/{i}", layout, toks, codec=codec)
        keys.append(f"p/{i}")
        truth.append(toks)
    return keys, np.stack(truth)


def _port_store_prompt(store, key, layout, toks, codec):
    ServingEngine.store_prompt(store, key, layout, toks, codec=codec)


def _ref_store_prompt(store, key, layout, toks, codec):
    RefServingEngine.store_prompt(store, key, layout, toks)


# -- bytes → tokens ------------------------------------------------------------


@pytest.mark.parametrize("batch,k,strip_bytes,prompt_len,pad", [
    (3, 4, 32, 30, 0),  # a ragged tail of the last strip is left out
    (2, 6, 40, 60, 24),  # bucket padding on rows and on strip width
    (5, 1, 64, 16, 64),
    (1, 3, 128, 96, 0),  # every word of every strip
])
def test_tokens_from_strips_matches_reference(batch, k, strip_bytes, prompt_len, pad):
    rng = np.random.default_rng(batch * 100 + k)
    data = rng.integers(0, 256, size=(batch, k + (pad > 0) * 2, strip_bytes + pad),
                        dtype=np.uint8)
    data[0, 0, 3] = 0xFF  # a high byte >= 128: a negative int32 id
    want = np.asarray(ref_tokens_from_strips(jnp.asarray(data), k, strip_bytes, prompt_len))
    got = tokens_from_strips(torch.from_numpy(data), k, strip_bytes, prompt_len)
    assert got.dtype == torch.int32 and got.shape == (batch, prompt_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any()
    clipped = torch.clamp(got, 0, 511).numpy()
    np.testing.assert_array_equal(clipped, np.asarray(jnp.clip(want, 0, 511)))
    assert (clipped[want < 0] == 0).all()  # int32: a high byte clips to 0, not vocab - 1


# -- mirrors of tests/test_serve.py ------------------------------------------


def test_generate_shapes_and_determinism():
    arch = get("qwen1.5-0.5b", smoke=True)
    eng = ServingEngine(arch, arch.init(torch.Generator().manual_seed(0)), max_seq=64)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, arch.cfg.vocab, size=(3, 8)).astype(np.int32)
    out1 = eng.generate(prompts, steps=5)
    out2 = eng.generate(prompts, steps=5)
    assert out1.shape == (3, 5) and out1.dtype == np.int32
    np.testing.assert_array_equal(out1, out2)


def test_serve_via_erasure_coded_prompt_storage():
    arch = get("qwen1.5-0.5b", smoke=True)
    eng = ServingEngine(arch, arch.init(torch.Generator().manual_seed(1)), max_seq=64)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)  # 4·16B strips
    store = MemoryStore()
    keys, truth = _store_prompts(np.random.default_rng(2), arch.cfg.vocab, 3, layout,
                                 [(store, _port_store_prompt, CODEC)])
    proxy = Proxy(store, StaticPolicy(4, 2), L=8, codec=CODEC)
    try:
        res = eng.serve(proxy, layout, keys, prompt_len=PROMPT_LEN, steps=4)
        assert res.tokens.shape == (3, 4)
        assert all(c == (4, 2) for c in res.codes)
        np.testing.assert_array_equal(res.tokens, eng.generate(truth, steps=4))
    finally:
        proxy.close()


# -- mirrors of tests/test_fused_serve.py:136 and :251 -------------------------


def test_engine_fused_fetch_matches_unfused_end_to_end():
    arch = get("qwen1.5-0.5b", smoke=True)
    eng = ServingEngine(arch, arch.init(torch.Generator().manual_seed(1)), max_seq=64)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store = MemoryStore()
    keys, truth = _store_prompts(np.random.default_rng(4), arch.cfg.vocab, 4, layout,
                                 [(store, _port_store_prompt, CODEC)])
    cls = RequestClass("prompt", PROMPT_LEN * 4 / 2**20, PAPER_READ_3MB,
                       k_max=4, r_max=2.0, n_max=8)
    fused = FusedServingStep.for_class(cls, L=8, codec=CODEC)
    proxy = Proxy(store, StaticPolicy(4, 2), L=8, codec=CODEC)
    try:
        res = eng.serve(proxy, layout, keys, prompt_len=PROMPT_LEN, steps=4)
        fres = eng.serve(proxy, layout, keys, prompt_len=PROMPT_LEN, steps=4, fused=fused)
        assert res.next_code is None and fres.next_code is not None
        np.testing.assert_array_equal(fres.tokens, res.tokens)
        np.testing.assert_array_equal(fres.tokens, eng.generate(truth, steps=4))
        assert all(c == (4, 2) for c in fres.codes)
    finally:
        proxy.close()


def _port_loop(arch, params, store, layout, *, max_seq=64, **proxy_kw):
    eng = ServingEngine(arch, params, max_seq=max_seq)
    write_pol = FeedbackPolicy(layout.N, layout.K)
    proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=CODEC, write_policy=write_pol,
                  **proxy_kw)
    step = FusedServingStep.for_policy(ServePolicy.tofec(), CLS, L, codec=CODEC)
    return eng, proxy, write_pol, ClosedLoopServer(eng, proxy, layout, step,
                                                   prompt_len=PROMPT_LEN)


def test_closed_loop_rounds_share_one_bucket_and_feed_writes():
    """The port's twin of the reference's tentpole test: one shape bucket
    for 4 rounds, tokens equal to prefill + decode on the ground-truth
    prompts, the controller's pick in the write policy after every round,
    and the next queued write encoded under it and read back."""
    arch = get("qwen1.5-0.5b", smoke=True)
    params = arch.init(torch.Generator().manual_seed(2))
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store = MemoryStore()
    rng = np.random.default_rng(6)
    keys, truth = _store_prompts(rng, arch.cfg.vocab, 4, layout,
                                 [(store, _port_store_prompt, CODEC)])
    eng, proxy, write_pol, server = _port_loop(arch, params, store, layout)
    try:
        results = [server.serve_round(keys, steps=3) for _ in range(4)]
        assert server.traces == 1, f"{server.traces} buckets for 4 rounds"
        assert server.stats.launches == 4
        for res in results:
            assert res.ok == [True] * 4
            assert res.next_code == write_pol.code  # loop is closed
            assert set(res.phase_ms) == {"fetch", "launch", "generate"}
        np.testing.assert_array_equal(results[-1].tokens, eng.generate(truth, steps=3))
        payload = rng.integers(0, 256, layout.file_bytes, dtype=np.uint8).tobytes()
        server.put("w/0", payload)
        proxy.flush_writes()
        wres = [r for r in proxy.results if r.op == "write"]
        assert wres and (wres[-1].n, wres[-1].k) == write_pol.code
        back = proxy.read("w/0", layout, payload_len=len(payload))
        assert back.ok and back.data == payload
    finally:
        proxy.close()


# -- the port's closed loop against the reference's ----------------------------


def _ref_margins(ref, rp, prompts, steps, max_seq):
    """Reference tokens and top-1/top-2 logit margins of greedy generation
    from ``prompts``, at their batch: (B, steps) each."""
    eng = RefServingEngine(ref, rp, max_seq=max_seq)
    logits, cache = eng._prefill(rp, {"tokens": jnp.asarray(prompts, jnp.int32)})
    toks, margins = [], []
    for _ in range(steps):
        lg = np.asarray(logits)[:, 0]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok)[:, 0])
        logits, cache = eng._decode(rp, tok, cache)
    return np.stack(toks, axis=1), np.stack(margins, axis=1)


def _assert_tokens_agree(got, want, margins):
    """Equal wherever every step of the row so far had a margin above
    MARGIN; at least 90 % of the positions must qualify."""
    qualified = np.cumprod(margins > MARGIN, axis=1).astype(bool)
    assert qualified.mean() >= 0.9, f"only {qualified.mean():.3f} of positions qualify"
    np.testing.assert_array_equal(got[qualified], want[qualified])


@pytest.mark.parametrize("n_keys", [4, 3])
def test_closed_loop_matches_reference(n_keys):
    """Four rounds of both closed loops over the same stored prompts, in
    float32: the same tokens (margin-qualified), ok masks, read codes,
    controller picks fed to the write policy and one bucket. Three keys pad
    the batch to a bucket of four in both."""
    steps, max_seq = 4, 64
    ref, rp, port, pp = _archs(seed=2, dtype="float32")
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    ref_layout = RefSharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store, ref_store = MemoryStore(), RefMemoryStore()
    keys, truth = _store_prompts(np.random.default_rng(6), port.cfg.vocab, n_keys, layout,
                                 [(store, _port_store_prompt, CODEC)])
    _store_prompts(np.random.default_rng(6), port.cfg.vocab, n_keys, ref_layout,
                   [(ref_store, _ref_store_prompt, None)])
    _, proxy, write_pol, server = _port_loop(port, pp, store, layout, max_seq=max_seq)
    ref_write_pol = RefFeedbackPolicy(ref_layout.N, ref_layout.K)
    ref_proxy = RefProxy(ref_store, RefStaticPolicy(8, 4), L=8, write_policy=ref_write_pol)
    ref_step = RefFusedServingStep.for_policy(RefServePolicy.tofec(), REF_CLS, L,
                                              codec=RefCodec("jnp"))
    ref_server = RefClosedLoopServer(RefServingEngine(ref, rp, max_seq=max_seq), ref_proxy,
                                     ref_layout, ref_step, prompt_len=PROMPT_LEN)
    want_toks, margins = _ref_margins(ref, rp, np.pad(truth, ((0, 4 - n_keys), (0, 0))),
                                      steps, max_seq)
    try:
        for r in range(4):
            got = server.serve_round(keys, steps=steps)
            want = ref_server.serve_round(keys, steps=steps)
            assert got.ok == want.ok == [True] * n_keys
            assert got.served_keys == want.served_keys == keys
            assert got.codes == want.codes
            assert got.next_code == want.next_code == write_pol.code == ref_write_pol.code, r
            assert got.tokens.shape == want.tokens.shape == (n_keys, steps)
            _assert_tokens_agree(got.tokens, want.tokens, margins[:n_keys])
            _assert_tokens_agree(got.tokens, want_toks[:n_keys], margins[:n_keys])
        assert server.traces == ref_server.traces == 1
    finally:
        proxy.close()
        ref_proxy.close()


def test_closed_loop_first_round_has_no_interarrival(monkeypatch):
    """dt is −1 on the first round, then the seconds since the last round
    (at least 1e-9): the MPC lane reads it."""
    arch = get("qwen1.5-0.5b", smoke=True)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store = MemoryStore()
    keys, _ = _store_prompts(np.random.default_rng(1), arch.cfg.vocab, 2, layout,
                             [(store, _port_store_prompt, CODEC)])
    _, proxy, _, server = _port_loop(arch, arch.init(torch.Generator()), store, layout)
    seen = []
    import repro_torch.serve.engine as engine_mod

    real = engine_mod.serve_policy_step

    def spy(carry, q, dt, tables):
        seen.append((q, dt))
        return real(carry, q, dt, tables)

    monkeypatch.setattr(engine_mod, "serve_policy_step", spy)
    try:
        for _ in range(3):
            server.serve_round(keys, steps=1)
        server.serve_round(keys[:1], steps=1)
    finally:
        proxy.close()
    assert [q for q, _ in seen] == [2.0, 2.0, 2.0, 1.0]  # the round's request count
    assert seen[0][1] == -1.0 and all(dt >= 1e-9 for _, dt in seen[1:])


def test_closed_loop_refuses_telemetry_it_cannot_collect(monkeypatch):
    arch = get("qwen1.5-0.5b", smoke=True)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store = MemoryStore()
    keys, _ = _store_prompts(np.random.default_rng(1), arch.cfg.vocab, 1, layout,
                             [(store, _port_store_prompt, CODEC)])
    _, proxy, _, server = _port_loop(arch, arch.init(torch.Generator()), store, layout)
    try:
        assert server.metrics is None and server.timeline is None and server.flight is None
        monkeypatch.setenv("REPRO_OBS", "1")  # the round collects its telemetry
        server.serve_round(keys, steps=1)
        assert server.metrics.snapshot()["counters"]["serve_rounds"] == 1
        assert server.timeline.snapshot()["slots"] == 1 and len(server.flight) == 1
        with pytest.raises(ValueError, match="needs 68 bytes"):
            ClosedLoopServer(server.engine, proxy, layout, server.step, prompt_len=17)
    finally:
        proxy.close()
