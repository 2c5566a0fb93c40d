"""The port's fused serving step against the reference's, and the slice as a
whole — proxy, store, codec and fused step — on the CPU.

The two steps run the same controller on the same state: the port's tables
are built from the reference's ``ServeTables`` leaves
(``serve_tables_from_arrays``). Decoded and encoded bytes and the (n, k)
picks are exact; the float32 carry agrees to rtol 1e-6 (the frameworks may
order or fuse the multiply-adds differently)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.coding.codec import Codec as RefCodec
from repro.coding.layout import SharedKeyLayout as RefSharedKeyLayout
from repro.core.delay_model import PAPER_READ_3MB as REF_READ
from repro.core.delay_model import RequestClass as RefRequestClass
from repro.serve.engine import FusedServingStep as RefFusedServingStep
from repro.serve.engine import ServePolicy as RefServePolicy
from repro_torch import obs
from repro_torch.coding import rs
from repro_torch.coding.codec import Codec, pow2_bucket
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy, TOFECPolicy
from repro_torch.models import get, registry
from repro_torch.serve import (
    ClosedLoopServer,
    FusedServingStep,
    ServePolicy,
    ServingEngine,
    carry_from_arrays,
    serve_tables_from_arrays,
)
from repro_torch.serve.engine import DecodeBucket, greedy_step
from repro_torch.storage import MemoryStore, Proxy
from repro_torch.tree import tree_leaves, tree_map

CPU = torch.device("cpu")
L = 16
CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
REF_CLS = RefRequestClass("read3mb", 3.0, REF_READ, k_max=6, r_max=2.0, n_max=12)
KINDS = {
    "tofec": (ServePolicy.tofec(), RefServePolicy.tofec()),
    "static": (ServePolicy.static(8, 4), RefServePolicy.static(8, 4)),
    "fixedk": (ServePolicy.fixedk(4), RefServePolicy.fixedk(4)),
    "mpc": (ServePolicy.mpc(), RefServePolicy.mpc()),
}


def _arrays(tables) -> dict:
    """A reference ServeTables as numpy leaves, MPC fields nested."""
    out = {f.name: np.asarray(getattr(tables, f.name))
           for f in dataclasses.fields(tables) if f.name != "mpc"}
    out["mpc"] = {f.name: np.asarray(getattr(tables.mpc, f.name))
                  for f in dataclasses.fields(tables.mpc)}
    return out


def _erased(rng, data, n, k):
    batch = data.shape[0]
    coded = np.stack([rs.encode(data[i], n, k) for i in range(batch)])
    present = np.stack([rng.permutation(n)[:k] for _ in range(batch)])
    return coded, present, np.stack([coded[i][present[i]] for i in range(batch)])


@pytest.fixture(scope="module")
def steps():
    """One reference step (jnp codec) and one port step (kernel codec on the
    CPU), kept across tests so the reference compiles each bucket once."""
    ref = RefFusedServingStep.for_class(REF_CLS, L, codec=RefCodec("jnp"))
    port = FusedServingStep(serve_tables_from_arrays(_arrays(ref.tables), CPU),
                            codec=Codec("kernel", device=CPU))
    return ref, port


def _assert_carry_close(port, ref):
    for a, b in zip(port.carry, ref.carry):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_step_equals_reference(steps, kind):
    ref, port = steps
    pol, ref_pol = KINDS[kind]
    ref_tables = ref_pol.tables(REF_CLS, L)
    ref.set_policy(ref_tables)
    port.set_policy(serve_tables_from_arrays(_arrays(ref_tables), CPU))
    # the port's own ServePolicy resolves to the same tables
    for name, want in _arrays(ref_tables).items():
        got = getattr(pol.tables(CLS, L, device=CPU), name)
        if name == "mpc":
            for f, w in want.items():
                np.testing.assert_array_equal(getattr(got, f).numpy(), w)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    ref.reset()
    port.reset()
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    for i in range(10):
        q = float(rng.integers(0, 40))
        dt = -1.0 if i in (0, 4) else float(np.float32(rng.exponential(0.05)))
        data = rng.integers(0, 256, size=(3, 6, 100), dtype=np.uint8)
        _, present, rows = _erased(rng, data, 12, 6)
        got, pick = port.decode_batch(rows, present, n=12, k=6, q=q, dt=dt)
        want, ref_pick = ref.decode_batch(rows, present, n=12, k=6, q=q, dt=dt)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, data)
        assert pick == ref_pick
        _assert_carry_close(port, ref)
        n, k = [(12, 6), (8, 6), (6, 6)][i % 3]
        got, pick = port.encode_batch(data, n=n, k=k, q=q, dt=dt)
        want, ref_pick = ref.encode_batch(data, n=n, k=k, q=q, dt=dt)
        np.testing.assert_array_equal(got, want)
        assert pick == ref_pick
        _assert_carry_close(port, ref)


def test_carry_from_arrays_resumes_reference_state(steps):
    ref, port = steps
    ref.set_policy(RefServePolicy.mpc().tables(REF_CLS, L))
    port.set_policy(ServePolicy.mpc().tables(CLS, L, device=CPU))
    ref.reset()
    rows = np.zeros((1, 6, 64), np.uint8)
    present = np.arange(6)
    for q, dt in [(3.0, -1.0), (9.0, 0.02), (1.0, 0.3)]:
        ref.decode_batch(rows, present, n=12, k=6, q=q, dt=dt)
    port.carry = carry_from_arrays([np.asarray(c) for c in ref.carry], CPU)
    _, pick = port.decode_batch(rows, present, n=12, k=6, q=20.0, dt=0.01)
    _, ref_pick = ref.decode_batch(rows, present, n=12, k=6, q=20.0, dt=0.01)
    assert pick == ref_pick
    _assert_carry_close(port, ref)


def test_policy_swap_keeps_buckets():
    step = FusedServingStep.for_policy(ServePolicy.tofec(), CLS, L,
                                       codec=Codec("kernel", device=CPU))
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(2, 4, 64), dtype=np.uint8)
    _, present, rows = _erased(rng, data, 8, 4)
    step.decode_batch(rows, present, n=8, k=4, q=1.0)
    traces = step.traces
    for pol, _ in KINDS.values():
        step.set_policy(pol.tables(CLS, L, device=CPU))
        got, _ = step.decode_batch(rows, present, n=8, k=4, q=2.0, dt=0.1)
        np.testing.assert_array_equal(got, data)
    assert step.traces == traces


def test_shape_buckets_bounded_across_codes_and_batches():
    """A heterogeneous stream of codes, erasure patterns and batch sizes
    uses at most one bucket per shape bucket of the reference's rule."""
    step = FusedServingStep.for_class(CLS, L, codec=Codec("torch", device=CPU))
    rng = np.random.default_rng(2)
    stream = [(n, k, batch, Bw) for k in (2, 4) for n in (k, k + 1, 2 * k)
              for batch in (1, 3, 8) for Bw in (33, 120)]
    buckets, calls = set(), 0
    for n, k, batch, Bw in stream * 2:
        data = rng.integers(0, 256, size=(batch, k, Bw), dtype=np.uint8)
        _, present, rows = _erased(rng, data, n, k)
        got, _ = step.decode_batch(rows, present, n=n, k=k, q=float(batch))
        np.testing.assert_array_equal(got, data)
        calls += 1
        buckets.add(("dec", k, pow2_bucket(k), pow2_bucket(Bw, Codec.B_FLOOR),
                     pow2_bucket(batch)))
        if n > k:
            step.encode_batch(data, n=n, k=k, q=float(batch))
            calls += 1
            buckets.add(("enc", k, pow2_bucket(n - k), pow2_bucket(Bw, Codec.B_FLOOR),
                         pow2_bucket(batch)))
    assert step.traces <= len(buckets)
    assert calls > 2 * len(buckets)


def test_host_only_codec_is_refused_by_name(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CODEC_BACKEND", "numpy")
    with pytest.raises(ValueError, match="REPRO_TORCH_CODEC_BACKEND=kernel") as ei:
        FusedServingStep.for_class(CLS, L, codec=Codec("numpy"))
    assert "'numpy'" in str(ei.value)


def test_slice_end_to_end_proxy_store_fused_step():
    """The port's proxy writes, flushes and raw-reads 16 objects; each round
    is rebuilt by the port's fused step and by the reference's on the same
    gathered rows. Payloads and picks match, the picks feed the write
    policy, and objects written under the adapted code read back too."""
    lay = SharedKeyLayout(K=6, r=2, strip_bytes=512)
    ref_lay = RefSharedKeyLayout(K=6, r=2, strip_bytes=512)
    codec = Codec("kernel", device=CPU)
    write_policy = FeedbackPolicy(lay.N, lay.K)
    proxy = Proxy(MemoryStore(), TOFECPolicy.for_classes([CLS], L), L=L, codec=codec,
                  write_policy=write_policy)
    step = FusedServingStep.for_class(CLS, L, codec=codec)
    ref_step = RefFusedServingStep.for_class(REF_CLS, L, codec=RefCodec("jnp"))
    host = TOFECPolicy.for_classes([CLS], L)
    rng = np.random.default_rng(11)
    try:
        payloads = {f"obj/{i}": rng.bytes(int(rng.integers(1, lay.file_bytes + 1)))
                    for i in range(16)}
        for r in [proxy.write_async(key, lay, p) for key, p in payloads.items()]:
            assert proxy.wait(r, timeout=30).ok
        proxy.flush_writes(timeout=30)
        keys = list(payloads)
        for rnd in range(3):
            if rnd == 2:  # objects written under the adapted (pushed) code
                extra = {f"new/{i}": rng.bytes(lay.file_bytes) for i in range(4)}
                for r in [proxy.write_async(key, lay, p) for key, p in extra.items()]:
                    res = proxy.wait(r, timeout=30)
                    assert res.ok and (res.n, res.k) == write_policy.code
                proxy.flush_writes(timeout=30)
                payloads.update(extra)
                batch_keys = list(extra)
            else:
                batch_keys = keys[rnd * 8:(rnd + 1) * 8]
            res = proxy.read_many(batch_keys, lay, raw=True, timeout=30)
            assert all(x.ok for x in res)
            items = [(x.k, x.chunks) for x in res]
            rows, present = lay.gather_rows_batch(items)
            ref_rows, ref_present = ref_lay.gather_rows_batch(items)
            np.testing.assert_array_equal(rows, ref_rows)
            got, pick = step.decode_batch(rows, present, n=lay.N, k=lay.K, q=len(batch_keys))
            want, ref_pick = ref_step.decode_batch(ref_rows, ref_present, n=lay.N, k=lay.K,
                                                   q=len(batch_keys))
            np.testing.assert_array_equal(got, want)
            assert pick == ref_pick == host.select(q=len(batch_keys), idle=0)
            for i, key in enumerate(batch_keys):
                n_bytes = len(payloads[key])
                assert got[i].reshape(-1)[:n_bytes].tobytes() == payloads[key]
            write_policy.push(*pick)
    finally:
        proxy.close()


# -- greedy decode on static buffers (the function a CUDA graph captures) ------


def _eager_decode(arch, params, logits, cache, steps):
    """The eager loop of ``ServingEngine.continue_greedy`` on a copy of the
    cache: (tokens (B, steps), each decode step's logits)."""
    cache = tree_map(torch.clone, cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks, logs = [tok[:, 0]], []
    for _ in range(steps - 1):
        logits, cache = arch.decode_step(params, tok, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok[:, 0])
        logs.append(logits)
    return torch.stack(toks, dim=1), logs


@pytest.mark.parametrize("batch", [2, 4])
def test_the_static_decode_loop_equals_the_eager_loop(batch):
    """zamba2's smoke config, bfloat16: the static buffers of one bucket,
    loaded and stepped by ``greedy_step`` run eagerly, give the eager
    loop's tokens and logits bit for bit, over two rounds in a row on the
    same buffers (prompts of 12 and then 9 tokens, so the second round's
    copy-in replaces the first's states, ring and position)."""
    arch = get("zamba2-2.7b", smoke=True)
    params = arch.init(torch.Generator().manual_seed(4), device=CPU)
    engine = ServingEngine(arch, params, max_seq=20)
    rng = np.random.default_rng(5)
    bucket, steps = None, 6
    for prompt_len in (12, 9):
        toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (batch, prompt_len))
                                .astype(np.int32))
        logits, cache = arch.prefill_tokens(params, toks, max_seq=engine.max_seq)
        want, want_logits = _eager_decode(arch, params, logits, cache, steps)
        assert torch.equal(engine.continue_greedy(logits, tree_map(torch.clone, cache), steps),
                           want)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if bucket is None:
            bucket = DecodeBucket(arch, params, tok, cache)
            for _ in range(2):  # leave the buffers in another state than the round's
                bucket.step()
        assert DecodeBucket.key(tok, cache) == DecodeBucket.key(bucket.state["tok"],
                                                                  bucket.state)
        bucket.load(tok, cache)
        got = [tok[:, 0]]
        for i in range(steps - 1):
            assert torch.equal(bucket.step(), want_logits[i]), (prompt_len, i)
            got.append(bucket.state["tok"][:, 0].clone())
        assert torch.equal(torch.stack(got, dim=1), want)
        assert int(bucket.state["pos"]) == prompt_len + steps - 1


def test_greedy_step_writes_every_buffer_in_place():
    """One ``greedy_step`` keeps every buffer's storage and advances the
    token, the states, the ring and the position there."""
    arch = get("zamba2-2.7b", smoke=True)
    params = arch.init(torch.Generator().manual_seed(6), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, arch.cfg.vocab, (2, 10))
                            .astype(np.int32))
    logits, cache = arch.prefill_tokens(params, toks, max_seq=16)
    state = tree_map(torch.clone, {**cache, "tok": torch.argmax(logits, -1).to(torch.int32)})
    before = {id(t): (t.data_ptr(), t.clone()) for t in tree_leaves(state)}
    with torch.inference_mode():
        greedy_step(arch, params, state)
    for t in tree_leaves(state):
        ptr, old = before[id(t)]
        assert t.data_ptr() == ptr and not torch.equal(t, old)
    assert int(state["pos"]) == 11


def test_only_the_hybrid_family_declares_its_decode_step_capturable():
    """The hybrid family, and the nemotron_h and deepseek_v3 families that
    share its capture contract (a decode step that advances the bucket's
    buffers in place)."""
    assert [f for f, m in registry._FAMILY_MODULES.items()
            if getattr(m, "CUDA_GRAPH_DECODE", False)] == ["hybrid", "nemotron_h", "deepseek_v3"]
    for name in ("qwen1.5-0.5b", "zamba2-2.7b"):  # on the CPU no family replays
        arch = get(name, smoke=True)
        assert not ServingEngine(arch, arch.init(device=CPU)).uses_graphs


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "zamba2-2.7b"])
def test_the_closed_loop_counts_its_decode_steps(name):
    """A dense and a hybrid smoke config served on the CPU: every decode
    step eager, none captured or replayed, one bucket; the
    ``serve.generate`` span carries the round's counts."""
    arch = get(name, smoke=True)
    engine = ServingEngine(arch, arch.init(torch.Generator().manual_seed(2), device=CPU),
                           max_seq=24)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=16)
    codec = Codec("kernel", device=CPU)
    store = MemoryStore()
    rng = np.random.default_rng(8)
    keys = [f"p/{i}" for i in range(3)]
    for key in keys:
        ServingEngine.store_prompt(store, key, layout,
                                   rng.integers(0, arch.cfg.vocab, 16).astype(np.int32),
                                   codec=codec)
    proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=codec,
                  write_policy=FeedbackPolicy(layout.N, layout.K))
    step = FusedServingStep.for_policy(ServePolicy.tofec(), CLS, L, codec=codec)
    server = ClosedLoopServer(engine, proxy, layout, step, prompt_len=16)
    obs.reset_trace()
    obs.set_enabled(True)
    try:
        for _ in range(2):
            server.serve_round(keys, steps=4)
        spans = [e for e in obs.get_tracer().events() if e["name"] == "serve.generate"]
    finally:
        obs.set_enabled(None)
        obs.reset_trace()
        proxy.close()
    assert (engine.captures, engine.graph_replays, engine.eager_steps) == (0, 0, 6)
    assert server.traces == 1
    assert [(e["args"]["graph_replays"], e["args"]["eager_steps"]) for e in spans] == [(0, 3)] * 2
