"""The port's hybrid LM (``repro_torch.models.hybrid``, zamba2-2.7b) against
the reference's on the CPU, at the zamba2-2.7b smoke config (4 Mamba2
layers, the shared attention block after layers 1 and 3, so 2 sites, a
local window of 8, so the KV ring wraps): init, loss and gradients, prefill
and decode with their caches, the closed loop, training and checkpoints.

Parameters come from the reference's ``arch.init(jax.random.key(s))`` and
are carried across with ``params_from_numpy``; token ids are drawn with
numpy. Tolerances: 1e-4 in float32 (the two frameworks sum in different
orders), the reference's own 0.08 in bfloat16 (its zamba2 smoke tests pass
on the CPU's jax, so it is the oracle in bfloat16 too); losses to 1e-5
relative and each gradient leaf's difference to 1e-4 of its norm in
float32. In bfloat16 the loss holds to 1e-3 relative and each gradient
leaf to 3e-2 of its norm: the reference's layer scan runs compiled, where
XLA may keep bfloat16 intermediates in float32, and sums the shared
block's gradient over its sites from the last to the first in bfloat16,
so a few activations sit one bfloat16 step (2^-8) apart and the backward
carries them (1.2e-2 of the norm at most, at this test's seed)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint as ref_save
from repro.coding.codec import Codec as RefCodec
from repro.coding.layout import SharedKeyLayout as RefSharedKeyLayout
from repro.core import FeedbackPolicy as RefFeedbackPolicy
from repro.core import StaticPolicy as RefStaticPolicy
from repro.core.delay_model import PAPER_READ_3MB as REF_READ
from repro.core.delay_model import RequestClass as RefRequestClass
from repro.models import get as ref_get
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.models.registry import Arch as RefArch
from repro.serve.engine import ClosedLoopServer as RefClosedLoopServer
from repro.serve.engine import FusedServingStep as RefFusedServingStep
from repro.serve.engine import ServePolicy as RefServePolicy
from repro.serve.engine import ServingEngine as RefServingEngine
from repro.storage import MemoryStore as RefMemoryStore
from repro.storage import Proxy as RefProxy
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch.ckpt import save_checkpoint
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy
from repro_torch.models import ShapeSpec, get, params_from_numpy
from repro_torch.models import hybrid, ssm
from repro_torch.models import layers as ly
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import Arch
from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
from repro_torch.serve.engine import DecodeBucket
from repro_torch.storage import FaultyStore, MemoryStore, Proxy
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig, init_opt_state
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

CPU = torch.device("cpu")
CODEC = Codec("kernel", device=CPU)
NAME = "zamba2-2.7b"
TOL = {"float32": 1e-4, "bfloat16": 0.08}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _pair(dtype, seed=1, **changes):
    """(reference arch, port arch, reference params, port params) at the
    smoke config in ``dtype``."""
    ref = ref_get(NAME, smoke=True)
    cfg = dataclasses.replace(ref.cfg, dtype=dtype, **changes)
    port = Arch(cfg=ModelConfig(**dataclasses.asdict(cfg)), module=hybrid)
    ref = RefArch(cfg=cfg, module=ref.module)
    rp = ref.init(jax.random.key(seed))
    return ref, port, rp, params_from_numpy(jax.tree.map(np.asarray, rp), CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x).astype(np.float64)


def _close(port, ref, tol, what):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=tol, atol=tol, err_msg=what)


def _path(p):
    return p.key if hasattr(p, "key") else p.idx


def _named(tree):
    """{"a/0/b": leaf} of a reference (jax/numpy) or port tree."""
    return {"/".join(str(_path(p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_cache(pc, rc, tol, what):
    """The stacked Mamba2 states (conv_buf, S, n), each site's k, v and
    slot_pos, and the position: dtypes, shapes and values."""
    got, want = _named(pc), _named(rc)
    assert sorted(got) == sorted(want) == [
        "k", "mamba/0", "mamba/1", "mamba/2", "pos", "slot_pos", "v"]
    for name in want:
        g, w = got[name], want[name]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        assert tuple(g.shape) == tuple(w.shape), name
        if name in ("pos", "slot_pos"):
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{what}: {name}")
        else:
            _close(g, w, tol, f"{what}: {name}")


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / abs(float(b))


# -- registry and init ----------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_init_shapes_and_dtypes_match_eval_shape(smoke):
    """The reference's tree: embedding, the stacked backbone {ln, mamba},
    the shared {ln1, attn, ln2, mlp}, ln_f; A_log, D and dt_bias float32.
    At the published width (on the meta device) 19 leaves and
    2,964,860,480 parameters."""
    ref = ref_get(NAME, smoke=smoke)
    arch = get(NAME, smoke=smoke)
    assert arch.cfg == ModelConfig(**dataclasses.asdict(ref.cfg)) and arch.module is hybrid
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jax.eval_shape(ref.init, jax.random.key(0)))
    params = arch.init(torch.Generator().manual_seed(0)) if smoke else arch.init(device="meta")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), params)
    assert got == want
    for name in ("A_log", "D", "dt_bias"):
        assert params["layers"]["mamba"][name].dtype == torch.float32
    if not smoke:
        leaves = tree_leaves(params)
        assert len(leaves) == 19
        assert sum(t.numel() for t in leaves) == 2_964_860_480


def test_attention_sites_follow_the_reference():
    """Layer i hits when (i + 1) % attn_every == 0: the smoke config's
    layers 1 and 3, the published config's 9 sites of 54 layers."""
    assert hybrid._attn_flags(get(NAME, smoke=True).cfg) == (
        [False, True, False, True], [0, 0, 0, 1], 2)
    flags, slots, n = hybrid._attn_flags(get(NAME).cfg)
    assert n == 9 and [i for i, f in enumerate(flags) if f] == list(range(5, 54, 6))
    assert [slots[i] for i in range(5, 54, 6)] == list(range(9))


def test_init_distributions_are_the_references():
    """Products at 1/√d_in, the conv at 0.1; A_log and dt_bias 0, D 1; every
    norm scale 0."""
    arch = Arch(cfg=dataclasses.replace(get(NAME, smoke=True).cfg, d_model=256), module=hybrid)
    params = arch.init(torch.Generator().manual_seed(3))
    d = arch.cfg.d_model
    mamba, shared = params["layers"]["mamba"], params["shared"]
    for w, want in ((mamba["w_in"], 1 / np.sqrt(d)), (mamba["conv"], 0.1),
                    (mamba["w_out"], 1 / np.sqrt(2 * d)), (shared["attn"]["wq"], 1 / np.sqrt(d)),
                    (shared["mlp"]["wo"], 1 / np.sqrt(arch.cfg.d_ff))):
        assert abs(w.float().std().item() / want - 1.0) < 0.03
    assert not mamba["A_log"].any() and not mamba["dt_bias"].any()
    assert bool((mamba["D"] == 1).all())
    assert not params["layers"]["ln"]["scale"].any()
    assert not any(shared[n]["scale"].any() for n in ("ln1", "ln2"))
    assert not params["ln_f"]["scale"].any()


def test_init_draws_in_the_references_order():
    """The embedding, each backbone layer's Mamba2 in order, the shared
    attention, the shared MLP, from one generator; the layers stacked."""
    arch = get(NAME, smoke=True)
    cfg = arch.cfg
    params = arch.init(torch.Generator().manual_seed(6))
    gen = torch.Generator().manual_seed(6)
    emb = ly.init_embedding(gen, cfg, CPU)
    layers = [ssm.init_mamba2(gen, cfg, CPU) for _ in range(cfg.n_layers)]
    attn, mlp = ly.init_attention(gen, cfg, CPU), ly.init_mlp(gen, cfg, CPU)
    want = {"embedding": emb,
            "layers": {"ln": params["layers"]["ln"],
                       "mamba": tree_map(lambda *t: torch.stack(t), *layers)},
            "shared": {**params["shared"], "attn": attn, "mlp": mlp},
            "ln_f": params["ln_f"]}
    for (path, got), (_, w) in zip(tree_flatten(params), tree_flatten(want), strict=True):
        assert torch.equal(got, w), path


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    arch = get(NAME, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arch.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arch.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(arch, ShapeSpec("t", "train", seq=8, batch=1), MemoryStore())
    assert all(t.device.type == "meta" for t in tree_leaves(arch.init_cache(2, 8, "meta")))


# -- trees ------------------------------------------------------------------------------


def test_tree_treats_none_as_an_empty_subtree():
    """As ``jax.tree_util``: a ``None`` (the conv buffer after a 2-token
    prompt) holds no leaf, survives ``tree_map`` and is rebuilt by
    ``tree_unflatten``."""
    tree = {"mamba": (None, torch.ones(2), torch.zeros(3)), "pos": torch.tensor(5),
            "blocks": [None, {"a": torch.ones(1)}]}
    ref = jax.tree.map(np.asarray, tree)
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    got = tree_flatten(tree)
    assert [p for p, _ in got] == [tuple(_path(k) for k in p) for p, _ in want]
    assert tree_flatten(None) == [] and tree_leaves({"x": None}) == []
    doubled = tree_map(lambda t: 2 * t, tree)
    assert doubled["mamba"][0] is None and doubled["blocks"][0] is None
    assert float(doubled["mamba"][1][0]) == 2.0
    summed = tree_map(lambda a, b: a + b, tree, doubled)
    assert summed["mamba"][0] is None and float(summed["pos"]) == 15
    back = tree_unflatten(tree, [t for _, t in got])
    assert back["mamba"][0] is None and back["blocks"][0] is None
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(tree), strict=True))


# -- serving: prefill, decode, continuation -------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_three_decode_steps_match_reference(dtype):
    """Logits and the whole cache after a prefill of 20 tokens (chunks of 8:
    padded; the 8-slot KV ring wrapped) and 3 decode steps."""
    ref, port, rp, pp = _pair(dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    B, S = 2, 20
    toks = rng.integers(0, ref.cfg.vocab, size=(B, S)).astype(np.int32)
    rl, rc = ref.prefill(rp, {"tokens": jnp.asarray(toks)}, max_seq=S + 4)
    pl, pc = port.prefill(pp, {"tokens": torch.from_numpy(toks)}, max_seq=S + 4)
    assert pl.shape == (B, 1, ref.cfg.vocab) and pl.dtype == torch.float32
    assert pc["k"].shape == (2, B, 8, 4, 16)
    _close(pl, rl, tol, "prefill logits")
    _assert_cache(pc, rc, tol, "prefill")
    for step in range(3):
        nxt = rng.integers(0, ref.cfg.vocab, size=(B, 1)).astype(np.int32)
        rl, rc = ref.decode_step(rp, jnp.asarray(nxt), rc)
        pl, pc = port.decode_step(pp, torch.from_numpy(nxt), pc)
        _close(pl, rl, tol, f"decode step {step} logits")
        _assert_cache(pc, rc, tol, f"decode step {step}")


@pytest.mark.parametrize("S", [3, 5])
def test_prefill_tokens_and_init_cache_match_reference(S):
    """The fused-serving contract (tokens only) from the shortest prompts
    that leave a conv buffer, a decode step after it, and an empty cache
    sized min(max_seq, local_window)."""
    ref, port, rp, pp = _pair("float32")
    rng = np.random.default_rng(4 + S)
    toks = rng.integers(0, ref.cfg.vocab, size=(2, S)).astype(np.int32)
    rl, rc = ref.prefill_tokens(rp, jnp.asarray(toks), max_seq=64)
    pl, pc = port.prefill_tokens(pp, torch.from_numpy(toks), max_seq=64)
    _close(pl, rl, 1e-4, "logits")
    _assert_cache(pc, rc, 1e-4, "prefill_tokens")
    nxt = rng.integers(0, ref.cfg.vocab, size=(2, 1)).astype(np.int32)
    rl, rc = ref.decode_step(rp, jnp.asarray(nxt), rc)
    pl, pc = port.decode_step(pp, torch.from_numpy(nxt), pc)
    _close(pl, rl, 1e-4, "decode logits")
    _assert_cache(pc, rc, 1e-4, "decode")
    for max_seq in (4, 64):
        _assert_cache(port.init_cache(3, max_seq, device="cpu"), ref.init_cache(3, max_seq), 0.0,
                      f"init_cache {max_seq}")


def test_two_token_prompt_leaves_no_conv_buffer_and_decode_raises():
    """A prompt shorter than ssm_conv − 1: the reference's cache has a None
    conv buffer and its decode fails; the port's cache has the None and its
    decode raises a clear error."""
    ref, port, rp, pp = _pair("float32")
    toks = np.random.default_rng(5).integers(0, ref.cfg.vocab, size=(2, 2)).astype(np.int32)
    rl, rc = ref.prefill(rp, {"tokens": jnp.asarray(toks)}, max_seq=8)
    pl, pc = port.prefill(pp, {"tokens": torch.from_numpy(toks)}, max_seq=8)
    assert rc["mamba"][0] is None and pc["mamba"][0] is None
    _close(pl, rl, 1e-4, "logits")
    _close(pc["mamba"][1], rc["mamba"][1], 1e-4, "S state")
    with pytest.raises(ValueError, match="conv buffer"):
        port.decode_step(pp, torch.from_numpy(toks[:, :1]), pc)


def test_decode_matches_prefill_continuation():
    """Decoding token S after prefill[0:S] matches prefill[0:S+1]'s last
    logits (``tests/test_arch_smoke.py``'s teacher-forcing check, bfloat16,
    its 0.08 bar), on the port alone; S = 12 > the window of 8."""
    arch = get(NAME, smoke=True)
    params = arch.init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    B, S = 2, 12
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, size=(B, S + 1)).astype(np.int32))
    _, cache = arch.prefill(params, {"tokens": toks[:, :S]}, max_seq=S + 4)
    step_logits, _ = arch.decode_step(params, toks[:, S:S + 1], cache)
    full_logits, _ = arch.prefill(params, {"tokens": toks}, max_seq=S + 4)
    assert torch.isfinite(step_logits).all()
    np.testing.assert_allclose(step_logits.numpy(), full_logits.numpy(), rtol=0.08, atol=0.08)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["decode_step", "greedy_step"])
def test_decode_into_a_given_stack_equals_the_fresh_stack(dtype, path):
    """Eight greedy decode steps advance the Mamba2 stack they are given in
    place, through the family's ``decode_step`` or ``greedy_step`` on a
    CPU ``DecodeBucket``: the stack keeps its storage, and the logits and
    the whole cache equal bit for bit those of ``decode_step`` run on a
    fresh copy of the cache at every step."""
    smoke = get(NAME, smoke=True)
    arch = Arch(cfg=dataclasses.replace(smoke.cfg, dtype=dtype), module=hybrid)
    params = arch.init(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, size=(2, 10)).astype(np.int32))
    logits, cache = arch.prefill(params, {"tokens": toks}, max_seq=24)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    fresh = tree_map(torch.clone, cache)
    bucket = DecodeBucket(arch, params, tok, cache)
    given = bucket.state if path == "greedy_step" else cache
    ptrs = [t.data_ptr() for t in given["mamba"]]
    for i in range(8):
        want, fresh = arch.decode_step(params, tok, tree_map(torch.clone, fresh))
        if path == "greedy_step":
            got = bucket.step()
        else:
            got, given = arch.decode_step(params, tok, given)
        tok = torch.argmax(want, dim=-1).to(torch.int32)
        assert [t.data_ptr() for t in given["mamba"]] == ptrs, i
        assert torch.equal(got, want), i
        cache_only = {k: v for k, v in given.items() if k != "tok"}
        for (where, g), (_, w) in zip(tree_flatten(cache_only), tree_flatten(fresh),
                                      strict=True):
            assert torch.equal(g, w), (i, where)
        if path == "greedy_step":
            assert torch.equal(given["tok"], tok), i


# -- training -------------------------------------------------------------------------


def _train_batch(cfg, seed=0, B=2, S=32):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, cfg.vocab, size=(B, S + 1))
    return {"tokens": stream[:, :S].astype(np.int32), "labels": stream[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of the
    reference's loss, the shared block's gradient (summed over its 2 sites)
    included, to the module's stated tolerances."""
    ref, port, rp, pp = _pair(dtype)
    batch = _train_batch(ref.cfg)
    rl, rg = jax.value_and_grad(ref.train_loss)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    pl, pg = value_and_grad(port, pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert pl.dtype == torch.float32 and pl.shape == ()
    assert _rel(pl, rl) <= LOSS_TOL[dtype]
    got, want = _named(pg), _named(rg)
    assert sorted(got) == sorted(want) and "shared/attn/wq" in want
    for name in want:
        assert str(got[name].dtype).removeprefix("torch.") == str(want[name].dtype), name
        g, w = _np(got[name]), _np(want[name])
        assert np.linalg.norm(g - w) <= GRAD_TOL[dtype] * np.linalg.norm(w) + 1e-12, name


def test_train_step_at_the_published_chunk_has_finite_gradients():
    """At the published chunk of 256 over 512 positions, a chunk's decay
    (dt·A summed) passes e^88: the loss equals the reference's (1e-5) and
    every gradient leaf is finite (the reference's own decay gradient is NaN
    there, ``tests/test_torch_ssm.py``)."""
    ref, port, rp, pp = _pair("float32", ssm_chunk=256, n_layers=2)
    batch = _train_batch(ref.cfg, seed=4, B=1, S=512)
    rl = ref.train_loss(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    pl, pg = value_and_grad(port, pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(pl, rl) <= 1e-5
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(pg))


def test_three_trainer_steps_match_reference():
    """The reference's ``Trainer`` and the port's in float32 on the
    reference's parameters: each step's loss and grad norm and the final
    parameters to 1e-4 relative (AdamW eps 1e-3, as
    ``tests/test_torch_families.py`` runs it)."""
    ref, port, _, _ = _pair("float32")
    shape = (32, 2)
    opt = dict(lr=1e-3, eps=1e-3)
    t_ref = RefTrainer(ref, RefShapeSpec("t", "train", *shape), RefMemoryStore(),
                       cfg=RefTrainerConfig(total_steps=3, ckpt_every=3, log_every=1,
                                            opt=RefAdamWConfig(**opt)), ckpt_prefix="r")
    t = Trainer(port, ShapeSpec("t", "train", *shape), MemoryStore(),
                cfg=TrainerConfig(total_steps=3, ckpt_every=3, log_every=1,
                                  opt=AdamWConfig(**opt)), ckpt_prefix="p", device="cpu")
    t.params = params_from_numpy(jax.tree.map(np.asarray, t_ref.params), CPU)
    t.opt_state = init_opt_state(t.params)
    want, got = t_ref.run(), t.run()
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert _rel(g["loss"], w["loss"]) <= 1e-4
        assert _rel(g["grad_norm"], w["grad_norm"]) <= 1e-4
    got, want = _named(t.params), _named(t_ref.params)
    for name in want:
        g, w = _np(got[name]), _np(want[name])
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), name


def test_trainer_restart_from_six_of_eight_strips_is_bit_equal():
    """6 steps straight against 3 + a restart from the store with strips 0
    and 2 of every leaf lost + 3: the same final loss, bit for bit; the
    restored tree keeps the float32 A_log, D and dt_bias."""
    arch = get(NAME, smoke=True)
    shape = ShapeSpec("t", "train", seq=16, batch=2)
    tc = TrainerConfig(total_steps=6, ckpt_every=3, log_every=1, opt=AdamWConfig(lr=1e-3))
    log_a = Trainer(arch, shape, MemoryStore(), cfg=tc, ckpt_prefix="a", device="cpu").run()
    store = MemoryStore()
    Trainer(arch, shape, store, cfg=tc, ckpt_prefix="b", device="cpu").run(steps=3)
    faulty = FaultyStore(store)
    lost = [key for key in store.keys() if key.endswith(("strip0", "strip2"))]
    assert lost
    for key in lost:
        faulty.lose_object(key)
    t_b = Trainer(arch, shape, faulty, cfg=tc, ckpt_prefix="b", device="cpu")
    assert t_b.start_step == 3
    mamba = t_b.params["layers"]["mamba"]
    assert mamba["A_log"].dtype == mamba["D"].dtype == torch.float32
    assert mamba["w_in"].dtype == torch.bfloat16
    log_b = t_b.run(steps=3)
    assert log_b[-1]["step"] == 6
    assert log_a[-1]["loss"] == log_b[-1]["loss"]


def test_checkpoint_strips_and_leaf_names_equal_the_references():
    """A bfloat16 training state of the smoke config: every object of one
    checkpoint byte for byte, leaves named as the reference names them."""
    ref, _, rp, _ = _pair("bfloat16", seed=3)
    rp = jax.tree.map(np.asarray, rp)
    rng = np.random.default_rng(0)
    mom = lambda: jax.tree.map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), rp)
    ref_tree = {"params": rp, "opt": {"m": mom(), "v": mom(), "step": np.int32(7)}}
    port_tree = params_from_numpy(ref_tree, CPU)
    ref_store, store = RefMemoryStore(), MemoryStore()
    want = ref_save(ref_store, "ck", 9, ref_tree, n_max=8, k_max=4)
    got = save_checkpoint(store, "ck", 9, port_tree, n_max=8, k_max=4, codec=CODEC)
    assert got == want
    assert sorted(store.keys()) == sorted(ref_store.keys())
    for key in ref_store.keys():
        assert store.get(key) == ref_store.get(key), key
    leaves = json.loads(store.get("ck/step9/MANIFEST"))["leaves"]
    assert leaves["params/layers/mamba/A_log"]["dtype"] == "float32"
    assert leaves["params/shared/attn/wq"]["dtype"] == "bfloat16"
    assert "opt/v/layers/mamba/conv" in leaves


# -- the closed loop ----------------------------------------------------------------

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
REF_CLS = RefRequestClass("read3mb", 3.0, REF_READ, k_max=6, r_max=2.0, n_max=12)
PROMPT_LEN = 16


def test_closed_loop_matches_reference():
    """Two rounds of both closed loops over the same stored prompts, in
    float32: the same tokens, read codes, controller picks fed to the write
    policy and one bucket; the port's tokens equal its
    ``ServingEngine.generate``'s."""
    steps, n_keys = 4, 4
    ref, port, rp, pp = _pair("float32", seed=2)
    max_seq = PROMPT_LEN + steps
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    ref_layout = RefSharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store, ref_store = MemoryStore(), RefMemoryStore()
    truth = np.random.default_rng(6).integers(
        0, ref.cfg.vocab, size=(n_keys, PROMPT_LEN)).astype(np.int32)
    keys = [f"p/{i}" for i in range(n_keys)]
    for key, toks in zip(keys, truth):
        ServingEngine.store_prompt(store, key, layout, toks, codec=CODEC)
        RefServingEngine.store_prompt(ref_store, key, ref_layout, toks)
    engine = ServingEngine(port, pp, max_seq=max_seq)
    write_pol = FeedbackPolicy(layout.N, layout.K)
    proxy = Proxy(store, StaticPolicy(8, 4), L=8, codec=CODEC, write_policy=write_pol)
    server = ClosedLoopServer(engine, proxy, layout,
                              FusedServingStep.for_policy(ServePolicy.tofec(), CLS, 16,
                                                          codec=CODEC),
                              prompt_len=PROMPT_LEN)
    ref_write_pol = RefFeedbackPolicy(ref_layout.N, ref_layout.K)
    ref_proxy = RefProxy(ref_store, RefStaticPolicy(8, 4), L=8, write_policy=ref_write_pol)
    ref_step = RefFusedServingStep.for_policy(RefServePolicy.tofec(), REF_CLS, 16,
                                              codec=RefCodec("jnp"))
    ref_server = RefClosedLoopServer(RefServingEngine(ref, rp, max_seq=max_seq), ref_proxy,
                                     ref_layout, ref_step, prompt_len=PROMPT_LEN)
    try:
        for r in range(2):
            got = server.serve_round(keys, steps=steps)
            want = ref_server.serve_round(keys, steps=steps)
            assert got.ok == want.ok == [True] * n_keys
            assert got.codes == want.codes
            assert got.next_code == want.next_code == write_pol.code == ref_write_pol.code, r
            np.testing.assert_array_equal(got.tokens, want.tokens)
            np.testing.assert_array_equal(got.tokens, engine.generate(truth, steps))
        assert server.traces == ref_server.traces == 1
    finally:
        proxy.close()
        ref_proxy.close()
