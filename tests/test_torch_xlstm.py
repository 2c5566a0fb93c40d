"""The port's xLSTM LM (``repro_torch.models.xlstm``, the ssm family)
against the reference's on the CPU, at the xlstm-350m smoke config (3
layers: mLSTM, mLSTM, sLSTM): init, loss and gradients, prefill and decode
with their caches, the closed loop, training and checkpoints.

Parameters come from the reference's ``arch.init(jax.random.key(s))`` and
are carried across with ``params_from_numpy``; token ids are drawn with
numpy. Tolerances: 1e-4 in float32 (the two frameworks sum in different
orders), the reference's own 0.08 in bfloat16 (its xlstm smoke tests pass
on the CPU's jax, so it is the oracle in bfloat16 too); losses to 1e-5
relative and each gradient leaf's difference to 1e-4 of its norm."""

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
from repro_torch.models import layers as ly
from repro_torch.models import ssm, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import Arch
from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
from repro_torch.storage import FaultyStore, MemoryStore, Proxy
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig, init_opt_state
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

CPU = torch.device("cpu")
CODEC = Codec("kernel", device=CPU)
NAME = "xlstm-350m"
TOL = {"float32": 1e-4, "bfloat16": 0.08}


def _pair(dtype, seed=1, **changes):
    """(reference arch, port arch, reference params, port params) at the
    smoke config in ``dtype``."""
    ref = ref_get(NAME, smoke=True)
    cfg = dataclasses.replace(ref.cfg, dtype=dtype, **changes)
    port = Arch(cfg=ModelConfig(**dataclasses.asdict(cfg)), module=xlstm)
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
    """{"a/0/b": float64 array} of a reference (jax/numpy) or port tree."""
    return {"/".join(str(_path(p)) for p in path): _np(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_cache(pc, rc, tol, what):
    """Every state leaf of every block (tuples in the reference's order),
    and the position."""
    assert sorted(pc) == sorted(rc) == ["pos", "states"]
    assert len(pc["states"]) == len(rc["states"])
    for i, (ps, rs) in enumerate(zip(pc["states"], rc["states"])):
        assert isinstance(ps, tuple) and len(ps) == len(rs)
        for j, (p, r) in enumerate(zip(ps, rs)):
            assert str(p.dtype).removeprefix("torch.") == str(r.dtype), (i, j)
            _close(p, r, tol, f"{what}: block {i} state {j}")
    assert pc["pos"].dtype == torch.int32 and int(pc["pos"]) == int(rc["pos"])


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / abs(float(b))


# -- registry and init ----------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_init_shapes_and_dtypes_match_eval_shape(smoke):
    """The reference's tree: embedding, a block list of mLSTM and sLSTM
    cells, ln_f. At the published width (on the meta device) 159 leaves and
    499,729,552 parameters."""
    ref = ref_get(NAME, smoke=smoke)
    arch = get(NAME, smoke=smoke)
    assert arch.cfg == ModelConfig(**dataclasses.asdict(ref.cfg)) and arch.module is xlstm
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jax.eval_shape(ref.init, jax.random.key(0)))
    params = arch.init(torch.Generator().manual_seed(0)) if smoke else arch.init(device="meta")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), params)
    assert got == want
    cells = ["s" if "r_h" in blk["cell"] else "m" for blk in params["blocks"]]
    assert cells == ["s" if (i + 1) % arch.cfg.slstm_every == 0 else "m"
                     for i in range(arch.cfg.n_layers)]
    if not smoke:
        leaves = tree_leaves(params)
        assert len(leaves) == 159
        assert sum(t.numel() for t in leaves) == 499_729_552
        assert cells.count("s") == 6


def test_init_distributions_are_the_references():
    """r_h at 0.5/√d, the other products at 1/√d_in; b_if's input half 0
    and forget half 3; the sLSTM bias and every norm scale 0."""
    arch = Arch(cfg=dataclasses.replace(get(NAME, smoke=True).cfg, d_model=256), module=xlstm)
    params = arch.init(torch.Generator().manual_seed(3))
    d, H = arch.cfg.d_model, arch.cfg.n_heads
    mblk, sblk = params["blocks"][0]["cell"], params["blocks"][2]["cell"]
    for w, want in ((sblk["r_h"], 0.5 / np.sqrt(d)), (sblk["w_x"], 1 / np.sqrt(d)),
                    (mblk["w_qkv"], 1 / np.sqrt(2 * d)), (mblk["w_down"], 1 / np.sqrt(2 * d))):
        assert abs(w.float().std().item() / want - 1.0) < 0.03
    assert torch.equal(mblk["b_if"], torch.tensor([0.0] * H + [3.0] * H, dtype=torch.bfloat16))
    assert not sblk["b"].any()
    assert not any(blk["ln"]["scale"].any() for blk in params["blocks"])
    assert not params["ln_f"]["scale"].any()


def test_init_draws_block_after_block_from_the_generator():
    """The embedding, then each block's cell in order, from one generator."""
    arch = get(NAME, smoke=True)
    params = arch.init(torch.Generator().manual_seed(6))
    gen = torch.Generator().manual_seed(6)
    emb = ly.init_embedding(gen, arch.cfg, CPU)
    cells = [ssm.init_mlstm(gen, arch.cfg, CPU), ssm.init_mlstm(gen, arch.cfg, CPU),
             ssm.init_slstm(gen, arch.cfg, CPU)]
    want = {"embedding": emb, "blocks": [{"ln": blk["ln"], "cell": c}
                                         for blk, c in zip(params["blocks"], cells)],
            "ln_f": params["ln_f"]}
    for (path, got), (_, w) in zip(tree_flatten(params), tree_flatten(want)):
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


def test_tree_walks_a_tuple_cache_in_jax_order():
    """The cache's (h, c, n, m) and (S, n) tuples flatten by index, as
    ``jax.tree_util`` does; ``tree_map`` and ``tree_unflatten`` give tuples
    back."""
    ref = ref_get(NAME, smoke=True)
    want = jax.tree_util.tree_flatten_with_path(ref.init_cache(2, 8))[0]
    cache = get(NAME, smoke=True).init_cache(2, 8, device="cpu")
    got = tree_flatten(cache)
    assert [p for p, _ in got] == [tuple(_path(k) for k in p) for p, _ in want]
    assert [tuple(t.shape) for _, t in got] == [tuple(a.shape) for _, a in want]
    doubled = tree_map(lambda t: 2 * t, cache)
    assert isinstance(doubled["states"][2], tuple) and len(doubled["states"][2]) == 4
    assert float(doubled["states"][2][3][0, 0]) == -60.0
    back = tree_unflatten(cache, [t for _, t in got])
    assert all(isinstance(s, tuple) for s in back["states"])
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(cache)))


# -- serving: prefill, decode, continuation -------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_three_decode_steps_match_reference(dtype):
    """Logits and every cache state after a prefill of 20 tokens (chunks of
    8: padded) and 3 decode steps."""
    ref, port, rp, pp = _pair(dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    B, S = 2, 20
    toks = rng.integers(0, ref.cfg.vocab, size=(B, S)).astype(np.int32)
    rl, rc = ref.prefill(rp, {"tokens": jnp.asarray(toks)}, max_seq=S + 4)
    pl, pc = port.prefill(pp, {"tokens": torch.from_numpy(toks)}, max_seq=S + 4)
    assert pl.shape == (B, 1, ref.cfg.vocab) and pl.dtype == torch.float32
    _close(pl, rl, tol, "prefill logits")
    _assert_cache(pc, rc, tol, "prefill")
    for step in range(3):
        nxt = rng.integers(0, ref.cfg.vocab, size=(B, 1)).astype(np.int32)
        rl, rc = ref.decode_step(rp, jnp.asarray(nxt), rc)
        pl, pc = port.decode_step(pp, torch.from_numpy(nxt), pc)
        _close(pl, rl, tol, f"decode step {step} logits")
        _assert_cache(pc, rc, tol, f"decode step {step}")


def test_prefill_tokens_and_init_cache_match_reference():
    """The fused-serving contract (tokens only; the ssm family has no
    extras) and an empty cache, state for state."""
    ref, port, rp, pp = _pair("float32")
    toks = np.random.default_rng(4).integers(0, ref.cfg.vocab, size=(2, 9)).astype(np.int32)
    rl, rc = ref.prefill_tokens(rp, jnp.asarray(toks), max_seq=64)
    pl, pc = port.prefill_tokens(pp, torch.from_numpy(toks), max_seq=64)
    _close(pl, rl, 1e-4, "logits")
    _assert_cache(pc, rc, 1e-4, "prefill_tokens")
    _assert_cache(port.init_cache(3, 64, device="cpu"), ref.init_cache(3, 64), 0.0, "init")


def test_decode_matches_prefill_continuation():
    """Decoding token S after prefill[0:S] matches prefill[0:S+1]'s last
    logits (``tests/test_arch_smoke.py``'s teacher-forcing check, bfloat16,
    its 0.08 bar), on the port alone."""
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


# -- training -------------------------------------------------------------------------


def _train_batch(cfg, seed=0, B=2, S=32):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, cfg.vocab, size=(B, S + 1))
    return {"tokens": stream[:, :S].astype(np.int32), "labels": stream[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype):
    """The loss to 1e-5 relative and every gradient leaf to 1e-4 of its norm
    in float32; the bfloat16 loss to 1e-3 relative (a few bfloat16
    activations one rounding apart move the mean CE by ~1e-4)."""
    ref, port, rp, pp = _pair(dtype)
    batch = _train_batch(ref.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if dtype == "bfloat16":
        assert _rel(port.train_loss(pp, tb), ref.train_loss(rp, jb)) <= 1e-3
        return
    rl, rg = jax.value_and_grad(ref.train_loss)(rp, jb)
    pl, pg = value_and_grad(port, pp, tb)
    assert pl.dtype == torch.float32 and pl.shape == ()
    assert _rel(pl, rl) <= 1e-5
    got, want = _named(pg), _named(rg)
    assert sorted(got) == sorted(want) and "blocks/2/cell/r_h" in want
    for name in want:
        diff = np.linalg.norm(got[name] - want[name])
        assert diff <= 1e-4 * np.linalg.norm(want[name]) + 1e-12, name


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
        assert np.linalg.norm(got[name] - want[name]) <= 1e-4 * np.linalg.norm(want[name]), name


def test_trainer_restart_from_six_of_eight_strips_is_bit_equal():
    """6 steps straight against 3 + a restart from the store with strips 0
    and 2 of every leaf lost + 3: the same final loss, bit for bit, and the
    restored block list keeps its two kinds of cell."""
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
    assert t_b.start_step == 3 and isinstance(t_b.params["blocks"], list)
    assert "r_h" in t_b.params["blocks"][2]["cell"] and "w_qkv" in t_b.params["blocks"][0]["cell"]
    log_b = t_b.run(steps=3)
    assert log_b[-1]["step"] == 6
    assert log_a[-1]["loss"] == log_b[-1]["loss"]


def test_checkpoint_strips_and_leaf_names_equal_the_references():
    """A bfloat16 training state of the smoke config at 4 layers with an
    sLSTM every 4th (the published pattern, so ``params/blocks/3/cell/r_h``
    is the sLSTM's): every object of one checkpoint byte for byte."""
    ref, _, rp, pp = _pair("bfloat16", seed=3, n_layers=4, slstm_every=4)
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
    assert leaves["params/blocks/3/cell/r_h"]["dtype"] == "bfloat16"
    assert "params/blocks/0/cell/w_qkv" in leaves and "opt/m/blocks/3/cell/b" in leaves


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
