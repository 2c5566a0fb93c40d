"""The port's training path (``repro_torch.models.lm.train_loss``,
``repro_torch.train``) against the reference's on the CPU, at the dense
smoke configs.

Parameters come from the reference's ``arch.init(jax.random.key(s))`` and
are carried across with ``params_from_numpy``; tokens, gradients and
optimizer states are drawn with numpy. Tolerances (float32 on two
frameworks that sum in different orders): the loss to 1e-5 relative, each
gradient leaf's difference to 1e-4 of its norm, AdamW to 1e-6 relative,
three trainer steps to 1e-4 relative (losses; each parameter leaf's
difference to 1e-4 of its norm); bfloat16 losses to 2e-2 relative.
Mirrors the training tests of ``tests/test_train_ckpt.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get as ref_get
from repro.models import layers as ref_ly
from repro.models import lm as ref_lm
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.models.registry import Arch as RefArch
from repro.storage import MemoryStore as RefMemoryStore
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.train_step import abstract_state as ref_abstract_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.data import SyntheticTokens
from repro_torch.models import get, params_from_numpy
from repro_torch.models import layers as ly
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.models.registry import Arch
from repro_torch.storage import MemoryStore
from repro_torch.train import (
    AdamWConfig,
    Trainer,
    TrainerConfig,
    abstract_state,
    adamw_update,
    init_opt_state,
    make_train_step,
)
from repro_torch.train.optimizer import global_norm
from repro_torch.train.train_step import make_eval_step, value_and_grad
from repro_torch.tree import tree_flatten, tree_map

CPU = torch.device("cpu")
DENSE = ["gemma2-2b", "mistral-nemo-12b", "yi-6b", "qwen1.5-0.5b"]
SHAPE = ShapeSpec("tiny_train", "train", seq=32, batch=2)
REF_SHAPE = RefShapeSpec("tiny_train", "train", seq=32, batch=2)


def _pair(name, dtype, seed=1, **changes):
    """(reference arch, port arch, reference params, port params) at the
    smoke config in ``dtype``."""
    ref = ref_get(name, smoke=True)
    cfg = dataclasses.replace(ref.cfg, dtype=dtype, **changes)
    ref = RefArch(cfg=cfg, module=ref.module)
    port = Arch(cfg=ModelConfig(**dataclasses.asdict(cfg)), module=get(name, smoke=True).module)
    rp = ref.init(jax.random.key(seed))
    return ref, port, rp, params_from_numpy(jax.tree.map(np.asarray, rp), CPU)


def _batch(cfg, seed=0, B=2, S=32):
    stream = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S + 1))
    return {"tokens": stream[:, :S].astype(np.int32), "labels": stream[:, 1:].astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _named(tree):
    """{"a/b": float64 array} of a reference (jax/numpy) or port tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = leaf.to(torch.float64).numpy() if isinstance(leaf, torch.Tensor) else np.asarray(
            leaf).astype(np.float64)
        out["/".join(str(p.key) for p in path)] = a
    return out


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / abs(float(b))


def _assert_leaves(got, want, tol=1e-4):
    """Each leaf's difference at most ``tol`` of its norm."""
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for name in want:
        diff = np.linalg.norm(got[name] - want[name])
        assert diff <= tol * np.linalg.norm(want[name]) + 1e-12, name


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_gradients_match_reference_float32(name):
    ref, port, rp, pp = _pair(name, "float32")
    batch = _batch(ref.cfg)
    rl, rg = jax.value_and_grad(ref.train_loss)(rp, _j(batch))
    pl, pg = value_and_grad(port, pp, _t(batch))
    assert pl.dtype == torch.float32 and pl.shape == ()
    assert _rel(pl, rl) <= 1e-5
    _assert_leaves(pg, rg)


@pytest.mark.parametrize("name", DENSE)
def test_loss_matches_reference_bfloat16(name):
    ref, port, rp, pp = _pair(name, "bfloat16")
    batch = _batch(ref.cfg, seed=2)
    rl = ref.train_loss(rp, _j(batch))
    pl = port.train_loss(pp, _t(batch))
    assert _rel(pl, rl) <= 2e-2


def test_chunked_loss_over_several_chunks_matches_reference(monkeypatch):
    """Four 8-token chunks (``LOSS_CHUNK`` cut in both packages): the sum
    of the chunks in order, and its gradient through the checkpointed
    chunks."""
    monkeypatch.setattr(ref_lm, "LOSS_CHUNK", 8)
    monkeypatch.setattr(lm, "LOSS_CHUNK", 8)
    ref, port, rp, pp = _pair("gemma2-2b", "float32")  # logit softcap on
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, ref.cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, ref.cfg.vocab, (2, 32)).astype(np.int32)
    rl, (rgp, rgx) = jax.value_and_grad(
        lambda p, xx: ref_lm.chunked_ce_loss(p, ref.cfg, xx, jnp.asarray(labels)),
        argnums=(0, 1))(rp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    emb = tree_map(lambda t: t.detach().requires_grad_(), pp["embedding"])
    pl = lm.chunked_ce_loss({"embedding": emb}, port.cfg, xt, torch.from_numpy(labels))
    gx, gh = torch.autograd.grad(pl, [xt, emb["head"]])
    assert _rel(pl, rl) <= 1e-5
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), rtol=1e-4, atol=1e-7)
    _assert_leaves({"head": gh}, {"head": rgp["embedding"]["head"]})


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(5)
    logit = (rng.standard_normal((2, 7, 33)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    want = ref_ly.cross_entropy(jnp.asarray(logit), jnp.asarray(labels))
    got = ly.cross_entropy(torch.from_numpy(logit), torch.from_numpy(labels))
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("window,softcap", [(None, None), (12, None), (None, 50.0), (12, 50.0)])
def test_backward_through_chunked_attention_matches_reference(window, softcap):
    """q, k, v gradients of a weighted sum of the output, S = 40 over
    8 × 8 chunks (band slicing for the window, padded keys)."""
    ref_cfg = dataclasses.replace(ref_get("gemma2-2b", smoke=True).cfg, attn_q_chunk=8,
                                  attn_kv_chunk=8, dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 40, h, 16)).astype(np.float32) for h in (4, 2, 2))
    w = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)

    def ref_f(q, k, v):
        out = ref_ly.chunked_attention(ref_cfg, q, k, v, causal=True, window=window,
                                       softcap=softcap)
        return jnp.sum(out * w)

    want = jax.grad(ref_f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ly.chunked_attention(cfg, qt, kt, vt, window=window, softcap=softcap)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), [qt, kt, vt])
    for g, r in zip(got, want):
        r = np.asarray(r)
        assert np.linalg.norm(g.numpy() - r) <= 1e-4 * np.linalg.norm(r)


def test_attention_with_autograd_gives_the_inference_values():
    """The out-of-place path (grad on) and the in-place one (inference)
    give the same bits, so the serving tests' values are unchanged."""
    cfg = dataclasses.replace(get("gemma2-2b", smoke=True).cfg, attn_q_chunk=8, attn_kv_chunk=8)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, h, 16)).astype(np.float32))
               for h in (4, 2, 2))
    with torch.inference_mode():
        want = ly.chunked_attention(cfg, q, k, v, window=10, softcap=50.0)
    got = ly.chunked_attention(cfg, q.clone().requires_grad_(), k, v, window=10, softcap=50.0)
    assert got.requires_grad and torch.equal(got.detach(), want)


@pytest.mark.parametrize("clip", [1e3, 0.05], ids=["clip_inactive", "clip_active"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(clip, dtype):
    """Two updates from the same numpy params, grads and state (step 4
    and 5), both ways of the clip; float32 to 1e-6 relative.

    With bfloat16 gradients XLA's float32 sum of squares lands ~1e-6 off
    the exact one (the port's within 1e-8: held against float64 here), so
    the bfloat16 cases hold the norm and moments to 1e-5 and the
    parameters, rounded once to bfloat16, to one bfloat16 ulp (2^-7)."""
    ref, port, rp, pp = _pair("qwen1.5-0.5b", dtype)
    rng = np.random.default_rng(8)
    leaves = tree_flatten(pp)
    grads_np = [rng.standard_normal(t.shape).astype(np.float32) * 0.3 for _, t in leaves]
    m_np = [rng.standard_normal(t.shape).astype(np.float32) * 0.01 for _, t in leaves]
    v_np = [np.abs(rng.standard_normal(t.shape)).astype(np.float32) * 1e-4 for _, t in leaves]

    def ref_tree(arrs, dt):
        return jax.tree.unflatten(jax.tree.structure(rp), [jnp.asarray(a, dt) for a in arrs])

    def port_tree(arrs, dt):
        return jax.tree.unflatten(jax.tree.structure(rp),
                                  [torch.from_numpy(a).to(dt) for a in arrs])

    tol = 1e-6 if dtype == "float32" else 1e-5
    cfg = AdamWConfig(lr=1e-2, grad_clip=clip)
    ref_cfg = RefAdamWConfig(lr=1e-2, grad_clip=clip)
    r_state = {"m": ref_tree(m_np, jnp.float32), "v": ref_tree(v_np, jnp.float32),
               "step": jnp.int32(3)}
    p_state = {"m": port_tree(m_np, torch.float32), "v": port_tree(v_np, torch.float32),
               "step": torch.tensor(3, dtype=torch.int32)}
    rg, pg = ref_tree(grads_np, jnp.dtype(dtype)), port_tree(grads_np, ly.dt(port.cfg))
    exact = np.sqrt(sum(np.sum(t.to(torch.float64).numpy() ** 2) for _, t in tree_flatten(pg)))
    for _ in range(2):
        rp, r_state, rm = ref_adamw_update(rp, rg, r_state, ref_cfg)
        pp, p_state, pm = adamw_update(pp, pg, p_state, cfg)
        assert _rel(pm["grad_norm"], rm["grad_norm"]) <= tol
        assert _rel(pm["grad_norm"], exact) <= 1e-6
    assert int(p_state["step"]) == 5 and p_state["step"].dtype == torch.int32
    for what, got, want in (("params", pp, rp), ("m", p_state["m"], r_state["m"]),
                            ("v", p_state["v"], r_state["v"])):
        rtol = 2 ** -7 if what == "params" and dtype == "bfloat16" else tol
        got, want = _named(got), _named(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                       atol=rtol * np.abs(want[name]).max(),
                                       err_msg=f"{what}/{name}")


def test_global_norm_matches_reference():
    """The leaves' float32 sums of squares, summed in the reference's
    (sorted-key) order."""
    from repro.train.optimizer import global_norm as ref_global_norm

    rng = np.random.default_rng(12)
    tree = {name: rng.standard_normal(shape).astype(np.float32)
            for name, shape in (("b", (300, 7)), ("a", (5,)), ("c", (2, 64, 9)))}
    want = ref_global_norm(jax.tree.map(jnp.asarray, tree))
    got = global_norm(tree_map(torch.from_numpy, tree))
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-6


def test_init_opt_state_matches_reference_layout():
    ref, port, rp, pp = _pair("gemma2-2b", "bfloat16")
    state = init_opt_state(pp)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        {"m": rp, "v": rp, "step": jnp.int32(0)})
    want["m"] = want["v"] = jax.tree.map(lambda s: (s[0], "float32"), want["m"],
                                         is_leaf=lambda x: isinstance(x, tuple))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), state)
    assert got == want
    assert not any(t.any() for _, t in tree_flatten(state))


def test_abstract_state_is_meta_with_reference_shapes():
    ref = ref_get("qwen1.5-0.5b")
    params, opt = abstract_state(get("qwen1.5-0.5b"))
    ref_params, ref_opt = ref_abstract_state(ref)
    for got, want in ((params, ref_params), (opt, ref_opt)):
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch."),
                                      t.device.type), got)
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype), "meta"), want)
        assert got == want


def test_grad_accum_two_matches_one_and_reference():
    """Two microbatches of one row: the accumulated float32 gradient step
    equals the whole-batch step to 1e-4, and the reference's accumulated
    step. AdamW's eps is 1e-3 here: the key bias's gradient is zero up to
    rounding (softmax ignores a shift of every key), and at eps = 1e-8 its
    update would follow the rounding noise's sign."""
    ref, port, rp, pp = _pair("qwen1.5-0.5b", "float32", grad_accum=2)
    one = Arch(cfg=dataclasses.replace(port.cfg, grad_accum=1), module=port.module)
    batch = _batch(ref.cfg, seed=9)
    opt = AdamWConfig(lr=1e-2, eps=1e-3)
    p2, s2, m2 = make_train_step(port, opt)(tree_map(torch.clone, pp), init_opt_state(pp),
                                            _t(batch))
    p1, s1, m1 = make_train_step(one, opt)(tree_map(torch.clone, pp), init_opt_state(pp),
                                           _t(batch))
    rp2, _, rm2 = ref_make_train_step(ref, RefAdamWConfig(lr=1e-2, eps=1e-3))(
        rp, jax.tree.map(np.asarray, {"m": jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                                         rp),
                                      "v": jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                                        rp),
                                      "step": np.int32(0)}), _j(batch))
    assert _rel(m2["loss"], m1["loss"]) <= 1e-4
    assert _rel(m2["loss"], rm2["loss"]) <= 1e-5
    assert _rel(m2["grad_norm"], rm2["grad_norm"]) <= 1e-4
    _assert_leaves(p2, p1)
    _assert_leaves(p2, rp2)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_policies_give_the_nothing_policy_values(policy):
    ref, port, rp, pp = _pair("gemma2-2b", "float32")
    other = Arch(cfg=dataclasses.replace(port.cfg, remat_policy=policy), module=port.module)
    batch = _t(_batch(ref.cfg, seed=10))
    l0, g0 = value_and_grad(port, pp, batch)
    l1, g1 = value_and_grad(other, pp, batch)
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(tree_flatten(g0), tree_flatten(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=str(path))


def test_eval_step_is_the_loss_without_autograd():
    _, port, _, pp = _pair("yi-6b", "float32")
    batch = _t(_batch(port.cfg, seed=11))
    got = make_eval_step(port)(pp, batch)
    assert not got.requires_grad
    assert torch.equal(got, port.train_loss(pp, batch).detach())


def test_three_trainer_steps_match_reference():
    """The reference's ``Trainer`` and the port's, the reference's
    parameters carried across, float32: each step's loss and the final
    parameters to 1e-4 relative."""
    ref = ref_get("qwen1.5-0.5b", smoke=True)
    ref = RefArch(cfg=dataclasses.replace(ref.cfg, dtype="float32"), module=ref.module)
    port = Arch(cfg=ModelConfig(**dataclasses.asdict(ref.cfg)),
                module=get("qwen1.5-0.5b", smoke=True).module)
    t_ref = RefTrainer(ref, REF_SHAPE, RefMemoryStore(),
                       cfg=RefTrainerConfig(total_steps=3, ckpt_every=3, log_every=1,
                                            opt=RefAdamWConfig(lr=1e-3)), ckpt_prefix="r")
    t = Trainer(port, SHAPE, MemoryStore(),
                cfg=TrainerConfig(total_steps=3, ckpt_every=3, log_every=1,
                                  opt=AdamWConfig(lr=1e-3)), ckpt_prefix="p", device="cpu")
    t.params = params_from_numpy(jax.tree.map(np.asarray, t_ref.params), CPU)
    t.opt_state = init_opt_state(t.params)
    want, got = t_ref.run(), t.run()
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert _rel(g["loss"], w["loss"]) <= 1e-4
        assert _rel(g["grad_norm"], w["grad_norm"]) <= 1e-4
    _assert_leaves(t.params, t_ref.params)


def test_trainer_restart_resumes_identically():
    """Train 6 steps straight vs 3 + restart + 3: identical final loss."""
    arch = get("qwen1.5-0.5b", smoke=True)
    tc = TrainerConfig(total_steps=6, ckpt_every=3, log_every=1, opt=AdamWConfig(lr=1e-3))
    t_a = Trainer(arch, SHAPE, MemoryStore(), cfg=tc, ckpt_prefix="a", device="cpu")
    log_a = t_a.run()

    store_b = MemoryStore()
    t_b = Trainer(arch, SHAPE, store_b, cfg=tc, ckpt_prefix="b", device="cpu")
    t_b.run(steps=3)
    from repro_torch.ckpt import latest_step

    assert latest_step(store_b, "b") == 3
    # Simulate crash: rebuild the trainer from storage only.
    t_b2 = Trainer(arch, SHAPE, store_b, cfg=tc, ckpt_prefix="b", device="cpu")
    assert t_b2.start_step == 3
    log_b = t_b2.run(steps=3)
    assert log_a[-1]["loss"] == pytest.approx(log_b[-1]["loss"], rel=1e-4)


def test_trainer_loss_decreases():
    arch = get("qwen1.5-0.5b", smoke=True)
    tc = TrainerConfig(total_steps=30, ckpt_every=30, log_every=1,
                       opt=AdamWConfig(lr=3e-3, weight_decay=0.0))
    # Overfit a single repeated batch (seeded pipeline with 1 distinct step).
    t = Trainer(arch, SHAPE, MemoryStore(), cfg=tc, ckpt_prefix="c", device="cpu")
    t.data.batch_at = lambda step: SyntheticTokens(arch.cfg, SHAPE, seed=1).batch_at(0)
    log = t.run()
    assert log[-1]["loss"] < log[0]["loss"] * 0.8


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(get("qwen1.5-0.5b", smoke=True), SHAPE, MemoryStore())


def test_other_families_refuse_to_train():
    """``lm`` trains only its own families and names the module of each
    other one (the moe, vlm and encdec families train in
    tests/test_torch_families.py, the ssm family in
    tests/test_torch_xlstm.py, the hybrid family in
    tests/test_torch_hybrid.py)."""
    arch = get("qwen1.5-0.5b", smoke=True)
    for family, module in (("hybrid", "hybrid"), ("ssm", "xlstm"), ("encdec", "encdec")):
        other = Arch(cfg=dataclasses.replace(arch.cfg, family=family), module=arch.module)
        with pytest.raises(NotImplementedError, match=f"repro_torch.models.{module} runs"):
            other.train_loss({}, _t(_batch(arch.cfg)))
    assert get("zamba2-2.7b").module.__name__ == "repro_torch.models.hybrid"
