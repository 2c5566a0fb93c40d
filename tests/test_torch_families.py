"""The port's moe, vlm and encdec families (``repro_torch.models`` lm, moe,
encdec) against the reference's on the CPU, at the smoke configs of
mixtral-8x7b, grok-1-314b, pixtral-12b and whisper-base: serving, MoE
routing, training, checkpoints and the closed loop.

Parameters come from the reference's ``arch.init(jax.random.key(s))`` and
are carried across with ``params_from_numpy``; token ids, patches, frames
and activations are drawn with numpy. Tolerances: 1e-4 in float32 (the two
frameworks sum in different orders), the reference's own 0.08 in bfloat16;
``moe_mlp`` to 1e-5; losses to 1e-5 relative and each gradient leaf's
difference to 1e-4 of its norm. The reference's MoE fails in bfloat16 on
the CPU's jax, so every MoE comparison runs the reference in float32 — in
bfloat16 on the port's bfloat16 parameters rounded into a float32 model."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.coding.codec import Codec as RefCodec
from repro.coding.layout import SharedKeyLayout as RefSharedKeyLayout
from repro.core import FeedbackPolicy as RefFeedbackPolicy
from repro.core import StaticPolicy as RefStaticPolicy
from repro.core.delay_model import PAPER_READ_3MB as REF_READ
from repro.core.delay_model import RequestClass as RefRequestClass
from repro.models import get as ref_get
from repro.models import layers as ref_ly
from repro.models import moe as ref_moe
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.models.registry import Arch as RefArch
from repro.models.registry import make_batch as ref_make_batch
from repro.serve.engine import ClosedLoopServer as RefClosedLoopServer
from repro.serve.engine import FusedServingStep as RefFusedServingStep
from repro.serve.engine import ServePolicy as RefServePolicy
from repro.serve.engine import ServingEngine as RefServingEngine
from repro.storage import MemoryStore as RefMemoryStore
from repro.storage import Proxy as RefProxy
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import global_norm as ref_global_norm
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core import PAPER_READ_3MB, FeedbackPolicy, RequestClass, StaticPolicy
from repro_torch.models import ShapeSpec, get, make_batch, params_from_numpy
from repro_torch.models import layers as ly
from repro_torch.models import lm, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import Arch
from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
from repro_torch.storage import FaultyStore, MemoryStore, Proxy
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig, init_opt_state
from repro_torch.train.optimizer import global_norm
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

CPU = torch.device("cpu")
CODEC = Codec("kernel", device=CPU)
FAMILIES = ["mixtral-8x7b", "grok-1-314b", "pixtral-12b", "whisper-base"]
TOL = {"float32": 1e-4, "bfloat16": 0.08}


def _pair(name, dtype, seed=1, **changes):
    """(reference arch, port arch, reference params, port params) at the
    smoke config in ``dtype``. A bfloat16 MoE pair runs its reference in
    float32 on the port's bfloat16 parameters, widened (the router stays
    float32 in both)."""
    ref = ref_get(name, smoke=True)
    cfg = dataclasses.replace(ref.cfg, dtype=dtype, **changes)
    port = Arch(cfg=ModelConfig(**dataclasses.asdict(cfg)), module=get(name, smoke=True).module)
    rp = RefArch(cfg=cfg, module=ref.module).init(jax.random.key(seed))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    if cfg.n_experts and dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, dtype="float32")
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    return RefArch(cfg=cfg, module=ref.module), port, rp, pp


def _extras(cfg, rng, B):
    """The batch's non-token inputs (pixtral's patches, whisper's frames),
    drawn with numpy: {name: float32 array}."""
    extra = {"vlm": ("patches", cfg.vision_patches), "encdec": ("frames", cfg.encoder_seq)}
    if cfg.family not in extra:
        return {}
    name, length = extra[cfg.family]
    return {name: rng.normal(size=(B, length, cfg.d_model)).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x).astype(np.float64)


def _close(port, ref, tol, what):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=tol, atol=tol, err_msg=what)


def _assert_cache(pc, rc, tol, what, rows=slice(None)):
    """The caches' entries (of the batch ``rows``), slot positions and
    position."""
    assert set(pc) == set(rc)
    for leaf in set(rc) - {"slot_pos", "pos"}:  # k, v (and cross_k, cross_v)
        _close(pc[leaf][:, rows], np.asarray(rc[leaf])[:, rows], tol, f"{what}: cache {leaf}")
    np.testing.assert_array_equal(pc["slot_pos"].numpy(), np.asarray(rc["slot_pos"]))
    assert int(pc["pos"]) == int(rc["pos"])


def _named(tree):
    """{"a/0/b": float64 array} of a reference (jax/numpy) or port tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)
        out[name] = _np(leaf)
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


# -- serving: prefill, decode, continuation ---------------------------------------


#: A float32 router near-tie: the k-th and (k+1)-th largest probabilities of
#: a token within 2^-7 of each other in log space (one bfloat16 ulp of
#: relative spacing), close enough for bfloat16 activations to swap them.
NEAR_TIE = 2.0 ** -7


class _Routes:
    """Records the probabilities and top-k expert ids of every MoE call, by
    wrapping ``moe.route``; ``take()`` returns them since the last take."""

    def __init__(self, monkeypatch):
        self.calls: list[tuple[torch.Tensor, torch.Tensor]] = []
        real = moe.route

        def spy(*args):
            out = real(*args)
            self.calls.append((out[0].clone(), out[2].clone()))
            return out

        monkeypatch.setattr(moe, "route", spy)

    def take(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        calls, self.calls = self.calls, []
        return calls


def _held_rows(rows, got, want, K):
    """``rows`` (B,) bool less those whose bf16 routing parts from the
    float32 run's in these calls, taken in call order. Raises unless each
    such row's first parting call holds a token routed otherwise whose
    float32 top-k is a near-tie (:data:`NEAR_TIE`)."""
    gone = ~rows
    for layer, ((_, gi), (wp, wi)) in enumerate(zip(got, want)):
        moved = (gi.sort(-1).values != wi.sort(-1).values).any(-1).numpy()  # (B, S)
        logp = torch.log(wp).sort(-1, descending=True).values
        tie = (logp[..., K - 1] - logp[..., K] < NEAR_TIE).numpy()
        for b in np.flatnonzero(moved.any(-1) & ~gone):
            assert (moved[b] & tie[b]).any(), (
                f"MoE call {layer}: row {b} routed otherwise than the float32 run with no "
                f"near-tie among its tokens {np.flatnonzero(moved[b]).tolist()}")
        gone |= moved.any(-1)
    return ~gone


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_two_decode_steps_match_reference(name, dtype, monkeypatch, capsys):
    """Logits and caches after prefill and two decode steps. A bfloat16 MoE
    run can pick another expert than the float32 reference where the
    router's k-th and (k+1)-th probabilities are within bfloat16's
    rounding: its rows are held at 0.08 while every MoE call so far routed
    each of the row's tokens as the float32 run on the same parameters did
    (that run equals the reference to 1e-4 in the float32 case). A row
    leaves the comparison only where the float32 run shows a near-tie
    (:data:`NEAR_TIE`) at a token that first routed otherwise; such rows
    are printed."""
    ref, port, rp, pp = _pair(name, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    B, S = 2, 16
    batch = {"tokens": rng.integers(0, ref.cfg.vocab, size=(B, S)).astype(np.int32),
             **_extras(ref.cfg, rng, B)}
    max_seq = S + 8 + (ref.cfg.vision_patches if ref.cfg.family == "vlm" else 0)
    routed = dtype == "bfloat16" and ref.cfg.n_experts
    rows = np.ones(B, bool)  # rows whose routing so far is the float32 run's
    if routed:
        wide = Arch(cfg=dataclasses.replace(port.cfg, dtype="float32"), module=port.module)
        wide_params = tree_map(lambda t: t.float(), pp)
        routes = _Routes(monkeypatch)

    def run(call, wide_call, what):
        nonlocal rows
        out = call()
        if routed:
            got = routes.take()
            wide_call()
            held = _held_rows(rows, got, routes.take(), ref.cfg.top_k)
            if (rows & ~held).any():
                with capsys.disabled():
                    print(f"\n{name} {what}: rows {np.flatnonzero(rows & ~held).tolist()} "
                          "routed otherwise than the float32 run at a near-tie")
            rows = held
        return out

    rl, rc = ref.prefill(rp, _j(batch), max_seq=max_seq)
    wc = None

    def wide_prefill():
        nonlocal wc
        wc = wide.prefill(wide_params, _t(batch), max_seq=max_seq)[1]

    pl, pc = run(lambda: port.prefill(pp, _t(batch), max_seq=max_seq), wide_prefill, "prefill")
    assert pl.shape == (B, 1, ref.cfg.vocab) and pl.dtype == torch.float32
    _close(pl[rows], np.asarray(rl)[rows], tol, "prefill logits")
    _assert_cache(pc, rc, tol, "prefill", rows)
    for step in range(2):
        nxt = rng.integers(0, ref.cfg.vocab, size=(B, 1)).astype(np.int32)
        rl, rc = ref.decode_step(rp, jnp.asarray(nxt), rc)
        pl, pc = run(lambda: port.decode_step(pp, torch.from_numpy(nxt), pc),
                     lambda: wide.decode_step(wide_params, torch.from_numpy(nxt), wc),
                     f"decode step {step}")
        _close(pl[rows], np.asarray(rl)[rows], tol, f"decode step {step} logits")
        _assert_cache(pc, rc, tol, f"decode step {step}", rows)
    assert rows.any()


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_prefill_continuation(name):
    """Decoding token t+1 after prefill[0:t] matches prefill[0:t+1]'s last
    logits (``tests/test_arch_smoke.py``'s teacher-forcing check, default
    bfloat16, its 0.08 bar; the same patches or frames under both), on the
    port alone."""
    arch = get(name, smoke=True)
    params = arch.init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    B, S = 2, 12
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, size=(B, S + 1)).astype(np.int32))
    extras = _t(_extras(arch.cfg, rng, B))
    max_seq = S + 4 + (arch.cfg.vision_patches if arch.cfg.family == "vlm" else 0)
    _, cache = arch.prefill(params, {"tokens": toks[:, :S], **extras}, max_seq=max_seq)
    step_logits, _ = arch.decode_step(params, toks[:, S:S + 1], cache)
    full_logits, _ = arch.prefill(params, {"tokens": toks, **extras}, max_seq=max_seq)
    assert torch.isfinite(step_logits).all()
    np.testing.assert_allclose(step_logits.numpy(), full_logits.numpy(), rtol=0.08, atol=0.08)


def test_vlm_with_a_short_max_seq_drops_the_prefix_as_the_reference():
    """max_seq 12 < 8 patches + 16 tokens: the ring cache keeps the last 12
    positions, so decode no longer sees the patch prefix, in both."""
    ref, port, rp, pp = _pair("pixtral-12b", "float32")
    rng = np.random.default_rng(9)
    B, S, max_seq = 2, 16, 12
    batch = {"tokens": rng.integers(0, ref.cfg.vocab, size=(B, S)).astype(np.int32),
             **_extras(ref.cfg, rng, B)}
    rl, rc = ref.prefill(rp, _j(batch), max_seq=max_seq)
    pl, pc = port.prefill(pp, _t(batch), max_seq=max_seq)
    _close(pl, rl, 1e-4, "prefill logits")
    _assert_cache(pc, rc, 1e-4, "prefill")
    assert pc["k"].shape[2] == max_seq and int(pc["slot_pos"].min()) == 8 + S - max_seq
    for step in range(2):
        nxt = rng.integers(0, ref.cfg.vocab, size=(B, 1)).astype(np.int32)
        rl, rc = ref.decode_step(rp, jnp.asarray(nxt), rc)
        pl, pc = port.decode_step(pp, torch.from_numpy(nxt), pc)
        _close(pl, rl, 1e-4, f"decode step {step} logits")
        _assert_cache(pc, rc, 1e-4, f"decode step {step}")


@pytest.mark.parametrize("name", ["pixtral-12b", "whisper-base"])
def test_prefill_tokens_gives_the_zero_extras(name):
    """The fused-serving contract: tokens only in, all-zero patches or
    frames behind them, as the reference's ``Arch.prefill_tokens``."""
    ref, port, rp, pp = _pair(name, "float32")
    toks = np.random.default_rng(4).integers(0, ref.cfg.vocab, size=(2, 8)).astype(np.int32)
    rl, rc = ref.prefill_tokens(rp, jnp.asarray(toks), max_seq=64)
    pl, pc = port.prefill_tokens(pp, torch.from_numpy(toks), max_seq=64)
    _close(pl, rl, 1e-4, "logits")
    _assert_cache(pc, rc, 1e-4, "prefill_tokens")


# -- MoE routing ----------------------------------------------------------------


def _moe_params(seed=5):
    ref_cfg = dataclasses.replace(ref_get("mixtral-8x7b", smoke=True).cfg, dtype="float32")
    rp = ref_moe.init_moe(jax.random.key(seed), ref_cfg)
    return ref_cfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp), CPU)


def _ref_keep(ref_cfg, rp, x, C):
    """The reference's routing decisions, from its own router: (top-k ids,
    keep) — a (token, choice) is kept while its expert's running count in
    the row is under C."""
    probs = jax.nn.softmax(jnp.asarray(x) @ rp["router"], axis=-1)
    _, topi = jax.lax.top_k(probs, ref_cfg.top_k)
    flat = np.asarray(topi).reshape(x.shape[0], -1)
    onehot = flat[..., None] == np.arange(ref_cfg.n_experts)
    pos = np.take_along_axis(np.cumsum(onehot, axis=1) - 1, flat[..., None], axis=2)[..., 0]
    return np.asarray(topi), pos < C


@pytest.mark.parametrize("dropless,cf", [(True, 1.25), (False, 1.25), (False, 0.5),
                                         (False, 0.25)])
def test_moe_mlp_matches_reference(dropless, cf):
    """Both routings: the output and the aux loss to 1e-5; at capacity
    factors 0.5 and 0.25 choices really drop, and the keep mask is the
    reference's exactly."""
    ref_cfg, rp, pp = _moe_params()
    ref_cfg = dataclasses.replace(ref_cfg, capacity_factor=cf)
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    B, S = 2, 24
    x = np.random.default_rng(6).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.moe_mlp(rp, ref_cfg, jnp.asarray(x), dropless=dropless)
    got, got_aux = moe.moe_mlp(pp, cfg, torch.from_numpy(x), dropless=dropless)
    _close(got, want, 1e-5, "moe output")
    assert got_aux.dtype == torch.float32 and _rel(got_aux, want_aux) <= 1e-5
    C = S if dropless else int(np.ceil(cf * S * cfg.top_k / cfg.n_experts))
    ref_topi, ref_keep = _ref_keep(ref_cfg, rp, x, C)
    _, _, topi, _, keep = moe.route(pp, cfg, torch.from_numpy(x), C)
    np.testing.assert_array_equal(topi.numpy(), ref_topi)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert keep.all() == (dropless or cf == 1.25 and bool(ref_keep.all()))
    if cf < 1:
        assert not ref_keep.all()


def test_bfloat16_activations_route_through_the_float32_router_product():
    """In a bfloat16 model the router's product stays float32, as the
    reference's ``x.astype(float32) @ router``: the port's probabilities for
    bfloat16 activations equal the reference's softmax over the widened
    activations to 1e-6."""
    ref_cfg, rp, pp = _moe_params()
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(ref_cfg, dtype="bfloat16")))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    probs = moe.route(pp, cfg, x, 24)[0]
    want = jax.nn.softmax(jnp.asarray(x.float().numpy()) @ rp["router"], axis=-1)
    assert probs.dtype == torch.float32
    _close(probs, want, 1e-6, "router probabilities")


def test_moe_mlp_gradients_match_reference():
    """The backward through the capacity-routed dispatch, dropped choices
    included: d/dx and d/dparams of a weighted sum of the output + aux."""
    ref_cfg, rp, pp = _moe_params(seed=7)
    ref_cfg = dataclasses.replace(ref_cfg, capacity_factor=0.5)
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def ref_f(p, xx):
        out, aux = ref_moe.moe_mlp(p, ref_cfg, xx)
        return jnp.sum(out * w) + aux

    (rgp, rgx) = jax.grad(ref_f, argnums=(0, 1))(rp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    live = tree_map(lambda t: t.detach().requires_grad_(), pp)
    out, aux = moe.moe_mlp(live, cfg, xt)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)) + aux,
                                [xt, *(t for _, t in tree_flatten(live))])
    _assert_leaves({"x": grads[0]}, {"x": rgx})
    _assert_leaves(tree_unflatten(live, list(grads[1:])), rgp)


# -- training -----------------------------------------------------------------------


def _train_batch(cfg, seed=0, B=2, S=32):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, cfg.vocab, size=(B, S + 1))
    return {"tokens": stream[:, :S].astype(np.int32), "labels": stream[:, 1:].astype(np.int32),
            **_extras(cfg, rng, B)}


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_gradients_match_reference_float32(name):
    """The MoE's capacity-routed aux loss included; pixtral's loss over the
    text positions only."""
    ref, port, rp, pp = _pair(name, "float32")
    batch = _train_batch(ref.cfg)
    rl, rg = jax.value_and_grad(ref.train_loss)(rp, _j(batch))
    pl, pg = value_and_grad(port, pp, _t(batch))
    assert pl.dtype == torch.float32 and pl.shape == ()
    assert _rel(pl, rl) <= 1e-5
    _assert_leaves(pg, rg)


def test_moe_aux_loss_enters_the_training_loss():
    """The loss is the CE plus AUX_LOSS_WEIGHT times the layers' aux sum,
    near 1 per layer at init (balanced routing)."""
    _, port, _, pp = _pair("mixtral-8x7b", "float32")
    batch = _t(_train_batch(port.cfg, seed=3))
    x, aux = lm.backbone(pp, port.cfg, lm._inputs_to_embeddings(pp, port.cfg, batch))
    ce = lm.chunked_ce_loss(pp, port.cfg, x, batch["labels"])
    assert aux.dtype == torch.float32
    assert 0.8 * port.cfg.n_layers < float(aux) < 1.5 * port.cfg.n_layers
    torch.testing.assert_close(port.train_loss(pp, batch), ce + lm.AUX_LOSS_WEIGHT * aux)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "whisper-base"])
def test_three_trainer_steps_match_reference(name):
    """The reference's ``Trainer`` and the port's in float32, the
    reference's parameters carried across: each step's loss and grad norm
    and the final parameters to 1e-4 relative. AdamW's eps is 1e-3 here, as
    in ``tests/test_torch_train.py``'s accumulation test: at 1e-8 a leaf
    whose gradient is ~1e-3 (whisper's key biases) moves by ~lr·sign(g) a
    step, and the frameworks' last-bit differences in small gradient
    entries move it by ~1e-4 of its norm."""
    shape = (32, 2)
    ref = ref_get(name, smoke=True)
    ref = RefArch(cfg=dataclasses.replace(ref.cfg, dtype="float32"), module=ref.module)
    port = Arch(cfg=ModelConfig(**dataclasses.asdict(ref.cfg)), module=get(name, smoke=True).module)
    t_ref = RefTrainer(ref, RefShapeSpec("t", "train", *shape), RefMemoryStore(),
                       cfg=RefTrainerConfig(total_steps=3, ckpt_every=3, log_every=1,
                                            opt=RefAdamWConfig(lr=1e-3, eps=1e-3)),
                       ckpt_prefix="r")
    t = Trainer(port, ShapeSpec("t", "train", *shape), MemoryStore(),
                cfg=TrainerConfig(total_steps=3, ckpt_every=3, log_every=1,
                                  opt=AdamWConfig(lr=1e-3, eps=1e-3)), ckpt_prefix="p",
                device="cpu")
    t.params = params_from_numpy(jax.tree.map(np.asarray, t_ref.params), CPU)
    t.opt_state = init_opt_state(t.params)
    want, got = t_ref.run(), t.run()
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert _rel(g["loss"], w["loss"]) <= 1e-4
        assert _rel(g["grad_norm"], w["grad_norm"]) <= 1e-4
    _assert_leaves(t.params, t_ref.params)


def test_whisper_trainer_restart_resumes_identically():
    """6 steps straight against 3 + a restart from the store with 2 of 8
    strips of every leaf lost + 3: the same final loss."""
    arch = get("whisper-base", smoke=True)
    shape = ShapeSpec("t", "train", seq=16, batch=2)
    tc = TrainerConfig(total_steps=6, ckpt_every=3, log_every=1, opt=AdamWConfig(lr=1e-3))
    log_a = Trainer(arch, shape, MemoryStore(), cfg=tc, ckpt_prefix="a", device="cpu").run()
    store = MemoryStore()
    Trainer(arch, shape, store, cfg=tc, ckpt_prefix="b", device="cpu").run(steps=3)
    faulty = FaultyStore(store)
    for key in store.keys():
        if key.endswith(("strip0", "strip2")):
            faulty.lose_object(key)
    t_b = Trainer(arch, shape, faulty, cfg=tc, ckpt_prefix="b", device="cpu")
    assert t_b.start_step == 3 and isinstance(t_b.params["decoder"], list)
    log_b = t_b.run(steps=3)
    assert log_a[-1]["loss"] == pytest.approx(log_b[-1]["loss"], rel=1e-4)


# -- trees and checkpoints ------------------------------------------------------------


def test_tree_walks_lists_in_jax_order():
    tree = {"b": [np.float32(1), {"z": np.float32(2), "a": np.float32(3)}], "a": np.float32(4),
            "c": [[np.float32(5)], np.float32(6)]}
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = tree_flatten(tree)
    assert [p for p, _ in got] == [tuple(k.key if hasattr(k, "key") else k.idx for k in p)
                                   for p, _ in want]
    assert [v for _, v in got] == [v for _, v in want]
    doubled = tree_map(lambda v: 2 * v, tree)
    assert doubled["c"][0][0] == 10 and isinstance(doubled["b"], list)
    assert tree_unflatten(tree, [v for _, v in got]) == tree


def test_global_norm_of_an_encdec_tree_sums_in_jax_order():
    rp = ref_get("whisper-base", smoke=True).init(jax.random.key(2))
    rp = jax.tree.map(lambda a: a.astype(jnp.float32) + 0.01, rp)
    want = ref_global_norm(rp)
    got = global_norm(params_from_numpy(jax.tree.map(np.asarray, rp), CPU))
    assert _rel(got, want) <= 1e-6


def test_params_from_numpy_keeps_the_float32_router():
    rp = jax.tree.map(np.asarray, ref_get("mixtral-8x7b", smoke=True).init(jax.random.key(0)))
    pp = params_from_numpy(rp, CPU)
    assert pp["layers"]["moe"]["router"].dtype == torch.float32
    assert pp["layers"]["moe"]["wi"].dtype == torch.bfloat16
    assert pp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    for (path, t), (_, a) in zip(tree_flatten(pp), tree_flatten(rp)):
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), path
        assert t.reshape(-1).view(torch.uint8).numpy().tobytes() == a.tobytes(), path


def _ckpt_state(name, seed=3):
    """The reference's bfloat16 smoke parameters and a seeded optimizer
    state at step 7: (reference numpy tree, port tensor tree)."""
    rp = jax.tree.map(np.asarray, ref_get(name, smoke=True).init(jax.random.key(seed)))
    rng = np.random.default_rng(0)
    mom = lambda: jax.tree.map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), rp)
    ref_tree = {"params": rp, "opt": {"m": mom(), "v": mom(), "step": np.int32(7)}}
    return ref_tree, params_from_numpy(ref_tree, CPU)


def _objects(store):
    return {key: store.get(key) for key in store.keys()}


def _assert_same_bits(got, want):
    """A port tree against a reference tree, leaf by leaf: names, shapes,
    dtypes and bytes."""
    got, want = tree_flatten(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [tuple(k.key if hasattr(k, "key") else k.idx for k in p)
                                   for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        assert g.reshape(-1).view(torch.uint8).numpy().tobytes() == w.tobytes(), path


@pytest.mark.parametrize("name,leaf,dtype", [
    ("mixtral-8x7b", "params/layers/moe/router", "float32"),
    ("whisper-base", "params/decoder/0/cross_attn/wq", "bfloat16"),
])
def test_strips_and_manifest_equal_the_references(name, leaf, dtype):
    """Every object of one checkpoint byte for byte: mixtral's float32
    router among bfloat16 leaves, whisper's list-indexed leaf names."""
    ref_tree, port_tree = _ckpt_state(name)
    ref_store, store = RefMemoryStore(), MemoryStore()
    want = ref_save(ref_store, "ck", 9, ref_tree, n_max=8, k_max=4)
    got = save_checkpoint(store, "ck", 9, port_tree, n_max=8, k_max=4, codec=CODEC)
    assert got == want
    assert _objects(store) == _objects(ref_store)
    manifest = json.loads(store.get("ck/step9/MANIFEST"))
    assert manifest["leaves"][leaf]["dtype"] == dtype


@pytest.mark.parametrize("name", ["mixtral-8x7b", "whisper-base"])
def test_checkpoints_restore_across_the_packages(name):
    """The reference's checkpoint restores in the port and the port's in the
    reference, each with 3 of 8 strips of every leaf lost."""
    ref_tree, port_tree = _ckpt_state(name)
    ref_store, store = RefMemoryStore(), MemoryStore()
    ref_save(ref_store, "r", 4, ref_tree)
    save_checkpoint(store, "p", 4, port_tree, codec=CODEC)
    lost = ("strip1", "strip4", "strip6")
    into_port, into_ref = MemoryStore(), RefMemoryStore()
    for key, data in _objects(ref_store).items():
        if not key.endswith(lost):
            into_port.put(key, data)
    for key, data in _objects(store).items():
        if not key.endswith(lost):
            into_ref.put(key, data)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), port_tree)
    _assert_same_bits(restore_checkpoint(into_port, "r", 4, like, device="cpu"), ref_tree)
    got = ref_restore(into_ref, "p", 4, ref_tree)
    _assert_same_bits(port_tree, jax.tree.map(np.asarray, got))


# -- the closed loop ----------------------------------------------------------------

CLS = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
REF_CLS = RefRequestClass("read3mb", 3.0, REF_READ, k_max=6, r_max=2.0, n_max=12)
PROMPT_LEN, MARGIN = 16, 1e-3


def _ref_margins(ref, rp, prompts, steps, max_seq):
    """Reference tokens and top-1/top-2 logit margins of greedy generation
    from ``prompts`` (behind the zero extras): (B, steps) each."""
    eng = RefServingEngine(ref, rp, max_seq=max_seq)
    logits, cache = ref.prefill_tokens(rp, jnp.asarray(prompts, jnp.int32), max_seq)
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


@pytest.mark.parametrize("name", ["pixtral-12b", "whisper-base"])
def test_closed_loop_matches_reference(name):
    """Two rounds of both closed loops over the same stored prompts, in
    float32: the same tokens (margin-qualified), read codes, controller
    picks fed to the write policy and one bucket; the port's tokens equal
    its ``ServingEngine.generate``'s."""
    steps, n_keys = 4, 4
    ref, port, rp, pp = _pair(name, "float32", seed=2)
    max_seq = PROMPT_LEN + steps + (ref.cfg.vision_patches if ref.cfg.family == "vlm" else 0)
    layout = SharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    ref_layout = RefSharedKeyLayout(K=4, r=2, strip_bytes=PROMPT_LEN)
    store, ref_store = MemoryStore(), RefMemoryStore()
    rng = np.random.default_rng(6)
    truth = rng.integers(0, ref.cfg.vocab, size=(n_keys, PROMPT_LEN)).astype(np.int32)
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
    want_toks, margins = _ref_margins(ref, rp, truth, steps, max_seq)
    try:
        for r in range(2):
            got = server.serve_round(keys, steps=steps)
            want = ref_server.serve_round(keys, steps=steps)
            assert got.ok == want.ok == [True] * n_keys
            assert got.codes == want.codes
            assert got.next_code == want.next_code == write_pol.code == ref_write_pol.code, r
            _assert_tokens_agree(got.tokens, want.tokens, margins)
            _assert_tokens_agree(got.tokens, want_toks, margins)
            np.testing.assert_array_equal(got.tokens, engine.generate(truth, steps))
        assert server.traces == ref_server.traces == 1
    finally:
        proxy.close()
        ref_proxy.close()


# -- registry, layers, init ---------------------------------------------------------


@pytest.mark.parametrize("name", ["pixtral-12b", "whisper-base", "mixtral-8x7b"])
def test_make_batch_draws_the_reference_batch(name):
    cfg = get(name, smoke=True).cfg
    for kind in ("prefill", "train"):
        batch = make_batch(cfg, ShapeSpec("s", kind, seq=16, batch=2),
                           np.random.default_rng(5), device="cpu")
        want = ref_make_batch(ref_get(name, smoke=True).cfg,
                              RefShapeSpec("s", kind, seq=16, batch=2), np.random.default_rng(5))
        assert sorted(batch) == sorted(want)
        for key in batch:
            assert batch[key].dtype == {"int32": torch.int32, "float32": torch.float32}[
                str(want[key].dtype)]
            np.testing.assert_array_equal(batch[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_flags_match_reference(causal, q_offset):
    """``causal`` and ``q_offset`` over 8 × 8 chunks with more keys than
    queries (padded keys)."""
    ref_cfg = dataclasses.replace(ref_get("whisper-base", smoke=True).cfg, attn_q_chunk=8,
                                  attn_kv_chunk=8, dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    rng = np.random.default_rng(10)
    q = rng.normal(size=(2, 13, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 21, 2, 16)).astype(np.float32) for _ in range(2))
    want = ref_ly.chunked_attention(ref_cfg, *map(jnp.asarray, (q, k, v)), causal=causal,
                                    window=None, softcap=None, q_offset=q_offset)
    got = ly.chunked_attention(cfg, *map(torch.from_numpy, (q, k, v)), window=None,
                               softcap=None, causal=causal, q_offset=q_offset)
    _close(got, want, 1e-5, "chunked attention")


def test_cross_attention_sublayer_matches_reference():
    ref, port, rp, pp = _pair("whisper-base", "float32")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 7, port.cfg.d_model)).astype(np.float32)
    mk, mv = (rng.normal(size=(2, 16, port.cfg.n_kv_heads, port.cfg.hd)).astype(np.float32)
              for _ in range(2))
    want = ref_ly.attention(rp["decoder"][1]["cross_attn"], ref.cfg, jnp.asarray(x),
                            causal=False, kv_override=(jnp.asarray(mk), jnp.asarray(mv)))
    got, k, _ = ly.attention(pp["decoder"][1]["cross_attn"], port.cfg, torch.from_numpy(x),
                             causal=False,
                             kv_override=(torch.from_numpy(mk), torch.from_numpy(mv)))
    _close(got, want, 1e-5, "cross attention")
    assert torch.equal(k, torch.from_numpy(mk))


@pytest.mark.parametrize("name", ["mixtral-8x7b", "pixtral-12b", "qwen1.5-0.5b"])
def test_init_fills_the_stacked_layout_with_the_per_block_draws(name):
    """The stacked leaves hold what drawing the blocks one after another
    from the same generator gives (the seeded values of stacking them);
    the router is float32, the rest in the config's dtype."""
    arch = get(name, smoke=True)
    params = arch.init(torch.Generator().manual_seed(6))
    gen = torch.Generator().manual_seed(6)
    ly.init_embedding(gen, arch.cfg, CPU)
    blocks = [lm.init_block(gen, arch.cfg, CPU) for _ in range(arch.cfg.n_layers)]
    for (path, got), *per_block in zip(tree_flatten(params["layers"]),
                                       *(tree_flatten(b) for b in blocks)):
        assert torch.equal(got, torch.stack([t for _, t in per_block])), path
    if arch.cfg.n_experts:
        assert params["layers"]["moe"]["router"].dtype == torch.float32
        assert params["layers"]["moe"]["wi"].shape == (arch.cfg.n_layers, arch.cfg.n_experts,
                                                       arch.cfg.d_model, arch.cfg.d_ff)
    if arch.cfg.family == "vlm":
        assert params["vision_proj"].shape == (arch.cfg.d_model, arch.cfg.d_model)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "pixtral-12b", "whisper-base"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    arch = get(name, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arch.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arch.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(arch, ShapeSpec("t", "train", seq=8, batch=1), MemoryStore())
    meta = arch.init(device="meta")
    assert all(t.device.type == "meta" for _, t in tree_flatten(meta))
