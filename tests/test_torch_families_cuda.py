"""The port's moe, vlm and encdec families on the card against the port on
the CPU, at the smoke configs. Each test is marked ``cuda`` and skips where
no CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_families_cuda.py

float32 runs agree to 1e-4 (two devices, other reduction orders) and
bfloat16 runs to the reference's 0.08; the card's bfloat16 expert products
keep float32 outputs (``torch.bmm(..., out_dtype=torch.float32)``), the
CPU's widen their operands. A MoE row whose top-k experts differ between
the card and the CPU is printed. Checkpoint strips coded by K1 equal the
plain version's byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt import save_checkpoint
from repro_torch.coding.codec import Codec, pow2_bucket
from repro_torch.kernels.gf2mm import gf2mm
from repro_torch.models import get, moe
from repro_torch.models.registry import Arch, zero_extras
from repro_torch.storage import MemoryStore
from repro_torch.train import init_opt_state, make_train_step
from repro_torch.tree import tree_flatten, tree_map

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
TOL = {"float32": 1e-4, "bfloat16": 0.08}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _arch(name, dtype):
    arch = get(name, smoke=True)
    return Arch(cfg=dataclasses.replace(arch.cfg, dtype=dtype), module=arch.module)


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _close(got, want, tol, what):
    torch.testing.assert_close(got.cpu().double(), want.double(), rtol=tol, atol=tol, msg=what)


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_on_the_card_equals_the_cpu(cuda, dtype, dropless):
    arch = _arch("mixtral-8x7b", dtype)
    params = {k: v[0] for k, v in arch.init(torch.Generator().manual_seed(1))[
        "layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 24, arch.cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    C = 24 if dropless else int(np.ceil(arch.cfg.capacity_factor * 24 * 2 / arch.cfg.n_experts))
    want, want_aux = moe.moe_mlp(params, arch.cfg, x, dropless=dropless)
    got, got_aux = moe.moe_mlp(_to(params, cuda), arch.cfg, x.to(cuda), dropless=dropless)
    ids_cpu = moe.route(params, arch.cfg, x, C)[2]
    ids_dev = moe.route(_to(params, cuda), arch.cfg, x.to(cuda), C)[2].cpu()
    differ = (ids_cpu != ids_dev).any(-1)
    for b, s in differ.nonzero().tolist():
        print(f"top-k of token ({b}, {s}): card {ids_dev[b, s].tolist()}, "
              f"CPU {ids_cpu[b, s].tolist()}")
    assert got.dtype == x.dtype and got_aux.dtype == torch.float32
    assert not differ.any()
    _close(got, want, TOL[dtype], "moe output")
    _close(got_aux, want_aux, 1e-5, "aux loss")


def test_moe_train_step_on_the_card_equals_the_cpu(cuda):
    """The backward through the capacity-routed dispatch, float32."""
    arch = _arch("mixtral-8x7b", "float32")
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


def _assert_grads(got, want, what):
    """Each gradient within 1e-2 of its reference's norm (bfloat16 rounding
    of the incoming gradient and of the operands' gradients)."""
    for name in want:
        diff = torch.linalg.norm(got[name].cpu().double() - want[name].cpu().double())
        assert diff <= 1e-2 * torch.linalg.norm(want[name].cpu().double()), f"{what} {name}"


@pytest.mark.parametrize("shape", [(4, 32, 32, 32), (3, 24, 40, 16)])
def test_bmm_f32_gradients_match_autograd_of_the_widened_product(cuda, shape):
    """``bmm_f32``'s hand-written backward on bfloat16 operands against
    autograd through ``torch.bmm(a.float(), b.float())``: a square case
    (a transposed operand would still fit) and a rectangular one."""
    E, M, K, N = shape
    rng = np.random.default_rng(11)
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, torch.bfloat16)
            for s in ((E, M, K), (E, K, N)))
    w = torch.from_numpy(rng.normal(size=(E, M, N)).astype(np.float32)).to(cuda)
    grads = {}
    for how, bmm in (("port", moe.bmm_f32), ("widened", lambda x, y: torch.bmm(x.float(),
                                                                                y.float()))):
        la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
        y = bmm(la, lb)
        assert y.dtype == torch.float32
        (y * w).sum().backward()
        grads[how] = {"a": la.grad, "b": lb.grad}
    assert grads["port"]["a"].dtype == torch.bfloat16
    _assert_grads(grads["port"], grads["widened"], "bmm_f32")


def test_moe_bfloat16_gradients_match_the_widened_products(cuda, monkeypatch):
    """One bfloat16 ``moe_mlp`` with capacity routing on the card: the
    gradients of x, the router and wi/wg/wo through the port's float32-output
    expert products against autograd through widened products (the same
    routing: the router is float32 in both)."""
    arch = get("mixtral-8x7b", smoke=True)
    params = {k: v[0].to(cuda) for k, v in arch.init(torch.Generator().manual_seed(12))[
        "layers"]["moe"].items()}
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(2, 24, arch.cfg.d_model)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).to(cuda)

    def grads():
        leaves = {k: v.clone().requires_grad_() for k, v in {"x": x, **params}.items()}
        out, aux = moe.moe_mlp({k: leaves[k] for k in params}, arch.cfg, leaves["x"])
        ((out.float() * w).sum() + aux).backward()
        return {k: v.grad for k, v in leaves.items()}

    got = grads()
    monkeypatch.setattr(moe, "bmm_f32", lambda a, b: torch.bmm(a.float(), b.float()))
    want = grads()
    assert set(got) == {"x", "router", "wi", "wg", "wo"}
    _assert_grads(got, want, "moe_mlp")


def test_moe_bfloat16_train_step_runs_on_the_card(cuda):
    """The bfloat16 expert products' backward (``out_dtype`` float32 has
    no autograd formula of its own): finite loss and gradients, the
    router's float32."""
    arch = get("mixtral-8x7b", smoke=True)
    params = arch.init(torch.Generator(device=cuda).manual_seed(5))
    stream = np.random.default_rng(6).integers(0, arch.cfg.vocab, size=(2, 33))
    batch = {"tokens": torch.from_numpy(stream[:, :32].astype(np.int32)).to(cuda),
             "labels": torch.from_numpy(stream[:, 1:].astype(np.int32)).to(cuda)}
    params, _, metrics = make_train_step(arch)(params, init_opt_state(params), batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert all(torch.isfinite(t).all() for _, t in tree_flatten(params))


def _prefill_decode(arch, params, device, *, S=16, steps=2, seed=7):
    """(prefill logits, decode logits..., final cache) with seeded tokens
    and patches or frames on ``device``."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (2, S)).astype(np.int32))
    batch = zero_extras(arch.cfg, toks)
    for key in set(batch) - {"tokens"}:
        batch[key] = torch.from_numpy(rng.normal(size=batch[key].shape).astype(np.float32))
    extra = arch.cfg.vision_patches if arch.cfg.family == "vlm" else 0
    logits, cache = arch.prefill(params, _to(batch, device), max_seq=S + extra + steps)
    out = [logits]
    for _ in range(steps):
        nxt = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (2, 1)).astype(np.int32))
        logits, cache = arch.decode_step(params, nxt.to(device), cache)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["pixtral-12b", "whisper-base", "mixtral-8x7b"])
def test_prefill_and_decode_on_the_card_equal_the_cpu(cuda, name, dtype):
    """pixtral's prefill behind its patches, whisper's encoder, prefill
    (cross caches included) and decode, mixtral's dropless MoE."""
    arch = _arch(name, dtype)
    params = arch.init(torch.Generator().manual_seed(8))
    want, want_cache = _prefill_decode(arch, params, CPU)
    got, got_cache = _prefill_decode(arch, _to(params, cuda), cuda)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[dtype], f"logits {i}")
    for key in want_cache:
        if want_cache[key].is_floating_point():
            _close(got_cache[key], want_cache[key], TOL[dtype], f"cache {key}")
        else:
            assert torch.equal(got_cache[key].cpu(), want_cache[key]), key


@pytest.mark.parametrize("name", ["mixtral-8x7b", "pixtral-12b", "whisper-base"])
def test_decode_matches_prefill_continuation_on_the_card(cuda, name):
    """The reference's teacher-forcing check (bfloat16, 0.08) on the card."""
    arch = get(name, smoke=True)
    params = arch.init(torch.Generator(device=cuda).manual_seed(9))
    rng = np.random.default_rng(10)
    B, S = 2, 12
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, (B, S + 1)).astype(np.int32))
    extras = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)).to(cuda)
              for k, v in zero_extras(arch.cfg, toks).items() if k != "tokens"}
    toks = toks.to(cuda)
    max_seq = S + 4 + (arch.cfg.vision_patches if arch.cfg.family == "vlm" else 0)
    _, cache = arch.prefill(params, {"tokens": toks[:, :S], **extras}, max_seq=max_seq)
    step, _ = arch.decode_step(params, toks[:, S:S + 1], cache)
    full, _ = arch.prefill(params, {"tokens": toks, **extras}, max_seq=max_seq)
    assert torch.isfinite(step).all()
    torch.testing.assert_close(step, full, rtol=0.08, atol=0.08)


def test_whisper_checkpoint_strips_from_k1_equal_the_plain_versions(cuda):
    """A bfloat16 whisper training state (list-indexed leaves) coded on the
    card (K1, one launch per group) and on the CPU: every object byte for
    byte."""
    arch = get("whisper-base", smoke=True)
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
    assert "params/decoder/0/cross_attn/wq" in manifest["leaves"]
    assert sorted(dev_store.keys()) == sorted(cpu_store.keys())
    for key in cpu_store.keys():
        assert dev_store.get(key) == cpu_store.get(key), key

