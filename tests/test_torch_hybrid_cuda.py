"""The port's hybrid family (``repro_torch.models.ssm``'s Mamba2 and
``hybrid``) on the card against the port on the CPU. Each test is marked
``cuda`` and skips where no CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_hybrid_cuda.py

TF32 is off (the products are float32 as on the CPU). float32 runs agree to
1e-4 (two devices, other reduction orders) and bfloat16 runs to the
reference's 0.08. Checkpoint strips coded by K1 equal the plain version's
byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt import save_checkpoint
from repro_torch.coding.codec import Codec, pow2_bucket
from repro_torch.kernels.gf2mm import gf2mm
from repro_torch.models import get, ssm
from repro_torch.models.registry import Arch
from repro_torch.storage import MemoryStore
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
