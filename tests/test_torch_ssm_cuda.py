"""The port's ssm family (``repro_torch.models.ssm`` and ``xlstm``) on the
card against the port on the CPU. Each test is marked ``cuda`` and skips
where no CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssm_cuda.py

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
NAME = "xlstm-350m"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _arch(dtype, **changes):
    arch = get(NAME, smoke=True)
    return Arch(cfg=dataclasses.replace(arch.cfg, dtype=dtype, **changes), module=arch.module)


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _close(got, want, tol, what):
    torch.testing.assert_close(got.cpu().double(), want.double(), rtol=tol, atol=tol, msg=what)


@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_recurrence_on_the_card_equals_the_cpu(cuda, normalize):
    """The published mLSTM's shapes but the batch: 4 heads of 512, chunks
    of 256, 300 positions (a padded second chunk), from a given state."""
    rng = np.random.default_rng(1)
    B, S, H, d = 1, 300, 4, 512
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, d)).astype(np.float32) / np.sqrt(d))
               for _ in range(3))
    log_a = torch.from_numpy(-np.abs(rng.normal(size=(B, S, H))).astype(np.float32) * 0.05)
    gate_i = torch.from_numpy(rng.uniform(0, 1, size=(B, S, H)).astype(np.float32))
    state = (torch.from_numpy(rng.normal(size=(B, H, d, d)).astype(np.float32) * 0.01),
             torch.from_numpy(np.abs(rng.normal(size=(B, H, d))).astype(np.float32)))
    args = (q, k, v, log_a, gate_i)
    want_y, (want_S, want_n) = ssm.chunk_linear_recurrence(
        *args, chunk=256, init_state=state, normalize=normalize)
    y, (Sf, nf) = ssm.chunk_linear_recurrence(
        *_to(args, cuda), chunk=256, init_state=_to(state, cuda), normalize=normalize)
    assert y.device.type == "cuda"
    for got, want, what in ((y, want_y, "y"), (Sf, want_S, "S"), (nf, want_n, "n")):
        _close(got, want, 1e-4, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cells_on_the_card_equal_the_cpu(cuda, dtype):
    """An mLSTM and an sLSTM block over 11 positions, then a decode step of
    each from its state: outputs and states."""
    arch = _arch(dtype)
    params = arch.init(torch.Generator().manual_seed(2))
    mcell, scell = params["blocks"][0]["cell"], params["blocks"][2]["cell"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 11, arch.cfg.d_model)).astype(np.float32)).to(
        getattr(torch, dtype))
    x1 = x[:, :1]
    for name, block, step, cell in (("mlstm", ssm.mlstm_block, ssm.mlstm_decode_step, mcell),
                                    ("slstm", ssm.slstm_block, ssm.slstm_decode_step, scell)):
        want, want_st = block(cell, arch.cfg, x)
        got, st = block(_to(cell, cuda), arch.cfg, x.to(cuda))
        _close(got, want, TOL[dtype], f"{name} block")
        for i, (g, w) in enumerate(zip(st, want_st)):
            _close(g, w, TOL[dtype], f"{name} block state {i}")
        want, want_st = step(cell, arch.cfg, x1, want_st)
        got, st = step(_to(cell, cuda), arch.cfg, x1.to(cuda), st)
        _close(got, want, TOL[dtype], f"{name} decode")
        for i, (g, w) in enumerate(zip(st, want_st)):
            _close(g, w, TOL[dtype], f"{name} decode state {i}")


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
    """The smoke xlstm's prefill of 20 tokens and 3 decode steps: logits and
    every state of the cache."""
    arch = _arch(dtype)
    params = arch.init(torch.Generator().manual_seed(8))
    want, want_cache = _prefill_decode(arch, params, CPU)
    got, got_cache = _prefill_decode(arch, _to(params, cuda), cuda)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL[dtype], f"logits {i}")
    for (path, g), (_, w) in zip(tree_flatten(got_cache), tree_flatten(want_cache)):
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
    """One AdamW step in float32 through the sLSTM's per-position loop and
    the chunked recurrence: loss and grad norm to 1e-4."""
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


def test_xlstm_checkpoint_strips_from_k1_equal_the_plain_versions(cuda):
    """A bfloat16 xlstm training state (a block list of two kinds of cell)
    coded on the card (K1, one launch per group) and on the CPU: every
    object byte for byte."""
    arch = _arch("bfloat16", n_layers=4, slstm_every=4)
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
    assert "params/blocks/3/cell/r_h" in manifest["leaves"]
    assert sorted(dev_store.keys()) == sorted(cpu_store.keys())
    for key in cpu_store.keys():
        assert dev_store.get(key) == cpu_store.get(key), key
