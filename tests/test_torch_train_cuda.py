"""The port's training path and checkpoints on the card against the port on
the CPU, at the smoke configs. Each test is marked ``cuda`` and skips where
no CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py

A float32 train step on the card agrees with the CPU's to 1e-4 (the loss
relative, each parameter leaf's difference against its norm: two devices,
other reduction orders); checkpoint strips coded by K1 equal the plain
version's byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt import save_checkpoint
from repro_torch.coding.codec import Codec, pow2_bucket
from repro_torch.kernels.gf2mm import gf2mm
from repro_torch.models import get
from repro_torch.models import layers as ly
from repro_torch.models.config import ShapeSpec
from repro_torch.models.registry import Arch
from repro_torch.storage import FaultyStore, MemoryStore
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig, init_opt_state, make_train_step
from repro_torch.tree import tree_flatten, tree_map

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
SHAPE = ShapeSpec("tiny_train", "train", seq=32, batch=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _f32(name):
    arch = get(name, smoke=True)
    return Arch(cfg=dataclasses.replace(arch.cfg, dtype="float32"), module=arch.module)


def _batch(cfg, seed=0):
    stream = np.random.default_rng(seed).integers(0, cfg.vocab, size=(2, 33))
    return {"tokens": torch.from_numpy(stream[:, :32].astype(np.int32)),
            "labels": torch.from_numpy(stream[:, 1:].astype(np.int32))}


@pytest.mark.parametrize("name", ["gemma2-2b", "qwen1.5-0.5b"])
def test_train_step_on_the_card_equals_the_cpu(cuda, name):
    arch = _f32(name)
    params = arch.init(torch.Generator().manual_seed(1))
    batch = _batch(arch.cfg)
    step = make_train_step(arch, AdamWConfig(lr=1e-2, eps=1e-3))
    pc, sc, mc = step(tree_map(torch.clone, params), init_opt_state(params), batch)
    dev = tree_map(lambda t: t.to(cuda), params)
    pg, sg, mg = step(dev, init_opt_state(dev), tree_map(lambda t: t.to(cuda), batch))
    assert mg["loss"].device.type == "cuda"
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 1e-4 * float(mc["grad_norm"])
    for (path, g), (_, c) in zip(tree_flatten(pg), tree_flatten(pc)):
        assert torch.linalg.norm(g.cpu() - c) <= 1e-4 * torch.linalg.norm(c) + 1e-12, path


def test_checkpoint_strips_from_k1_equal_the_plain_versions(cuda):
    """A bfloat16 training state coded on the card (K1, one launch per
    (n, k, strip bucket) group) and on the CPU (the plain version): every
    object byte for byte."""
    arch = get("qwen1.5-0.5b", smoke=True)
    params = arch.init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    opt = init_opt_state(params)
    opt = {"m": tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32)), opt["m"]),
           "v": opt["v"], "step": torch.tensor(5, dtype=torch.int32)}
    tree = {"params": params, "opt": opt}
    cpu_store, dev_store = MemoryStore(), MemoryStore()
    save_checkpoint(cpu_store, "ck", 5, tree, codec=Codec("kernel", device=CPU))
    before = gf2mm.gf2_rs_matmul_bytes.launches
    manifest = save_checkpoint(dev_store, "ck", 5, tree_map(lambda t: t.to(cuda), tree),
                               device=cuda)
    groups = {(m["n"], m["k"], pow2_bucket(m["strip_bytes"], 128))
              for m in manifest["leaves"].values()}
    assert gf2mm.gf2_rs_matmul_bytes.launches - before == len(groups)
    assert sorted(dev_store.keys()) == sorted(cpu_store.keys())
    for key in cpu_store.keys():
        assert dev_store.get(key) == cpu_store.get(key), key


def test_restart_from_lost_strips_on_the_card(cuda):
    """Train 3 steps on the card, lose strips 0 and 2 of every leaf, rebuild
    from the store (K1 decode), train 3 more: the final loss equals a
    straight 6-step run's to rel = 1e-4."""
    arch = get("qwen1.5-0.5b", smoke=True)
    tc = TrainerConfig(total_steps=6, ckpt_every=3, log_every=1, opt=AdamWConfig(lr=1e-3))
    log_a = Trainer(arch, SHAPE, MemoryStore(), cfg=tc, ckpt_prefix="a").run()
    store = MemoryStore()
    Trainer(arch, SHAPE, store, cfg=tc, ckpt_prefix="b").run(steps=3)
    faulty = FaultyStore(store)
    for key in store.keys():
        if key.endswith(("strip0", "strip2")):
            faulty.lose_object(key)
    before = gf2mm.gf2_rs_matmul_bytes.launches
    t = Trainer(arch, SHAPE, faulty, cfg=tc, ckpt_prefix="b")
    assert gf2mm.gf2_rs_matmul_bytes.launches > before  # the restore decoded on the card
    assert t.start_step == 3 and t.params["embedding"]["embed"].device.type == "cuda"
    log_b = t.run(steps=3)
    assert log_b[-1]["step"] == 6
    assert log_b[-1]["loss"] == pytest.approx(log_a[-1]["loss"], rel=1e-4)


def test_attention_backward_under_anomaly_detection(cuda):
    """The out-of-place score block: autograd's anomaly mode (which checks
    saved tensors' versions) finds no in-place write, windowed and
    soft-capped, over 8 × 8 chunks."""
    cfg = dataclasses.replace(get("gemma2-2b", smoke=True).cfg, attn_q_chunk=8,
                              attn_kv_chunk=8, dtype="float32")
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, h, 16)).astype(np.float32))
               .to(cuda).requires_grad_() for h in (4, 2, 2))
    with torch.autograd.set_detect_anomaly(True):
        out = ly.chunked_attention(cfg, q, k, v, window=12, softcap=50.0)
        gq, gk, gv = torch.autograd.grad(out.square().sum(), [q, k, v])
    assert all(torch.isfinite(g).all() for g in (gq, gk, gv))
    with torch.inference_mode():
        want = ly.chunked_attention(cfg, q.detach(), k.detach(), v.detach(), window=12,
                                    softcap=50.0)
    assert torch.equal(out.detach(), want)
