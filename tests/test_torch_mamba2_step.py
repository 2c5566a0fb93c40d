"""Mamba2's decode recurrence on the CPU. ``ssm.mamba2_recurrence_step``,
which runs the hand-written kernel on a card, runs the plain
``ssm.linear_recurrence_step`` here: its results are that function's bit for
bit, B and C read by group equal ``ssm._per_head``'s repeat, and a
destination (fresh or the state itself) takes exactly the new state. The
kernel's wrapper (``repro_torch.kernels.ssm.mamba2_step``) refuses what the
kernel does not take, CPU tensors included, before a launch.
``ssm.mamba2_decode_step`` gives the same results with a destination as
without, and both families' ``decode_step`` advances the cache's own Mamba2
stack in place, one recurrence step a Mamba2 layer, at zamba2's and
Nemotron-3-Nano's smoke configs. The kernel itself is held to the plain version on the card in
``tests/test_torch_mamba2_kernel_cuda.py``."""

import dataclasses
import types

import pytest
import torch

from repro_torch.kernels.ssm.mamba2_step import mamba2_step, step_counts
from repro_torch.models import get, ssm
from repro_torch.models.registry import Arch
from repro_torch.tree import tree_flatten, tree_map

CPU = torch.device("cpu")


def _inputs(B, H, G, N, P, dtype=torch.float32, seed=0):
    """q, k (B, G, N) and v (B, H, P) as row slices of one projection, as
    the model makes them; log_a ≤ 0 and dt > 0 (B, H); a drawn state."""
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn((B, 2 * G * N + H * P + 5), generator=g).to(dtype)
    v, k, q = torch.split(proj[:, :-5], [H * P, G * N, G * N], dim=-1)
    dt_ = torch.rand((B, H), generator=g) + 0.05
    log_a = -dt_ * torch.rand((H,), generator=g) * 2.0
    state = torch.randn((B, H, N, P), generator=g)
    n_state = torch.randn((B, H, N), generator=g)
    return (q.unflatten(-1, (G, N)), k.unflatten(-1, (G, N)), v.unflatten(-1, (H, P)), log_a,
            dt_, state, n_state)


SHAPES = [(2, 4, 4, 8, 12), (2, 4, 2, 8, 12), (3, 6, 1, 16, 24), (1, 8, 4, 5, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_step_is_the_plain_recurrence_on_heads_repeated_by_group(shape, dtype):
    B, H, G, N, P = shape
    q, k, v, log_a, dt_, state, n_state = _inputs(*shape, dtype=dtype)
    # the prefill's per-head B and C: head h reads group h // (H / G)
    cfg = types.SimpleNamespace(ssm_heads=H, ssm_groups=G, ssm_state=N)
    want = ssm.linear_recurrence_step(ssm._per_head(q, cfg, (B,)), ssm._per_head(k, cfg, (B,)),
                                      v, log_a, dt_, state, n_state)
    got = ssm.mamba2_recurrence_step(q, k, v, log_a, dt_, state, n_state)
    for g_, w in zip(got, want, strict=True):
        assert g_.dtype == torch.float32 and torch.equal(g_, w)


@pytest.mark.parametrize("in_place", [False, True])
def test_cpu_step_writes_its_destination(in_place):
    q, k, v, log_a, dt_, state, n_state = _inputs(2, 4, 2, 8, 12, seed=1)
    y0, s0, n0 = ssm.mamba2_recurrence_step(q, k, v, log_a, dt_, state, n_state)
    if in_place:
        out = (state, n_state)
    else:
        out = (torch.full_like(state, float("nan")), torch.full_like(n_state, float("nan")))
    y, s, n = ssm.mamba2_recurrence_step(q, k, v, log_a, dt_, state, n_state, out=out)
    assert s is out[0] and n is out[1]
    assert torch.equal(y, y0) and torch.equal(s, s0) and torch.equal(n, n0)


def _bad_cases():
    """(what, change to the good arguments, the error it raises)."""
    def cut(t):
        return t[..., :-1]

    return [
        ("state float64", lambda a: {**a, "state": a["state"].double()}, TypeError),
        ("n float64", lambda a: {**a, "n_state": a["n_state"].double()}, TypeError),
        ("gate bfloat16", lambda a: {**a, "gate": a["gate"].bfloat16()}, TypeError),
        ("k float16", lambda a: {**a, "k": a["k"].half()}, TypeError),
        ("q and k differ", lambda a: {**a, "q": a["q"].bfloat16()}, TypeError),
        ("state rank 3", lambda a: {**a, "state": a["state"][:, :, 0]}, ValueError),
        ("n short", lambda a: {**a, "n_state": cut(a["n_state"])}, ValueError),
        ("v short", lambda a: {**a, "v": cut(a["v"])}, ValueError),
        ("log_a transposed", lambda a: {**a, "log_a": a["log_a"].T}, ValueError),
        ("groups do not divide heads", lambda a: {**a, "q": a["q"][:, :3], "k": a["k"][:, :3]},
         ValueError),
        ("state not contiguous",
         lambda a: {**a, "state": a["state"].transpose(2, 3).contiguous().transpose(2, 3)},
         ValueError),
        ("n not contiguous",
         lambda a: {**a, "n_state": a["n_state"].transpose(1, 2).contiguous().transpose(1, 2)},
         ValueError),
        ("k rows strided", lambda a: {**a, "k": torch.cat([a["k"], a["k"]], -1)[..., ::2]},
         ValueError),
        ("out state float64", lambda a: {**a, "out": (a["state"].double(), a["n_state"])},
         TypeError),
        ("out a single tensor", lambda a: {**a, "out": a["state"]}, TypeError),
    ]


@pytest.mark.parametrize("what,change,error", _bad_cases(), ids=[c[0] for c in _bad_cases()])
def test_step_refuses_what_the_kernel_does_not_take(what, change, error):
    q, k, v, log_a, dt_, state, n_state = _inputs(2, 4, 4, 8, 12, seed=2)
    args = dict(q=q, k=k, v=v, log_a=log_a, gate=dt_, state=state, n_state=n_state, out=None)
    before = (state.clone(), n_state.clone(), mamba2_step.launches)
    bad = change(args)
    with pytest.raises(error):
        mamba2_step(bad["q"], bad["k"], bad["v"], bad["log_a"], bad["gate"], bad["state"],
                    bad["n_state"], out=bad["out"])
    assert torch.equal(state, before[0]) and torch.equal(n_state, before[1])
    assert mamba2_step.launches == before[2]


def test_the_kernel_refuses_cpu_tensors():
    q, k, v, log_a, dt_, state, n_state = _inputs(2, 4, 2, 8, 12, seed=4)
    before = (state.clone(), mamba2_step.launches)
    with pytest.raises(ValueError, match="CUDA"):
        mamba2_step(q, k, v, log_a, dt_, state, n_state, out=(state, n_state))
    assert torch.equal(state, before[0]) and mamba2_step.launches == before[1]


@pytest.mark.parametrize("name", ["zamba2-2.7b", "nemotron3-nano-30b-a3b"])
def test_both_mamba2_families_step_the_recurrence_once_a_mamba2_layer(name, monkeypatch):
    """Each decode step of the smoke model runs Mamba2's recurrence step
    (the kernel's launch on a card) once for each Mamba2 layer."""
    arch = _smoke(name)
    n_mamba = len(arch.init_cache(1, 4, device="meta")["mamba"][1])
    calls = []
    inner = ssm.mamba2_recurrence_step

    def spy(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    monkeypatch.setattr(ssm, "mamba2_recurrence_step", spy)
    params = arch.init(torch.Generator().manual_seed(5))
    toks = torch.randint(0, arch.cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32)
    _, cache = arch.prefill_tokens(params, toks, max_seq=9)
    assert not calls  # the prefill runs the chunked recurrence
    for step in range(1, 4):
        _, cache = arch.decode_step(params, toks[:, step:step + 1], cache)
        assert len(calls) == n_mamba * step


def test_step_refuses_a_destination_that_partly_overlaps_the_state():
    q, k, v, log_a, dt_, state, n_state = _inputs(2, 4, 4, 8, 12, seed=3)
    flat = torch.zeros(state.numel() + 4)
    src = flat[:state.numel()].view_as(state)
    src.copy_(state)
    shifted = flat[4:].view_as(state)
    with pytest.raises(ValueError, match="overlaps"):
        mamba2_step(q, k, v, log_a, dt_, src, n_state, out=(shifted, n_state))


def test_step_counts_follow_the_shapes():
    ops, nbytes = step_counts(64, 64, 8, 128, 64, 2)
    assert ops == 6.0 * 64 * 64 * 128 * 64 + 3.0 * 64 * 64 * 128
    # the state and n read and written; q, k by group, v, the gates and y once
    assert nbytes == (8 * 64 * 64 * (128 * 64 + 128) + 2 * 64 * (2 * 8 * 128 + 64 * 64)
                      + 4 * 64 * 64 * (2 + 64))


def _smoke(name):
    base = get(name, smoke=True)
    return Arch(dataclasses.replace(base.cfg, dtype="float32"), base.module)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "nemotron3-nano-30b-a3b"])
@pytest.mark.parametrize("in_place", [False, True])
def test_decode_step_with_a_destination_equals_it_without(name, in_place):
    """One Mamba2 layer's decode step at the family's smoke widths (A_log
    and dt_bias drawn) from a prefilled state; with ``out`` fresh slots or
    the state's own tensors."""
    cfg = _smoke(name).cfg
    p = ssm.init_mamba2(torch.Generator().manual_seed(3), cfg, CPU)
    g = torch.Generator().manual_seed(4)
    p["A_log"] = torch.randn(p["A_log"].shape, generator=g) * 0.5
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=g)
    x = torch.randn((2, 9, cfg.d_model), generator=g)
    _, st = ssm.mamba2_block(p, cfg, x[:, :8])
    want_y, want_st = ssm.mamba2_decode_step(p, cfg, x[:, 8:], st)
    src = tree_map(torch.clone, st)
    out = src if in_place else tuple(torch.full_like(t, float("nan")) for t in st)
    y, new = ssm.mamba2_decode_step(p, cfg, x[:, 8:], src, out=out)
    assert torch.equal(y, want_y)
    for got, dst, want in zip(new, out, want_st, strict=True):
        assert got.data_ptr() == dst.data_ptr() and torch.equal(got, want)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "nemotron3-nano-30b-a3b"])
def test_family_decode_into_its_own_stack_equals_a_fresh_one(name):
    """Eight decode steps of the whole smoke model advance the cache's own
    Mamba2 stack in place (its storage kept), with the logits and the whole
    cache of the same steps each run on a fresh copy of the cache."""
    arch = _smoke(name)
    params = arch.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, arch.cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    _, cache = arch.prefill_tokens(params, toks, max_seq=17)
    fresh = tree_map(torch.clone, cache)
    ptrs = [t.data_ptr() for t in cache["mamba"]]
    tok = toks[:, -1:]
    for i in range(8):
        lg, cache = arch.decode_step(params, tok, cache)
        want, fresh = arch.decode_step(params, tok, tree_map(torch.clone, fresh))
        assert [t.data_ptr() for t in cache["mamba"]] == ptrs, i
        assert torch.equal(lg, want), i
        for (where, a), (_, b) in zip(tree_flatten(cache), tree_flatten(fresh), strict=True):
            assert torch.equal(a, b), (i, where)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
