"""The port's recurrent blocks (``repro_torch.models.ssm``) against the
reference's ``repro/models/ssm.py`` on the CPU: the chunked linear
recurrence and its one-step form, the mLSTM and the sLSTM.

Inputs are drawn with numpy from a seed and go through both packages.
Tolerances: the chunked recurrence to 1e-5 of the reference's chunked form
(the same algorithm, other summation orders) and to 2e-4 of the port's own
step-by-step oracle (the bar of ``tests/test_ssm_property.py``); the blocks
and decode steps to 1e-5 in float32 and to one bfloat16 step (2^-7
relative, 1e-2 absolute) in bfloat16, outputs and every state leaf."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import get as ref_get
from repro.models import ssm as ref_ssm
from repro_torch.models import params_from_numpy, ssm
from repro_torch.models.config import ModelConfig

CPU = torch.device("cpu")
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-2)}  # (rtol, atol)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def _close(got, want, tol, what):
    rtol, atol = tol
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _recurrence_inputs(seed, B=2, S=13, H=2, dk=5, dv=4):
    """q, k, v, log_a (≤ 0) and gate_i (in [0, 1)), float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, dk)).astype(np.float32),
            rng.normal(size=(B, S, H, dk)).astype(np.float32),
            rng.normal(size=(B, S, H, dv)).astype(np.float32),
            -np.abs(rng.normal(size=(B, S, H))).astype(np.float32),
            rng.uniform(0, 1, size=(B, S, H)).astype(np.float32))


def _step_oracle(q, k, v, log_a, gate_i, normalize, state=None):
    """The port's ``linear_recurrence_step`` position by position."""
    B, S, H, dk = q.shape
    if state is None:
        state = (torch.zeros((B, H, dk, v.shape[-1])), torch.zeros((B, H, dk)))
    S_state, n_state = state
    ys = []
    for t in range(S):
        y, S_state, n_state = ssm.linear_recurrence_step(
            q[:, t], k[:, t], v[:, t], log_a[:, t], gate_i[:, t], S_state, n_state,
            normalize=normalize)
        ys.append(y)
    return torch.stack(ys, dim=1), S_state, n_state


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 8])
def test_chunked_recurrence_matches_reference_and_step_oracle(chunk, normalize):
    """S = 13 is a multiple of no chunk but 1, so the padding rule runs
    for 2, 3, 4 and 8."""
    args = _recurrence_inputs(chunk * 10 + normalize)
    want_y, (want_S, want_n) = ref_ssm.chunk_linear_recurrence(
        *map(jnp.asarray, args), chunk=chunk, normalize=normalize)
    t_args = [torch.from_numpy(a) for a in args]
    y, (Sf, nf) = ssm.chunk_linear_recurrence(*t_args, chunk=chunk, normalize=normalize)
    assert y.shape == args[2].shape and y.dtype == torch.float32
    for got, want, what in ((y, want_y, "y"), (Sf, want_S, "S"), (nf, want_n, "n")):
        _close(got, want, (1e-5, 1e-5), f"{what} against the reference")
    oy, oS, on = _step_oracle(*t_args, normalize)
    for got, want, what in ((y, oy, "y"), (Sf, oS, "S"), (nf, on, "n")):
        _close(got, want, (2e-4, 2e-4), f"{what} against the step oracle")


@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_recurrence_from_a_given_state(normalize):
    """``init_state`` carried into the first chunk, S = 11 over chunks of 4."""
    args = _recurrence_inputs(7, S=11)
    rng = np.random.default_rng(8)
    S0 = rng.normal(size=(2, 2, 5, 4)).astype(np.float32)
    n0 = np.abs(rng.normal(size=(2, 2, 5))).astype(np.float32)
    want_y, (want_S, want_n) = ref_ssm.chunk_linear_recurrence(
        *map(jnp.asarray, args), chunk=4, init_state=(jnp.asarray(S0), jnp.asarray(n0)),
        normalize=normalize)
    t_args = [torch.from_numpy(a) for a in args]
    state = (torch.from_numpy(S0), torch.from_numpy(n0))
    y, (Sf, nf) = ssm.chunk_linear_recurrence(*t_args, chunk=4, init_state=state,
                                              normalize=normalize)
    for got, want, what in ((y, want_y, "y"), (Sf, want_S, "S"), (nf, want_n, "n")):
        _close(got, want, (1e-5, 1e-5), what)
    oy, oS, on = _step_oracle(*t_args, normalize, state=state)
    for got, want, what in ((y, oy, "y"), (Sf, oS, "S"), (nf, on, "n")):
        _close(got, want, (2e-4, 2e-4), f"{what} against the step oracle")


def test_unroll_flag_is_equivalent():
    """The reference's ``test_unroll_flag_is_equivalent``: the flag changes
    nothing (the port's loop is always unrolled)."""
    args = [torch.from_numpy(a) for a in _recurrence_inputs(0, S=12, dk=4, dv=4)]
    y1, s1 = ssm.chunk_linear_recurrence(*args, chunk=4, unroll=False)
    y2, s2 = ssm.chunk_linear_recurrence(*args, chunk=4, unroll=True)
    assert torch.equal(y1, y2) and all(torch.equal(a, b) for a, b in zip(s1, s2))


@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_recurrence_gradient_is_finite_under_strong_decay(normalize):
    """Decays near e^-1 a position over chunks of 128, as Mamba2's dt·A
    gives them at full width: above the diagonal, cum_t − cum_s reaches
    ~130, whose exp overflows float32. The values equal the reference's
    (1e-5) and the step oracle's (2e-4); every gradient is finite and equals
    the step oracle's to 1e-4 of its norm. The reference's own gradient is
    NaN there: its where(tri, exp(d), 0) sends 0 · inf back through the
    exp."""
    args = list(_recurrence_inputs(11, B=1, S=160, H=2, dk=4, dv=3))
    args[3] = -(1.0 + 0.1 * np.abs(args[3]))
    want_y, _ = ref_ssm.chunk_linear_recurrence(*map(jnp.asarray, args), chunk=128,
                                                normalize=normalize)
    ref_grad = jax.grad(lambda la: jnp.sum(ref_ssm.chunk_linear_recurrence(
        *map(jnp.asarray, args[:3]), la, jnp.asarray(args[4]), chunk=128,
        normalize=normalize)[0]))(jnp.asarray(args[3]))
    assert bool(jnp.isnan(ref_grad).any())
    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    y, (Sf, nf) = ssm.chunk_linear_recurrence(*t_args, chunk=128, normalize=normalize)
    _close(y.detach(), want_y, (1e-5, 1e-5), "y against the reference")
    grads = torch.autograd.grad((y.sum() + Sf.sum() + nf.sum()), t_args)
    o_args = [torch.from_numpy(a).requires_grad_() for a in args]
    oy, oS, on = _step_oracle(*o_args, normalize)
    _close(y.detach(), oy.detach(), (2e-4, 2e-4), "y against the step oracle")
    o_grads = torch.autograd.grad((oy.sum() + oS.sum() + on.sum()), o_args)
    for g, w, what in zip(grads, o_grads, ("q", "k", "v", "log_a", "gate_i")):
        assert bool(torch.isfinite(g).all()), what
        assert torch.linalg.norm(g - w) <= 1e-4 * torch.linalg.norm(w), what


@pytest.mark.parametrize("normalize", [False, True])
def test_recurrence_step_matches_reference(normalize):
    q, k, v, log_a, gate_i = (a[:, 0] for a in _recurrence_inputs(5))
    rng = np.random.default_rng(6)
    S0 = rng.normal(size=(2, 2, 5, 4)).astype(np.float32)
    n0 = rng.normal(size=(2, 2, 5)).astype(np.float32)
    args = (q, k, v, log_a, gate_i, S0, n0)
    want = ref_ssm.linear_recurrence_step(*map(jnp.asarray, args), normalize=normalize)
    got = ssm.linear_recurrence_step(*map(torch.from_numpy, args), normalize=normalize)
    for g, w, what in zip(got, want, ("y", "S", "n")):
        _close(g, w, (1e-6, 1e-6), what)


def test_log_sigmoid_is_the_references():
    """The gates' log-sigmoid over the float32 range the stabilizer sees,
    from deep saturation on both sides through 0."""
    x = np.concatenate([np.linspace(-100, 100, 2001), [-1e4, -30.0, 1e-7, 30.0, 1e4]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    got = F.logsigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -- the cells ---------------------------------------------------------------------


#: (d_model, n_heads, ssm_chunk): the xlstm smoke config's head width (64,
#: whose √ is exact), a head of 32 (√32 rounds in bfloat16) and the published
#: head of 512 (√512 → 22.625 in bfloat16) with one head.
CELL_CONFIGS = [(64, 2, 8), (32, 2, 4), (256, 1, 4)]


def _cfgs(dtype, d_model, n_heads, chunk):
    ref = dataclasses.replace(ref_get("xlstm-350m", smoke=True).cfg, dtype=dtype,
                              d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
                              ssm_chunk=chunk)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _cell_params(ref_init, cfg, seed):
    rp = ref_init(jax.random.key(seed), cfg)
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), CPU)


def _x(cfg, seed, B=2, S=11):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, cfg.dtype), torch.from_numpy(x).to(getattr(torch, cfg.dtype))


def test_query_scale_rounds_as_the_reference():
    assert ssm._query_scale(512, torch.bfloat16) == 22.625
    assert ssm._query_scale(512, torch.float32) == float(np.float32(math.sqrt(512)))
    assert float(jnp.asarray(1.0, jnp.bfloat16) * math.sqrt(512)) == 22.625


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", CELL_CONFIGS)
def test_mlstm_block_and_decode_match_reference(dims, dtype):
    """The block over 11 positions (chunks of 4 or 8: padded), then from its
    final state 3 decode steps, and the block once more from that state."""
    ref_cfg, cfg = _cfgs(dtype, *dims)
    tol = TOL[dtype]
    rp, pp = _cell_params(ref_ssm.init_mlstm, ref_cfg, 1)
    jx, tx = _x(cfg, 2)
    want, want_st = ref_ssm.mlstm_block(rp, ref_cfg, jx)
    got, st = ssm.mlstm_block(pp, cfg, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, tol, "block output")
    for g, w, what in zip(st, want_st, ("S", "n")):
        _close(g, w, tol, f"block state {what}")
    jx1, tx1 = _x(cfg, 3, S=3)
    for t in range(3):
        want, want_st = ref_ssm.mlstm_decode_step(rp, ref_cfg, jx1[:, t:t + 1], want_st)
        got, st = ssm.mlstm_decode_step(pp, cfg, tx1[:, t:t + 1], st)
        _close(got, want, tol, f"decode step {t}")
        for g, w, what in zip(st, want_st, ("S", "n")):
            _close(g, w, tol, f"decode step {t} state {what}")
    want, want_st = ref_ssm.mlstm_block(rp, ref_cfg, jx1, state=want_st)
    got, st = ssm.mlstm_block(pp, cfg, tx1, state=st)
    _close(got, want, tol, "block from a state")
    for g, w, what in zip(st, want_st, ("S", "n")):
        _close(g, w, tol, f"block from a state: state {what}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", CELL_CONFIGS[:2])
def test_slstm_block_and_decode_match_reference(dims, dtype):
    """The block over 11 positions, 3 decode steps from its state, and the
    block again from there: output, h (in the model's dtype), c, n and the
    stabilizer m."""
    ref_cfg, cfg = _cfgs(dtype, *dims)
    tol = TOL[dtype]
    rp, pp = _cell_params(ref_ssm.init_slstm, ref_cfg, 4)
    jx, tx = _x(cfg, 5)
    want, want_st = ref_ssm.slstm_block(rp, ref_cfg, jx)
    got, st = ssm.slstm_block(pp, cfg, tx)
    assert got.dtype == tx.dtype and st[0].dtype == tx.dtype
    assert all(t.dtype == torch.float32 for t in st[1:])

    def check(what):
        _close(got, want, tol, f"{what} output")
        for g, w, name in zip(st, want_st, "hcnm"):
            _close(g, w, tol, f"{what} state {name}")

    check("block")
    jx1, tx1 = _x(cfg, 6, S=3)
    for t in range(3):
        want, want_st = ref_ssm.slstm_decode_step(rp, ref_cfg, jx1[:, t:t + 1], want_st)
        got, st = ssm.slstm_decode_step(pp, cfg, tx1[:, t:t + 1], st)
        check(f"decode step {t}")
    want, want_st = ref_ssm.slstm_block(rp, ref_cfg, jx1, state=want_st)
    got, st = ssm.slstm_block(pp, cfg, tx1, state=st)
    check("block from a state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_inits_match_reference(dtype):
    ref_cfg, cfg = _cfgs(dtype, 64, 2, 8)
    for ref_init, init in ((ref_ssm.mlstm_state_init, ssm.mlstm_state_init),
                           (ref_ssm.slstm_state_init, ssm.slstm_state_init)):
        want, got = ref_init(ref_cfg, 3), init(cfg, 3, CPU)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            np.testing.assert_array_equal(_np(g), _np(w))
    h, c, n, m = ssm.slstm_state_init(cfg, 3, CPU)
    assert len({t.data_ptr() for t in (h, c, n, m)}) == 4  # no two alias
