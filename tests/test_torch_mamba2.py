"""The port's Mamba2 block (``repro_torch.models.ssm``) against the
reference's ``repro/models/ssm.py:301-420`` on the CPU, at the zamba2-2.7b
smoke config's widths (d_model 64, 4 heads of 32, state 16).

Inputs are drawn with numpy from a seed and go through both packages; the
reference's parameters are carried across with ``params_from_numpy``.
Tolerances: outputs and every state leaf to 1e-5 in float32 (the chunked
recurrence sums in other orders) and to one bfloat16 step (2^-7 relative,
1e-2 absolute) in bfloat16. The prefill conv is held bit for bit against
the reference's expression run eagerly (as the reference's ``prefill`` runs
it), the decode conv bit for bit against its ``einsum``; softplus and silu
to 2 float32 ulps (torch's ``logaddexp`` is an ulp off ``jax.nn.softplus``
in a few per cent of inputs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get as ref_get
from repro.models import ssm as ref_ssm
from repro_torch.models import params_from_numpy, ssm
from repro_torch.models.config import ModelConfig

CPU = torch.device("cpu")
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-2)}  # (rtol, atol)
ULP2 = 2.0 * 2.0 ** -23


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def _close(got, want, tol, what):
    rtol, atol = tol
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _cfgs(dtype, chunk=8):
    ref = dataclasses.replace(ref_get("zamba2-2.7b", smoke=True).cfg, dtype=dtype,
                              ssm_chunk=chunk)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _params(ref_cfg, seed=1):
    """The reference's Mamba2 parameters with A_log, D and dt_bias drawn away
    from their constant init, so decay, skip and bias all matter."""
    rp = ref_ssm.init_mamba2(jax.random.key(seed), ref_cfg)
    rng = np.random.default_rng(seed)
    H = ref_cfg.n_heads
    rp = {**jax.tree.map(np.asarray, rp),
          "A_log": rng.normal(size=H).astype(np.float32) * 0.5,
          "D": rng.normal(size=H).astype(np.float32),
          "dt_bias": rng.normal(size=H).astype(np.float32)}
    return jax.tree.map(jnp.asarray, rp), params_from_numpy(rp, CPU)


def _x(cfg, seed, B=2, S=11):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, cfg.dtype), torch.from_numpy(x).to(getattr(torch, cfg.dtype))


def _check_state(got, want, tol, what):
    assert len(got) == len(want) == 3
    for g, w, name in zip(got, want, ("conv_buf", "S", "n")):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (what, name)
        assert tuple(g.shape) == tuple(w.shape), (what, name)
        _close(g, w, tol, f"{what}: state {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S, chunk", [(3, 2), (5, 4), (16, 6)])
def test_mamba2_block_matches_reference(S, chunk, dtype):
    """The block over S positions (no chunk divides S), then over 5 more
    from its state: outputs and the (conv_buf, S, n) states."""
    ref_cfg, cfg = _cfgs(dtype, chunk)
    tol = TOL[dtype]
    rp, pp = _params(ref_cfg)
    jx, tx = _x(cfg, 2, S=S)
    want, want_st = ref_ssm.mamba2_block(rp, ref_cfg, jx)
    got, st = ssm.mamba2_block(pp, cfg, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, tol, "block output")
    _check_state(st, want_st, tol, "block")
    jx2, tx2 = _x(cfg, 3, S=5)
    want, want_st = ref_ssm.mamba2_block(rp, ref_cfg, jx2, state=want_st)
    got, st = ssm.mamba2_block(pp, cfg, tx2, state=st)
    _close(got, want, tol, "block from a state")
    _check_state(st, want_st, tol, "block from a state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_steps_match_reference(dtype):
    """3 decode steps from the block's state after 7 positions."""
    ref_cfg, cfg = _cfgs(dtype)
    tol = TOL[dtype]
    rp, pp = _params(ref_cfg, seed=4)
    jx, tx = _x(cfg, 5, S=7)
    _, want_st = ref_ssm.mamba2_block(rp, ref_cfg, jx)
    _, st = ssm.mamba2_block(pp, cfg, tx)
    jx1, tx1 = _x(cfg, 6, S=3)
    for t in range(3):
        want, want_st = ref_ssm.mamba2_decode_step(rp, ref_cfg, jx1[:, t:t + 1], want_st)
        got, st = ssm.mamba2_decode_step(pp, cfg, tx1[:, t:t + 1], st)
        assert got.shape == (2, 1, cfg.d_model) and got.dtype == tx.dtype
        _close(got, want, tol, f"decode step {t}")
        _check_state(st, want_st, tol, f"decode step {t}")


def _conv_inputs(seed, B=2, S=16, K=4, C=512):
    rng = np.random.default_rng(seed)
    xbc_pad = rng.normal(size=(B, S + K - 1, C)).astype(np.float32)
    conv_w = (rng.normal(size=(K, C)) * 0.1).astype(np.float32)
    return (jnp.asarray(xbc_pad, jnp.bfloat16), jnp.asarray(conv_w, jnp.bfloat16),
            torch.from_numpy(xbc_pad).bfloat16(), torch.from_numpy(conv_w).bfloat16())


def test_prefill_conv_rounds_after_every_term_as_the_eager_reference():
    """The reference's conv (``ssm.py:358-361``: a bfloat16 product, then
    bfloat16 adds in tap order), run eagerly, equals the port's bit for bit;
    one rounding of a float32 accumulation differs in a large share."""
    S = 16
    jpad, jw, tpad, tw = _conv_inputs(7, S=S)
    want = sum(jpad[:, i:i + S, :] * jw[i][None, None, :] for i in range(jw.shape[0]))
    got = ssm.causal_conv(tpad, tw, S)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    once = sum(tpad[:, i:i + S].float() * tw[i].float() for i in range(4)).bfloat16()
    assert (_np(once) != _np(want)).mean() > 0.2


def test_decode_conv_rounds_once_as_the_reference_einsum():
    """The decode step's conv equals ``jnp.einsum("bkc,kc->bc")`` on bfloat16
    inputs bit for bit (XLA accumulates it in float32 and rounds once); the
    prefill conv's sequential bfloat16 sum differs in a large share."""
    jpad, jw, tpad, tw = _conv_inputs(8, S=1)
    want = jnp.einsum("bkc,kc->bc", jpad, jw)
    got = ssm.decode_conv(tpad, tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    seq = ssm.causal_conv(tpad, tw, 1)[:, 0]
    assert (_np(seq) != _np(want)).mean() > 0.2


def test_softplus_and_silu_are_jax_nn_to_two_ulps():
    x = np.random.default_rng(9).normal(size=100_000).astype(np.float32) * 6
    t = torch.from_numpy(x)
    np.testing.assert_allclose(ssm._softplus(t).numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=ULP2, atol=0)
    np.testing.assert_allclose(ssm._silu_f32(t).numpy(), np.asarray(jax.nn.silu(x)),
                               rtol=ULP2, atol=1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_state_init_matches_reference(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    want, got = ref_ssm.mamba2_state_init(ref_cfg, 3), ssm.mamba2_state_init(cfg, 3, CPU)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _np(w))


def test_init_mamba2_matches_reference_shapes_and_distributions():
    """w_in at 1/√d, conv normal × 0.1 in the model's dtype, w_out at 1/√d_inner;
    A_log and dt_bias float32 zeros, D float32 ones; drawn w_in, conv, w_out."""
    ref_cfg, _ = _cfgs("bfloat16")
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(ref_cfg, d_model=256)))
    want = jax.eval_shape(lambda k: ref_ssm.init_mamba2(k, dataclasses.replace(
        ref_cfg, d_model=256)), jax.random.key(0))
    p = ssm.init_mamba2(torch.Generator().manual_seed(3), cfg)
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in p.items()} == {
        k: (tuple(a.shape), str(a.dtype)) for k, a in want.items()}
    for w, scale in ((p["w_in"], 1 / 16), (p["conv"], 0.1), (p["w_out"], 1 / np.sqrt(512))):
        assert abs(w.float().std().item() / scale - 1.0) < 0.05
    assert not p["A_log"].any() and not p["dt_bias"].any() and bool((p["D"] == 1).all())
    gen = torch.Generator().manual_seed(3)
    w_in = torch.randn(p["w_in"].shape, generator=gen)
    conv = torch.randn(p["conv"].shape, generator=gen)
    w_out = torch.randn(p["w_out"].shape, generator=gen)
    assert torch.equal(p["w_in"], (w_in / 16).bfloat16())
    assert torch.equal(p["conv"], (conv * 0.1).bfloat16())
    assert torch.equal(p["w_out"], (w_out * (1 / np.sqrt(512))).bfloat16())


def test_short_prompt_leaves_no_conv_buffer_and_decode_raises():
    """S < ssm_conv − 1: the reference returns a None conv buffer, and so
    does the port; a decode step from that state raises a clear error."""
    ref_cfg, cfg = _cfgs("float32")
    rp, pp = _params(ref_cfg)
    jx, tx = _x(cfg, 10, S=2)
    want, want_st = ref_ssm.mamba2_block(rp, ref_cfg, jx)
    got, st = ssm.mamba2_block(pp, cfg, tx)
    assert want_st[0] is None and st[0] is None
    _close(got, want, TOL["float32"], "output")
    _close(st[1], want_st[1], TOL["float32"], "S")
    with pytest.raises(ValueError, match="conv buffer"):
        ssm.mamba2_decode_step(pp, cfg, tx[:, :1], st)
