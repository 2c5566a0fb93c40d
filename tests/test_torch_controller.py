"""The port's controller against the reference package's: the tensor forms
of the TOFEC and MPC updates against the JAX forms on seeded sequences, and
the copied host policies against the originals.

Tolerances: (n, k) picks are exact. The float32 EWMA state agrees to
rtol 1e-6 — the two frameworks may order or fuse the multiply-adds
differently, which moves the last bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as ref_ctrl
from repro.core import static_optimizer as ref_opt
from repro.core.delay_model import PAPER_READ_3MB as REF_READ
from repro.core.delay_model import PAPER_WRITE_3MB as REF_WRITE
from repro.core.delay_model import RequestClass as RefRequestClass
from repro_torch.core import (
    PAPER_READ_3MB,
    PAPER_WRITE_3MB,
    FeedbackPolicy,
    FixedKAdaptivePolicy,
    GreedyPolicy,
    MPCPolicy,
    MPCTables,
    RequestClass,
    StaticPolicy,
    TofecTables,
    TOFECPolicy,
    build_class_plan,
    mpc_step,
    tofec_step,
)

L = 16
CPU = torch.device("cpu")
# The MPC parity grid of tests/test_fused_serve.py:190: (class args, L, λ, seed).
MPC_GRID = [
    (("r3", 3.0, "read", 6, 2.0, 12), 16, 2.0, 0),
    (("r3", 3.0, "read", 6, 2.0, 12), 16, 30.0, 1),
    (("w3", 3.0, "write", 4, 3.0, 12), 8, 5.0, 2),
    (("r1", 1.0, "read", 3, 2.0, 6), 4, 60.0, 3),
]


def _classes(name, mb, params, k_max, r_max, n_max):
    port = RequestClass(name, mb, PAPER_READ_3MB if params == "read" else PAPER_WRITE_3MB,
                        k_max=k_max, r_max=r_max, n_max=n_max)
    ref = RefRequestClass(name, mb, REF_READ if params == "read" else REF_WRITE,
                          k_max=k_max, r_max=r_max, n_max=n_max)
    return port, ref


CLS, REF_CLS = _classes("read3mb", 3.0, "read", 6, 2.0, 12)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def test_class_plans_and_tables_equal_reference():
    for args in [a for a, *_ in MPC_GRID]:
        cls_, ref_cls = _classes(*args)
        plan, ref_plan = build_class_plan(cls_, L), ref_opt.build_class_plan(ref_cls, L)
        for f in ("q_at_k", "q_at_n", "h_k", "h_n"):
            np.testing.assert_array_equal(getattr(plan, f), getattr(ref_plan, f))
        t, rt = TofecTables.from_plan(plan, device=CPU), ref_ctrl.TofecTables.from_plan(ref_plan)
        np.testing.assert_array_equal(t.h_k.numpy(), np.asarray(rt.h_k))
        np.testing.assert_array_equal(t.h_n.numpy(), np.asarray(rt.h_n))
        assert t.r_max == rt.r_max


@pytest.mark.parametrize("alpha,seed", [(0.7, 5), (0.99, 6), (1.0, 7)])
def test_tofec_step_matches_jax_form(alpha, seed):
    plan = build_class_plan(CLS, L)
    tables = TofecTables.from_plan(plan, device=CPU)
    ref_tables = ref_ctrl.TofecTables.from_plan(ref_opt.build_class_plan(REF_CLS, L))
    rng = np.random.default_rng(seed)
    q_t, q_j = _f32(-1.0), jnp.float32(-1.0)  # cold start on both sides
    for q in rng.integers(0, 40, size=80):
        q_t, n_t, k_t = tofec_step(q_t, int(q), tables, alpha)
        q_j, n_j, k_j = ref_ctrl.tofec_step_jax(q_j, jnp.float32(q), ref_tables, alpha)
        assert (int(n_t), int(k_t)) == (int(n_j), int(k_j))
        np.testing.assert_allclose(float(q_t), float(q_j), rtol=1e-6)


@pytest.mark.parametrize("args,pool,lam,seed", MPC_GRID)
def test_mpc_step_matches_jax_form_and_host_policy(args, pool, lam, seed):
    """Torch MPC against the JAX form and the host policy, draw for draw,
    on dt sequences with a cold start and unknown (dt < 0) arrivals."""
    cls_, ref_cls = _classes(*args)
    pol, ref_pol = MPCPolicy(cls_, pool), ref_ctrl.MPCPolicy(ref_cls, pool)
    tables = MPCTables.from_policy(pol, device=CPU)
    ref_tables = ref_ctrl.MPCTables.from_policy(ref_pol)
    rng = np.random.default_rng(seed)
    dts = rng.exponential(1.0 / lam, 120).astype(np.float32)
    qs = rng.integers(0, 50, 120)
    unknown = rng.random(120) < 0.1
    unknown[0] = True
    carry = (_f32(-1.0), _f32(0.0), _f32(0.0))
    ref_carry = (jnp.float32(-1.0), jnp.float32(0.0), jnp.float32(0.0))
    now = 0.0
    for dt, q, unk in zip(dts, qs, unknown):
        d = -1.0 if unk else float(dt)
        carry, n, k = mpc_step(carry, float(q), d, tables)
        ref_carry, n_j, k_j = ref_ctrl.mpc_step_jax(ref_carry, jnp.float32(q), jnp.float32(d),
                                                    ref_tables)
        assert (int(n), int(k)) == (int(n_j), int(k_j))
        for a, b in zip(carry, ref_carry):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        if unk:
            pol.last_arrival = None  # the host learns nothing from this arrival
            host = pol.select(q=int(q), idle=0, now=None)
        else:
            if pol.last_arrival is None:
                pol.last_arrival = now
            now = pol.last_arrival + float(dt)
            host = pol.select(q=int(q), idle=0, now=now)
        assert (int(n), int(k)) == host


@pytest.mark.parametrize("args,pool,lam,seed", MPC_GRID)
def test_mpc_tables_equal_reference(args, pool, lam, seed):
    cls_, ref_cls = _classes(*args)
    t = MPCTables.from_policy(MPCPolicy(cls_, pool), device=CPU)
    rt = ref_ctrl.MPCTables.from_policy(ref_ctrl.MPCPolicy(ref_cls, pool))
    for f in ("n", "k", "u", "ds", "L", "util_cap", "q_guard", "alpha_q", "alpha_rate"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(rt, f)))


def test_host_policies_equal_reference():
    """The copied host policies pick what the originals pick, on the cases
    of tests/test_core_tofec.py and a seeded (q, idle) stream."""
    rng = np.random.default_rng(8)
    pairs = [
        (StaticPolicy(6, 3), ref_ctrl.StaticPolicy(6, 3)),
        (TOFECPolicy.for_classes([CLS], L), ref_ctrl.TOFECPolicy.for_classes([REF_CLS], L)),
        (TOFECPolicy.for_classes([CLS], L, alpha=0.7),
         ref_ctrl.TOFECPolicy.for_classes([REF_CLS], L, alpha=0.7)),
        (GreedyPolicy(k_max=6, r_max=2.0), ref_ctrl.GreedyPolicy(k_max=6, r_max=2.0)),
        (FixedKAdaptivePolicy(CLS, L, k=6), ref_ctrl.FixedKAdaptivePolicy(REF_CLS, L, k=6)),
        (FixedKAdaptivePolicy(CLS, L, k=3), ref_ctrl.FixedKAdaptivePolicy(REF_CLS, L, k=3)),
        (MPCPolicy(CLS, L), ref_ctrl.MPCPolicy(REF_CLS, L)),
    ]
    stream = [(int(q), int(i)) for q, i in zip(rng.integers(0, 60, 150), rng.integers(0, 17, 150))]
    stream += [(500, 0)] * 50 + [(0, 16)] * 20
    for pol, ref_pol in pairs:
        now = 0.0
        for q, idle in stream:
            now += 0.01
            assert pol.select(q=q, idle=idle, now=now) == ref_pol.select(q=q, idle=idle, now=now)
        assert pol.name == ref_pol.name
    with pytest.raises(ValueError):
        StaticPolicy(2, 3)


def test_feedback_policy_replays_pushed_code():
    pol, ref_pol = FeedbackPolicy(12, 6), ref_ctrl.FeedbackPolicy(12, 6)
    for n, k in [(4, 2), (1, 1), (9, 6)]:
        pol.push(n, k)
        ref_pol.push(n, k)
        assert pol.select(q=3, idle=0) == ref_pol.select(q=3, idle=0) == (n, k)
    with pytest.raises(ValueError):
        pol.push(2, 3)
