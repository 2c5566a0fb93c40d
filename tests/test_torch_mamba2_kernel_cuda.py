"""The Mamba2 decode step's kernel (``kernels/ssm/csrc/mamba2_step.cu``) on
the card against the plain ``ssm.linear_recurrence_step`` run there. Each
test is marked ``cuda`` and skips where no CUDA card is present; the file
imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_mamba2_kernel_cuda.py

S' and n' are bit-equal to the plain version's (the kernel rounds every
product and the add as it does). y = qᵀS' is a float32 sum in another order
than the plain einsum's, so both are held to the float64 sum of the same
float32 S' within N · 2⁻²⁴ · Σₙ |q[n] S'[n, p]|, the bound of any order of
summation of N terms. Shapes: Nemotron-3-Nano's layer (64, 64, 128, 64) with
B and C in 8 groups, zamba2-2.7b's (32, 32, 64, 160) per head, and ragged
ones (P not a multiple of the tile, of 4, or P over one tile)."""

import pytest
import torch

from repro_torch.kernels.ssm.mamba2_step import mamba2_step
from repro_torch.models import ssm

pytestmark = pytest.mark.cuda

#: (B, H, G, N, P, dtype of q, k, v)
SHAPES = {
    "nemotron": (64, 64, 8, 128, 64, torch.bfloat16),
    "zamba2": (32, 32, 32, 64, 160, torch.bfloat16),
    "ragged": (3, 6, 3, 16, 24, torch.float32),
    "p_not_by_4": (2, 5, 5, 7, 13, torch.bfloat16),
    "p_tiles": (2, 3, 1, 40, 300, torch.float32),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    """q, k (B, G, N) and v (B, H, P) as row slices of one projection, as
    Mamba2 makes them; log_a ≤ 0, dt > 0 (B, H); a drawn state."""
    B, H, G, N, P, dtype = shape
    g = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn((B, H * P + 2 * G * N + 3), generator=g, device=device).to(dtype)
    v, k, q = torch.split(proj[:, :-3], [H * P, G * N, G * N], dim=-1)
    dt_ = torch.rand((B, H), generator=g, device=device) * 2.0 + 0.01
    log_a = -dt_ * torch.rand((H,), generator=g, device=device) * 4.0
    state = torch.randn((B, H, N, P), generator=g, device=device)
    n_state = torch.randn((B, H, N), generator=g, device=device)
    return (q.unflatten(-1, (G, N)), k.unflatten(-1, (G, N)), v.unflatten(-1, (H, P)), log_a,
            dt_, state, n_state)


def _plain(q, k, v, log_a, dt_, state, n_state):
    rep = state.shape[1] // k.shape[1]
    return ssm.linear_recurrence_step(q.repeat_interleave(rep, dim=1),
                                      k.repeat_interleave(rep, dim=1), v, log_a, dt_, state,
                                      n_state)


def _assert_y(y, q, s_new):
    """y against the float64 sum of the same S' within the bound of any
    order of summation."""
    qh = q.repeat_interleave(s_new.shape[1] // q.shape[1], dim=1).double()
    terms = qh[..., None] * s_new.double()  # (B, H, N, P)
    want = terms.sum(dim=2)
    bound = s_new.shape[2] * 2.0 ** -24 * terms.abs().sum(dim=2)
    err = (y.double() - want).abs()
    assert bool((err <= bound).all()), float((err / bound.clamp(min=1e-30)).max())


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_state_is_bit_equal_to_the_plain_step(cuda, name):
    args = _inputs(SHAPES[name], cuda)
    launches = mamba2_step.launches
    y, s_new, n_new = mamba2_step(*args)
    assert mamba2_step.launches == launches + 1
    y0, s0, n0 = _plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(s_new, s0), float((s_new - s0).abs().max())
    assert torch.equal(n_new, n0), float((n_new - n0).abs().max())
    _assert_y(y, args[0], s_new)
    _assert_y(y0, args[0], s0)


@pytest.mark.parametrize("name", ["nemotron", "zamba2", "ragged", "p_not_by_4"])
def test_in_place_equals_out_of_place(cuda, name):
    q, k, v, log_a, dt_, state, n_state = _inputs(SHAPES[name], cuda, seed=1)
    y0, s0, n0 = mamba2_step(q, k, v, log_a, dt_, state, n_state)
    s_ptr, n_ptr = state.data_ptr(), n_state.data_ptr()
    y, s, n = mamba2_step(q, k, v, log_a, dt_, state, n_state, out=(state, n_state))
    torch.cuda.synchronize()
    assert (s.data_ptr(), n.data_ptr()) == (s_ptr, n_ptr)
    assert torch.equal(y, y0) and torch.equal(s, s0) and torch.equal(n, n0)


def test_a_captured_step_replays_as_the_eager_one(cuda):
    """Three steps in place on one state, eagerly and replayed from a CUDA
    graph of one in-place step: the same states and outputs bit for bit,
    the launch counted once at the capture and not at the replays."""
    q, k, v, log_a, dt_, state, n_state = _inputs(SHAPES["nemotron"], cuda, seed=2)
    eager_s, eager_n = state.clone(), n_state.clone()
    eager_y = []
    for _ in range(3):
        y, _, _ = mamba2_step(q, k, v, log_a, dt_, eager_s, eager_n, out=(eager_s, eager_n))
        eager_y.append(y.clone())
    s, n = state.clone(), n_state.clone()
    mamba2_step(q, k, v, log_a, dt_, s.clone(), n.clone())  # warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    launches = mamba2_step.launches
    with torch.cuda.graph(graph):
        y, _, _ = mamba2_step(q, k, v, log_a, dt_, s, n, out=(s, n))
    assert mamba2_step.launches == launches + 1
    for i in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, eager_y[i]), i
    assert mamba2_step.launches == launches + 1
    assert torch.equal(s, eager_s) and torch.equal(n, eager_n)


def test_the_kernel_refuses_a_state_off_the_card_it_is_given(cuda):
    """Everything on one device: a CPU destination for a card's state
    raises before a launch."""
    q, k, v, log_a, dt_, state, n_state = _inputs(SHAPES["ragged"], cuda, seed=3)
    launches = mamba2_step.launches
    with pytest.raises(ValueError, match="one device"):
        mamba2_step(q, k, v, log_a, dt_, state, n_state, out=(state.cpu(), n_state.cpu()))
    assert mamba2_step.launches == launches
