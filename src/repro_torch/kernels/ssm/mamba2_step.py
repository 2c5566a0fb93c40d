"""Mamba2's decode recurrence as one hand-written kernel.

:func:`mamba2_step` is one decode step of Mamba2's linear recurrence (no
normalizer) with B and C read by group. It launches
``csrc/mamba2_step.cu`` (design and bound are described there), which
streams the float32 state once and may update it in place, and takes CUDA
tensors only: the plain version, run elsewhere, is
:func:`repro_torch.models.ssm.linear_recurrence_step` on B and C repeated
per head (:func:`repro_torch.models.ssm.mamba2_recurrence_step` picks
between the two).
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading

import torch

from repro_torch.kernels import build
from repro_torch.obs import profile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: mamba2_step_launch(q, k, v, q_bs, k_bs, v_bs, a, gi, s, n, s_out, n_out,
#: y, B, H, G, N, P, dtype, stream)
_ARGTYPES = [_PTR] * 3 + [_LL] * 3 + [_PTR] * 7 + [_INT] * 6 + [_PTR]
#: dtype of q, k and v -> the kernel's code for it
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()


@functools.cache
def _launcher():
    """The kernel's C entry point; builds (at first use) and loads its library."""
    fn = build.load_library("mamba2_step", CSRC / "mamba2_step.cu").mamba2_step_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def step_counts(B: int, H: int, G: int, N: int, P: int, itemsize: int) -> tuple[float, int]:
    """(operations, bytes) of one step on a (B, H, N, P) state: four
    operations an element of S' and two of y, three an element of n'; S and
    n read once and written once, q, k (by group), v, the gates and y once."""
    ops = 6.0 * B * H * N * P + 3.0 * B * H * N
    nbytes = 8 * B * H * (N * P + N) + itemsize * B * (2 * G * N + H * P) + 4 * B * H * (2 + P)
    return ops, nbytes


def _disjoint_or_same(dst: torch.Tensor, src: torch.Tensor) -> bool:
    a0, b0 = dst.data_ptr(), src.data_ptr()
    a1, b1 = a0 + dst.numel() * dst.element_size(), b0 + src.numel() * src.element_size()
    return a0 == b0 or a1 <= b0 or b1 <= a0


def _check(q, k, v, log_a, gate, state, n_state, out) -> None:
    named = {"q": q, "k": k, "v": v, "log_a": log_a, "gate": gate, "state": state,
             "n_state": n_state}
    if out is not None:
        if not isinstance(out, (tuple, list)) or len(out) != 2:
            raise TypeError("out must be a (state, n_state) pair of tensors")
        named.update(state_out=out[0], n_out=out[1])
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    for name in ("log_a", "gate", "state", "n_state", "state_out", "n_out"):
        if name in named and named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {named[name].dtype}")
    if k.dtype not in _DTYPES or q.dtype != k.dtype or v.dtype != k.dtype:
        raise TypeError(f"q, k and v must share one dtype of {sorted(map(str, _DTYPES))}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if state.ndim != 4:
        raise ValueError(f"state must be (B, H, N, P), got shape {tuple(state.shape)}")
    B, H, N, P = state.shape
    G = k.shape[1] if k.ndim == 3 else 0
    want = {"q": (B, G, N), "k": (B, G, N), "v": (B, H, P), "log_a": (B, H), "gate": (B, H),
            "n_state": (B, H, N), "state_out": (B, H, N, P), "n_out": (B, H, N)}
    for name, shape in want.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape} for a state of "
                             f"{tuple(state.shape)}, got {tuple(named[name].shape)}")
    if G == 0 or H % G:
        raise ValueError(f"the {G} groups of q and k must divide the {H} heads")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device, got {sorted(map(str, devices))}")
    for name in ("log_a", "gate", "state", "n_state", "state_out", "n_out"):
        if name in named and not named[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k", "v"):
        if B and not named[name][0].is_contiguous():
            raise ValueError(f"each batch row of {name} must be contiguous")
    if out is not None:
        for dst in out:
            for src in (state, n_state):
                if not _disjoint_or_same(dst, src):
                    raise ValueError("an out tensor partly overlaps the state: it must be the "
                                     "source itself or lie apart from it")


def mamba2_step(q, k, v, log_a, gate, state, n_state, *, out=None):
    """One exact Mamba2 decode step; returns (y (B, H, P) float32, S', n').

    q, k:        (B, G, N): C and B in the model's dtype (float32 or
                 bfloat16); head h reads group h // (H / G).
    v:           (B, H, P), x in the same dtype.
    log_a, gate: (B, H) float32: the log decay (≤ 0) and dt.
    state:       (B, H, N, P) float32; n_state: (B, H, N) float32.
    out:         ``None`` (fresh tensors), or (S', n') destinations of the
                 state's shapes, each either the source itself (an update
                 in place) or apart from it.

    S' = a·S + gi·k vᵀ and n' = a·n + gi·k, a = exp(log_a), rounded as
    :func:`~repro_torch.models.ssm.linear_recurrence_step` rounds them, bit
    for bit; y = qᵀ S' in float32. Batch rows of q, k and v must each be
    contiguous (slices of one projection are fine), every other tensor
    contiguous, all on one CUDA device; anything else raises before a
    launch. The kernel runs on the current stream. ``launches`` counts its
    launches; each reports :func:`step_counts` to
    :func:`repro_torch.obs.profile_launch`.
    """
    _check(q, k, v, log_a, gate, state, n_state, out)
    if state.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {state.device}; the plain "
                         "version is models.ssm.linear_recurrence_step")
    B, H, N, P = state.shape
    G = k.shape[1]
    a = torch.exp(log_a)  # the plain version's decay, bit for bit
    s_out, n_out = out if out is not None else (torch.empty_like(state),
                                                torch.empty_like(n_state))
    y = torch.empty((B, H, P), dtype=torch.float32, device=state.device)
    with torch.cuda.device(state.device):
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), k.stride(0),
                         v.stride(0), a.data_ptr(), gate.data_ptr(), state.data_ptr(),
                         n_state.data_ptr(), s_out.data_ptr(), n_out.data_ptr(), y.data_ptr(),
                         B, H, G, N, P, _DTYPES[k.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_step kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        mamba2_step.launches += 1
    profile.add_counts(*step_counts(B, H, G, N, P, k.element_size()))
    return y, s_out, n_out


mamba2_step.launches = 0
