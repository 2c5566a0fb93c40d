"""A decode step's absorbed latent attention (MLA) as one hand-written kernel.

:func:`latent_attention` attends one query a batch row and head, the
concatenated [q_lat, q_pe], over the row's latent cache [c_kv, k_pe] up to
slot ``pos``, and returns P·c_kv. On CUDA tensors it launches
``csrc/latent_attention.cu`` (design and bound are described there), which
reads the bfloat16 latent where it lies, once, on the tensor cores;
elsewhere (the CPU, ``meta``) it runs :func:`latent_attention_plain`, the
body of :func:`repro_torch.models.mla.absorbed_attention` before the kernel
(float32 scores of every slot, the scale, the mask, a softmax, a second
product), which the CPU tests and the reference comparisons use and which
the card tests hold the kernel to.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.decode_attention import MASKED
from repro_torch.kernels.products import bmm_f32
from repro_torch.obs import profile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: the kernel's widths: the latent [c_kv, k_pe] and its value part c_kv
WIDTH, VALUE_WIDTH = 576, 512
#: heads a block and slots a tile, as ``csrc/latent_attention.cu`` has them
HEADS_A_BLOCK, TILE = 64, 32
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: latent_attention_launch(q, latent, pos, out, part, B, H, Smax, n_split, scale, stream)
_ARGTYPES = [_PTR] * 5 + [_INT] * 4 + [_FLOAT, _PTR]
_COUNT_LOCK = threading.Lock()


def latent_attention_plain(q, latent, pos, scale, *, value_width=VALUE_WIDTH):
    """The plain version: (B, H, value_width) in the latent's dtype. Scores
    are float32 sums of q against every slot, scaled, masked to the slots
    up to ``pos``, soft-maxed in float32; p is rounded to the latent's
    dtype for P·c_kv, summed in float32 and rounded once."""
    valid = torch.arange(latent.shape[1], device=latent.device) <= pos
    s = bmm_f32(q, latent.transpose(1, 2))
    s = s.mul_(scale).masked_fill_(~valid, MASKED)
    p = torch.softmax(s, dim=-1)
    return bmm_f32(p.to(latent.dtype), latent[..., :value_width]).to(latent.dtype)


def split_ranges(pos: int, n_split: int) -> list[tuple[int, int]]:
    """The slots [lo, hi) each of the ``n_split`` blocks of a row takes at
    position ``pos``, as the kernel computes them on the device: the tiles
    that cover 0..pos in runs of whole tiles, the last runs empty where
    there are fewer tiles than splits."""
    tiles = pos // TILE + 1
    per = -(-tiles // n_split)
    out = []
    for sp in range(n_split):
        lo = min(sp * per * TILE, pos + 1)
        out.append((lo, min(lo + per * TILE, pos + 1)))
    return out


@functools.cache
def plan(B: int, H: int, Smax: int, n_sm: int) -> int:
    """Blocks a row's slots are split across (n_split) for B rows of H
    heads and up to Smax slots on a card of ``n_sm`` multiprocessors: as
    many as keep the B · ⌈H / 64⌉ · n_split blocks (one a multiprocessor,
    for their shared memory) within one wave, at least 1, and no more than
    the tiles of Smax slots. The kernel cuts the tiles up to ``pos``, read
    on the device, into that many runs."""
    blocks = B * -(-H // HEADS_A_BLOCK)
    return max(1, min(n_sm // blocks, -(-Smax // TILE)))


@functools.cache
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def latent_counts(B: int, H: int, slots: int) -> tuple[float, int]:
    """(operations, bytes) of one call over ``slots`` cached slots: a
    multiply and an add for each q·latent and p·c_kv term; the latent read
    once, q read and the output written once, pos read."""
    ops = 2.0 * B * H * slots * (WIDTH + VALUE_WIDTH)
    nbytes = 2 * B * slots * WIDTH + 2 * B * H * (WIDTH + VALUE_WIDTH) + 4
    return ops, nbytes


def float64_reference(q, latent, pos: int, scale: float):
    """What the kernel is held to at slot ``pos`` (a host int): the float64
    P·c_kv of the plain version's own rounded p, and a bound for each
    output on the kernel's distance from it,

        2 · (the plain version's largest distance)   its own last rounding
      + 2⁻⁸ · Σ p|v|          p rounded against another max (each ≤ 2⁻⁹ of p)
      + 2 · e_x · Σ p|v|      the scores' float32 order: e_x = scale · width ·
                              2⁻²⁴ · max Σ|q||k| bounds an exponent's move
      + Smax · 2⁻²⁴ · Σ p|v|  any order of a float32 sum.

    Returns (o64, the plain version's output, bound, its largest distance)."""
    _, Smax, width = latent.shape
    pos_t = torch.tensor(pos, dtype=torch.int32, device=latent.device)
    plain = latent_attention_plain(q, latent, pos_t, scale)
    s = bmm_f32(q, latent.transpose(1, 2)).mul_(scale)
    s = s.masked_fill_(torch.arange(Smax, device=latent.device) > pos, MASKED)
    p = torch.softmax(s, dim=-1).to(latent.dtype).double()
    del s
    v = latent[..., :VALUE_WIDTH].double()
    o64 = torch.bmm(p, v)
    pv_abs = torch.bmm(p, v.abs())
    del p, v
    qk = torch.bmm(q.float().abs(), latent.float().abs().transpose(1, 2))[..., :pos + 1]
    e_x = scale * width * 2.0 ** -24 * qk.amax(dim=-1, keepdim=True).double()
    del qk
    plain_err = float((plain.double() - o64).abs().max())
    bound = 2 * plain_err + (2.0 ** -8 + 2 * e_x + Smax * 2.0 ** -24) * pv_abs
    return o64, plain, bound, plain_err


@functools.cache
def _launcher():
    """The kernel's C entry point; builds (at first use) and loads its library."""
    fn = build.load_library("latent_attention",
                            CSRC / "latent_attention.cu").latent_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, latent, pos, out, value_width) -> None:
    named = {"q": q, "latent": latent, "pos": pos}
    if out is not None:
        named["out"] = out
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if q.dtype != latent.dtype or not latent.is_floating_point():
        raise TypeError(f"q and latent must share one floating dtype, got {q.dtype} and "
                        f"{latent.dtype}")
    if out is not None and out.dtype != latent.dtype:
        raise TypeError(f"out must be {latent.dtype}, got {out.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    if latent.ndim != 3 or latent.shape[1] == 0:
        raise ValueError(f"latent must be (B, Smax, width) with Smax ≥ 1, got "
                         f"{tuple(latent.shape)}")
    B, _, width = latent.shape
    if q.ndim != 3 or q.shape[0] != B or q.shape[2] != width:
        raise ValueError(f"q must be (B, H, width) = ({B}, H, {width}) for a latent of "
                         f"{tuple(latent.shape)}, got {tuple(q.shape)}")
    if not 0 < value_width <= width:
        raise ValueError(f"value_width must be in 1..{width}, got {value_width}")
    if pos.ndim != 0:
        raise ValueError(f"pos must be a 0-d tensor, got shape {tuple(pos.shape)}")
    if out is not None and tuple(out.shape) != (B, q.shape[1], value_width):
        raise ValueError(f"out must be {(B, q.shape[1], value_width)}, got {tuple(out.shape)}")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device (pos too: read there, never on "
                         f"the host), got {sorted(map(str, devices))}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_kernel_takes(q, latent, value_width) -> None:
    """Raise ``ValueError`` unless the kernel takes these (checked inputs):
    a bfloat16 latent of width 576 with 512 value channels, q and the
    latent at 16-byte aligned addresses."""
    width = latent.shape[-1]
    if latent.dtype != torch.bfloat16 or (width, value_width) != (WIDTH, VALUE_WIDTH):
        raise ValueError(f"the kernel takes a bfloat16 latent of width {WIDTH} with "
                         f"{VALUE_WIDTH} value channels, got {latent.dtype}, {width}, "
                         f"{value_width}")
    if q.data_ptr() % 16 or latent.data_ptr() % 16:
        raise ValueError("the kernel reads q and the latent in 16-byte pieces: each must "
                         "start at a 16-byte aligned address")


def latent_attention(q, latent, pos, scale, *, value_width=VALUE_WIDTH, out=None):
    """One decode step's absorbed attention: (B, H, value_width) in the
    latent's dtype.

    q:           (B, H, width), the new token's [q_lat, q_pe] a head.
    latent:      (B, Smax, width), one layer's cache [c_kv, k_pe], read in
                 place; its first ``value_width`` channels are c_kv.
    pos:         0-d int32, the new token's slot: slots 0..pos are attended.
    scale:       the softmax scale, a float (used as float32).
    out:         ``None`` (a fresh tensor) or a (B, H, value_width) destination.

    Every tensor contiguous and on one device, else a ``TypeError`` or
    ``ValueError`` before any launch. On a CUDA device: the kernel, which
    takes bfloat16 at width 576 and value width 512 only (DeepSeek-V3's
    latent), on the current stream, with no host sync (the step stays
    capturable); its values are the plain version's rounding points but
    for p, rounded against a running max. ``launches`` counts its calls;
    each reports :func:`latent_counts` (over Smax slots) to
    :func:`repro_torch.obs.profile_launch`. On any other device (the CPU;
    ``meta``): the plain version.
    """
    _check(q, latent, pos, out, value_width)
    device = latent.device
    if device.type != "cuda":
        o = latent_attention_plain(q, latent, pos, scale, value_width=value_width)
        return o if out is None else out.copy_(o)
    check_kernel_takes(q, latent, value_width)
    B, Smax, _ = latent.shape
    H = q.shape[1]
    index = device.index if device.index is not None else torch.cuda.current_device()
    n_split = plan(B, H, Smax, _multiprocessors(index))
    if out is None:
        out = torch.empty((B, H, VALUE_WIDTH), dtype=latent.dtype, device=device)
    part = (torch.empty((B, H, n_split, VALUE_WIDTH + 2), dtype=torch.float32, device=device)
            if n_split > 1 else None)
    with torch.cuda.device(device):
        rc = _launcher()(q.data_ptr(), latent.data_ptr(), pos.data_ptr(), out.data_ptr(),
                         0 if part is None else part.data_ptr(), B, H, Smax, n_split,
                         float(np.float32(scale)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"latent_attention kernel launch failed: "
                           + (f"cudaError {rc}" if rc > 0 else "no tensor-map encoder in libcuda"
                              if rc == -1 else f"tensor map refused, CUresult {-1000 - rc}"))
    with _COUNT_LOCK:
        latent_attention.launches += 1
    profile.add_counts(*latent_counts(B, H, Smax))
    return out


latent_attention.launches = 0
