"""A decode step's attention over the ring KV cache as one hand-written kernel.

:func:`decode_attention` attends one new query a batch row over a ring
cache of (B, Smax, Hkv, hd) keys and values whose slots carry absolute
positions (``slot_pos``). On CUDA tensors it launches
``csrc/decode_attention.cu`` (design and bound are described there), which
reads the cache where it lies, once; elsewhere (the CPU, ``meta``) it
runs :func:`decode_attention_plain`, the port's attention before the kernel
(float32 scores from an upcast K, two einsums), which the CPU tests and the
reference comparisons use and which the card tests hold the kernel to.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
import pathlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.obs import profile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: the score of a masked slot, the reference's fill value (the models' attention uses it too)
MASKED = -1e30
#: threads of a block and tiles in flight, as ``csrc/decode_attention.cu`` has them
THREADS, STAGES = 256, 3
#: shared memory a block may have on an H100
SMEM_MAX = 227 * 1024
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: decode_attention_launch(q, k, v, slot_pos, pos, out, scores, part, B, Smax,
#: Hkv, G, hd, window, inv_scale, softcap, inv_softcap, masked, dtype, gt, gp,
#: rs, ts, dp, chunk, n_split, smem_fused, smem_scores, smem_attend, stream)
_ARGTYPES = [_PTR] * 8 + [_INT] * 6 + [_FLOAT] * 4 + [_INT] * 11 + [_PTR]
#: dtype of q, the caches and the output -> the kernel's code for it
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()


def tanh_cap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """``cap · tanh(x / cap)``, or ``x`` where there is no cap."""
    return cap * torch.tanh(x / cap) if cap else x


def decode_attention_plain(q, cache_k, cache_v, slot_pos, pos, *, window=None, softcap=None):
    """The plain version: (B, H, hd) in q's dtype. Scores are float32 (q and
    the upcast K), scaled by 1/√hd, capped, masked to the slots with
    ``0 ≤ slot_pos ≤ pos`` (and ``> pos − window``), soft-maxed in float32;
    p is rounded to V's dtype for P·V."""
    B, H, hd = q.shape
    Hkv = cache_k.shape[2]
    qh = q.reshape(B, 1, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.to(torch.float32), cache_k.to(torch.float32))
    s = tanh_cap(s / math.sqrt(hd), softcap)
    mask = (slot_pos <= pos) & (slot_pos >= 0)
    if window is not None:
        mask &= slot_pos > pos - window
    s = torch.where(mask, s, MASKED)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cache_v.dtype), cache_v)
    return o.reshape(B, H, hd)


class Plan(NamedTuple):
    """How the kernel cuts one call (see ``csrc/decode_attention.cu``)."""

    gt: int  # query heads a thread takes: 1 where G <= 4, else 8
    gp: int  # G padded to a multiple of gt
    rs: int  # bytes of a tile row in shared memory
    ts: int  # slots a tile
    dp: int  # threads that share one slot's dot product
    chunk: int  # slots a block
    n_split: int  # blocks a row
    smem: tuple[int, int, int]  # shared memory of the fused, scores and attend passes


def _align4(n: int) -> int:
    return (n + 3) & ~3


@functools.cache
def plan(blocks: int, Smax: int, G: int, hd: int, itemsize: int, n_sm: int) -> Plan:
    """The kernel's cut of a call with ``blocks`` (batch row, KV head)
    pairs, Smax slots, G query heads a KV head of width hd, on a card of
    ``n_sm`` multiprocessors; raises ``ValueError`` where it has none.

    A row is split across blocks where the pairs alone fill less than half
    the card (measured on an H100: a Nemotron layer's 128 pairs run best
    whole, gemma2's 16 at four rows best in 16 chunks), or where one block
    could not hold a whole row's scores."""
    ve = 16 // itemsize  # elements in 16 bytes
    dv = hd // ve
    gt = 1 if G <= 4 else 8
    gp = -(-G // gt) * gt
    if dv * (gp // gt) > THREADS:
        raise ValueError(f"{G} query heads a KV head of width {hd} are more than one block's "
                         f"{THREADS} threads can sum")
    row = hd * itemsize
    ts = 64 if row <= 256 else 32
    dp = 1
    while dp * 2 <= min(dv, 32, THREADS // (ts // 2 * (gp // gt))):
        dp *= 2
    # the dp threads of a row read 16 * dp bytes: pad the row so that the
    # next row's start in the 128-byte bank cycle, and so its threads, follow
    rs = row + ((16 * dp - row) % 128 if dp < 8 else 0)
    base = STAGES * ts * rs + THREADS * ve * 4

    def smem(chunk):
        return (base + 4 * (_align4(chunk * gp) + gp * hd + chunk),
                base + 4 * (gp * hd + chunk), base + 4 * _align4(chunk * gp))

    want = 1 if 2 * blocks >= n_sm else min(-(-2 * n_sm // blocks), -(-Smax // ts))
    while True:
        chunk = Smax if want == 1 else -(-(-(-Smax // want)) // ts) * ts
        n_split = -(-Smax // chunk)
        need = smem(chunk)[0] if n_split == 1 else max(smem(chunk)[1:])
        if need <= SMEM_MAX:
            return Plan(gt, gp, rs, ts, dp, chunk, n_split, smem(chunk))
        if chunk <= ts:
            raise ValueError(f"a block would need {need} bytes of shared memory, above "
                             f"{SMEM_MAX}")
        want += 1


@functools.cache
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attention_counts(B: int, H: int, Hkv: int, Smax: int, hd: int,
                     itemsize: int) -> tuple[float, int]:
    """(operations, bytes) of one call: a multiply and an add for each q·k
    and p·v term; K and V read once, q read and the output written once,
    slot_pos and pos read once."""
    ops = 4.0 * B * H * Smax * hd
    nbytes = 2 * B * Smax * Hkv * hd * itemsize + 2 * B * H * hd * itemsize + 4 * Smax + 4
    return ops, nbytes


@functools.cache
def _launcher():
    """The kernel's C entry point; builds (at first use) and loads its library."""
    fn = build.load_library("decode_attention",
                            CSRC / "decode_attention.cu").decode_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, cache_k, cache_v, slot_pos, pos, out, window, cap) -> None:
    named = {"q": q, "cache_k": cache_k, "cache_v": cache_v, "slot_pos": slot_pos, "pos": pos}
    if out is not None:
        named["out"] = out
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if cache_k.dtype not in _DTYPES or {q.dtype, cache_v.dtype} != {cache_k.dtype}:
        raise TypeError(f"q, cache_k and cache_v must share one dtype of "
                        f"{sorted(map(str, _DTYPES))}, got {q.dtype}, {cache_k.dtype}, "
                        f"{cache_v.dtype}")
    if out is not None and out.dtype != q.dtype:
        raise TypeError(f"out must be {q.dtype}, got {out.dtype}")
    for name in ("slot_pos", "pos"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {named[name].dtype}")
    if cache_k.ndim != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(f"cache_k and cache_v must be one (B, Smax, Hkv, hd) shape, got "
                         f"{tuple(cache_k.shape)} and {tuple(cache_v.shape)}")
    B, Smax, Hkv, hd = cache_k.shape
    if q.ndim != 3 or q.shape[0] != B or q.shape[2] != hd:
        raise ValueError(f"q must be (B, H, hd) = ({B}, H, {hd}) for a cache of "
                         f"{tuple(cache_k.shape)}, got {tuple(q.shape)}")
    if Hkv == 0 or q.shape[1] == 0 or q.shape[1] % Hkv:
        raise ValueError(f"the {q.shape[1]} query heads must be a multiple of the cache's "
                         f"{Hkv} KV heads")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"the head width must be a multiple of 8 from 8 to 256, got {hd}")
    if Smax == 0 or tuple(slot_pos.shape) != (Smax,):
        raise ValueError(f"slot_pos must be ({Smax},) for {Smax} slots, got "
                         f"{tuple(slot_pos.shape)}")
    if pos.ndim != 0:
        raise ValueError(f"pos must be a 0-d tensor, got shape {tuple(pos.shape)}")
    if out is not None and out.shape != q.shape:
        raise ValueError(f"out must be {tuple(q.shape)}, got {tuple(out.shape)}")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device (pos too: read there, never on "
                         f"the host), got {sorted(map(str, devices))}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if window is not None and (isinstance(window, bool) or operator.index(window) < 1):
        raise ValueError(f"window must be None or a whole number of slots ≥ 1, got {window!r}")
    if cap is not None and not cap >= 0:
        raise ValueError(f"softcap must be None or ≥ 0, got {cap!r}")


def decode_attention(q, cache_k, cache_v, slot_pos, pos, *, window=None, softcap=None,
                     out=None):
    """One decode step's attention: (B, H, hd) in q's dtype.

    q:                (B, H, hd), the new token's queries, float32 or bfloat16.
    cache_k, cache_v: (B, Smax, Hkv, hd) in q's dtype, read in place; H is
                      a multiple of Hkv (G = H / Hkv query heads a KV head),
                      hd a multiple of 8 up to 256.
    slot_pos:         (Smax,) int32 absolute position of each slot (negative
                      for an empty one); pos: 0-d int32, the new token's.
    window, softcap:  attend only to slots with ``slot_pos > pos − window``;
                      cap the scaled scores at ``softcap · tanh(s / softcap)``.
    out:              ``None`` (a fresh tensor) or a (B, H, hd) destination.

    Every tensor contiguous and on one device, else a ``TypeError`` or
    ``ValueError`` before any launch. On a CUDA device: the kernel, on the
    current stream, with no host sync (the step stays capturable); its
    values are the plain version's rounding points in another order of the
    float32 sums. ``launches`` counts its launches; each reports
    :func:`attention_counts` to :func:`repro_torch.obs.profile_launch`. On
    any other device (the CPU; ``meta``, where the launch plan counts the
    work): the plain version.
    """
    _check(q, cache_k, cache_v, slot_pos, pos, out, window, softcap)
    device = cache_k.device
    if device.type != "cuda":
        o = decode_attention_plain(q, cache_k, cache_v, slot_pos, pos, window=window,
                                   softcap=softcap)
        return o if out is None else out.copy_(o)
    if q.data_ptr() % 16 or cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("the kernel reads q and the caches in 16-byte pieces: each must "
                         "start at a 16-byte aligned address")
    B, Smax, Hkv, hd = cache_k.shape
    H = q.shape[1]
    G = H // Hkv
    index = device.index if device.index is not None else torch.cuda.current_device()
    cut = plan(B * Hkv, Smax, G, hd, q.element_size(), _multiprocessors(index))
    if out is None:
        out = torch.empty_like(q)
    if cut.n_split > 1:
        scores = torch.empty((B, H, Smax), dtype=torch.float32, device=device)
        part = torch.empty((B, H, cut.n_split, hd), dtype=torch.float32, device=device)
        scratch = scores.data_ptr(), part.data_ptr()
    else:
        scratch = 0, 0
    one = np.float32(1.0)
    inv_scale = float(one / np.float32(math.sqrt(hd)))
    cap = float(np.float32(softcap)) if softcap else 0.0
    inv_cap = float(one / np.float32(softcap)) if softcap else 0.0
    with torch.cuda.device(device):
        rc = _launcher()(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                         slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), *scratch, B, Smax,
                         Hkv, G, hd, operator.index(window or 0), inv_scale, cap, inv_cap, MASKED,
                         _DTYPES[q.dtype], cut.gt, cut.gp, cut.rs, cut.ts, cut.dp, cut.chunk,
                         cut.n_split, *cut.smem, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        decode_attention.launches += 1
    profile.add_counts(*attention_counts(B, H, Hkv, Smax, hd, q.element_size()))
    return out


decode_attention.launches = 0
