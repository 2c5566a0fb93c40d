"""Per-launch profiling: counted work vs measured wall time, on H100 peaks.

The port of the reference package's ``repro/obs/profile.py``.
:func:`count_work` runs one callable once to count its work — matmul FLOPs
from :class:`torch.utils.flop_counter.FlopCounterMode` (with a formula for
``aten.bmm.dtype``, the MoE experts' float32-output product), bytes from a
dispatch mode that adds up every ATen operation's input and output tensors
(views and allocations move nothing and are skipped), plus the analytic
counts a hand-written kernel's wrapper reports through :func:`add_counts`
(a ``ctypes`` launch is invisible to both modes). It runs on ``meta``
tensors too, which is how the launch planner (:mod:`repro_torch.launch`)
counts a full-size cell without a card. :func:`profile_launch` counts one
callable at one argument shape so, then
makes ``warmup`` calls and takes the best of ``iters`` calls, each closed
by ``torch.cuda.synchronize()`` on the card. From these it derives the
roofline view: achieved GFLOP/s and GB/s, arithmetic intensity, the
compute-vs-memory bound side and the fraction of the peak achieved. Peaks
default to the NVIDIA H100 SXM data sheet (:data:`PEAK_FLOPS`,
:data:`HBM_BW`); override them per call for other work (an int8 kernel's
operations against the int8 peak). On the CPU the fractions are indicative
only; the wall time and the counts are the portable numbers.

Each profile registers a labeled :class:`repro_torch.obs.compile.CompileStats`
(held strongly here, so the weak registry keeps it), which makes profiled
functions first-class citizens of :func:`repro_torch.obs.compile_snapshot`.
:func:`profile_snapshot` returns the measured records merged with those
counts, and :func:`format_profile` renders the terminal table the dashboard
embeds.
"""
from __future__ import annotations

import contextvars
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.obs import trace as _trace
from repro_torch.obs.compile import CompileStats

#: NVIDIA H100 SXM data-sheet peaks (dense): bfloat16 FLOP/s and HBM bytes/s.
PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12

#: Strong refs so the weak compile registry keeps profiled labels alive.
_PROFILES: dict[str, dict] = {}
_STATS: dict[str, CompileStats] = {}

#: [flops, bytes] of the counting call in progress (None outside one).
_TALLY: contextvars.ContextVar = contextvars.ContextVar("repro_torch_profile_tally",
                                                        default=None)

#: ATen operations that allocate without moving data.
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like}


def add_counts(flops: float, nbytes: float) -> None:
    """Add an opaque launch's analytic counts to the :func:`profile_launch`
    count in progress, if any (a no-op otherwise)."""
    tally = _TALLY.get()
    if tally is not None:
        tally[0] += float(flops)
        tally[1] += float(nbytes)


def _tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Sums the input and output bytes of every ATen operation run under it."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket not in _NO_TRAFFIC:
            self.nbytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2·B·M·N·K for ``aten.bmm`` in both overloads: the default formula
    takes ``aten.bmm.dtype``'s ``out_dtype`` for its ``out_shape`` and
    raises."""
    b, m, k = a_shape
    return 2 * b * m * b_shape[2] * k


def count_work(fn, *args, **kwargs) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of ``fn(*args, **kwargs)``: see the module
    docstring."""
    tally = [0.0, 0.0]
    token = _TALLY.set(tally)
    try:
        with (FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flop})
              as flop_mode, _ByteCounter() as byte_mode):
            fn(*args, **kwargs)
    finally:
        _TALLY.reset(token)
    return (float(flop_mode.get_total_flops()) + tally[0],
            float(byte_mode.nbytes) + tally[1])


def profile_launch(label: str, fn, *args, warmup: int = 1, iters: int = 3,
                   peak_flops: float | None = None, peak_bw: float | None = None,
                   **kwargs) -> dict:
    """Profile one callable at one argument shape; returns the record.

    The first call counts the work (see the module docstring), then
    ``warmup`` discarded calls, then the best of ``iters`` synchronized
    calls is the wall time."""
    peak_flops = PEAK_FLOPS if peak_flops is None else float(peak_flops)
    peak_bw = HBM_BW if peak_bw is None else float(peak_bw)

    def sync():  # the card's queue, whatever the callable launched there
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    with _trace.get_tracer().span("obs.profile_count", label=label):
        flops, nbytes = count_work(fn, *args, **kwargs)
    sync()

    for _ in range(warmup):
        fn(*args, **kwargs)
        sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        sync()
        best = min(best, time.perf_counter() - t0)

    t_compute = flops / peak_flops
    t_memory = nbytes / peak_bw
    rec = {
        "label": label,
        "flops": flops,
        "bytes": nbytes,
        "wall_s": best,
        "gflops": flops / best / 1e9 if best > 0 else 0.0,
        "gbps": nbytes / best / 1e9 if best > 0 else 0.0,
        "intensity": flops / nbytes if nbytes else 0.0,
        "bound": "compute" if t_compute >= t_memory else "memory",
        # Efficiency vs the binding roofline term at the configured peaks.
        "frac_peak": (max(t_compute, t_memory) / best) if best > 0 else 0.0,
    }
    _PROFILES[label] = rec
    stats = _STATS.get(label)
    if stats is None:
        stats = _STATS[label] = CompileStats(label=f"profile.{label}")
    stats.traces += 1
    stats.launches += warmup + iters
    return rec


def profile_snapshot() -> dict:
    """label -> measured record + the registry's counts."""
    out = {}
    for label, rec in _PROFILES.items():
        stats = _STATS.get(label)
        out[label] = dict(rec)
        if stats is not None:
            out[label]["traces"] = stats.traces
            out[label]["launches"] = stats.launches
    return out


def reset_profiles() -> None:
    _PROFILES.clear()
    _STATS.clear()


def _fmt_qty(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if v >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def format_profile(snap: dict | None = None) -> str:
    """ASCII roofline/efficiency table over :func:`profile_snapshot`."""
    snap = profile_snapshot() if snap is None else snap
    rows = [("fn", "flops", "bytes", "wall_ms", "gflop/s", "gb/s",
             "bound", "peak%", "launches")]
    for label, r in sorted(snap.items()):
        rows.append((
            label, _fmt_qty(r["flops"]), _fmt_qty(r["bytes"]),
            f"{r['wall_s'] * 1e3:.3f}", f"{r['gflops']:.2f}",
            f"{r['gbps']:.2f}", r["bound"], f"{r['frac_peak'] * 100:.2f}",
            str(r.get("launches", "")),
        ))
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    return "\n".join(
        "  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
        for row in rows
    )
