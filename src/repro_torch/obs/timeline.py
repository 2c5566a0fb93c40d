"""Time-resolved telemetry: fixed-capacity timelines on the device.

The port of the reference package's ``repro/obs/timeline.py``.
:class:`TimelineBuf` is the windowed/ring twin of
:class:`repro_torch.obs.metrics.MetricsBuf`: float32 per-slot series and
int32 per-slot histogram *deltas* as tensors, updated by plain tensor
operations with no host sync. Two modes share one type:

* **windowed** (the sweep engines): :func:`sweep_timeline` folds a scan's
  (G, T) per-request outputs into S slots of ``window`` arrivals — arrival
  rate, backlog, mean pick (n, k), served count, and a fixed-bucket delay
  histogram delta per window. The window is ``timeline_window(T_bucket)``,
  derived from the pow2 time bucket; the port's streams are only ``count``
  arrivals wide, so ``horizon`` (the bucket's T) sets the slots and the
  arrivals past ``count`` are empty slots, as the reference's padded,
  masked steps are.
* **ring** (the serving loop): :meth:`TimelineBuf.append` writes one slot
  per round at ``pos % capacity``, overwriting the oldest round once the
  ring wraps; :meth:`TimelineBuf.snapshot` restores oldest-first order.

Delay histograms use fixed log-spaced buckets (:data:`DELAY_BINS` bins,
:data:`DELAY_SUB` per octave from 2**:data:`DELAY_MIN_EXP` seconds, ~9%
width), so windowed percentiles are recoverable from the deltas at bucket
resolution (:func:`hist_percentile` / :func:`rolling_percentile`).

Chunk folds differ from MetricsBuf deliberately: timelines stay PER CASE,
so :meth:`reduce_rows` only cuts the tail padding and chunks concatenate
(:meth:`concat`) along the case axis. Every per-slot value is computed by
elementwise operations (the window sums as a pairwise tree of adds), so a
case's slots never depend on how many cases share its launch: streamed and
materialized timelines are bit for bit equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.obs.metrics import as_device

#: Slot budget for sweep timelines: a pow2 time bucket T yields
#: T / timeline_window(T) <= TIMELINE_SLOTS windows.
TIMELINE_SLOTS = 64

#: Fixed log-spaced delay buckets: DELAY_SUB buckets per octave starting at
#: 2**DELAY_MIN_EXP seconds; the first/last buckets absorb the clipped
#: tails. 96 bins cover ~15.6 ms .. ~59 s at ~9% resolution.
DELAY_BINS = 96
DELAY_SUB = 8
DELAY_MIN_EXP = -6

#: Lower edges of buckets 1 .. DELAY_BINS - 1 as float32 bit patterns: the
#: least float32 v that the reference's ``floor(log2(max(v, 2**-6)) * 8)``
#: (XLA's float32 log2 on the CPU) puts in each bucket. Each lies within a
#: few ulps of 2**((i - 48) / 8); comparing against them gives the
#: reference's buckets exactly on every device, where a log2 would differ
#: from XLA's by an ulp next to an edge. Pinned against the reference in
#: tests/test_torch_obs.py.
_EDGE_BITS = (
    0x3c8b95be, 0x3c9837ee, 0x3ca5fed5, 0x3cb504f2, 0x3cc56727, 0x3cd744fa, 0x3ceac0c5,
    0x3cfffffe, 0x3d0b95c0, 0x3d1837ee, 0x3d25fed5, 0x3d3504f2, 0x3d456727, 0x3d5744fa,
    0x3d6ac0c5, 0x3d7ffffe, 0x3d8b95c2, 0x3d9837f1, 0x3da5fed5, 0x3db504f2, 0x3dc5672a,
    0x3dd744fd, 0x3deac0c5, 0x3dfffffe, 0x3e0b95c1, 0x3e1837f0, 0x3e25fed6, 0x3e3504f3,
    0x3e456729, 0x3e5744fd, 0x3e6ac0c5, 0x3e7fffff, 0x3e8b95c2, 0x3e9837f0, 0x3ea5fed7,
    0x3eb504f3, 0x3ec5672a, 0x3ed744fd, 0x3eeac0c7, 0x3f000000, 0x3f0b95c2, 0x3f1837f0,
    0x3f25fed7, 0x3f3504f4, 0x3f45672a, 0x3f5744fd, 0x3f6ac0c7, 0x3f800000, 0x3f8b95c2,
    0x3f9837f1, 0x3fa5fed7, 0x3fb504f4, 0x3fc5672a, 0x3fd744fd, 0x3feac0c7, 0x40000000,
    0x400b95c2, 0x401837f1, 0x4025fed7, 0x403504f3, 0x4045672a, 0x405744fd, 0x406ac0c8,
    0x40800000, 0x408b95c1, 0x409837f0, 0x40a5fed6, 0x40b504f3, 0x40c56729, 0x40d744fd,
    0x40eac0c6, 0x40ffffff, 0x410b95c2, 0x411837f1, 0x4125fed8, 0x413504f2, 0x4145672a,
    0x415744fd, 0x416ac0c8, 0x417fffff, 0x418b95c2, 0x419837ef, 0x41a5fed5, 0x41b504f2,
    0x41c5672a, 0x41d744fa, 0x41eac0c5, 0x41ffffff, 0x420b95c2, 0x421837ef, 0x4225fed5,
    0x423504f2, 0x4245672a, 0x425744fa, 0x426ac0c7,
)
#: device -> the edges as a float32 tensor there (uploaded once, without a sync)
_EDGES: dict[torch.device, torch.Tensor] = {}


def timeline_window(t_bucket: int) -> int:
    """Window size (arrivals per slot) for a pow2 time bucket.

    Derived deterministically from the bucket, so appending it to a sweep's
    bucket key is explicit without ever creating a new bucket."""
    return max(int(t_bucket) // TIMELINE_SLOTS, 1)


def _edges(device: torch.device) -> torch.Tensor:
    edges = _EDGES.get(device)
    if edges is None:
        host = torch.tensor(_EDGE_BITS, dtype=torch.int64).to(torch.int32).view(torch.float32)
        if device.type == "cuda":  # a pinned, asynchronous upload: no host sync
            edges = host.pin_memory().to(device, non_blocking=True)
        else:
            edges = host.to(device)
        _EDGES[device] = edges
    return edges


def delay_bucket(value) -> torch.Tensor:
    """Delay (seconds) -> int32 bucket index under the fixed log-spaced
    buckets: ``clip(floor(log2(max(v, 2**-6)) * 8) + 48, 0, 95)`` as the
    reference computes it in float32, by comparison with the buckets'
    float32 lower edges (:data:`_EDGE_BITS`). A non-finite delay lands where
    the reference's float32 → int32 conversion puts it: ±inf in bucket 0,
    NaN in bucket 48."""
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    v = v.to(torch.float32)
    idx = torch.bucketize(v, _edges(v.device), out_int32=True, right=True)
    idx = torch.where(torch.isinf(v), 0, idx)
    return torch.where(torch.isnan(v), -DELAY_MIN_EXP * DELAY_SUB, idx)


def bucket_edges() -> np.ndarray:
    """(DELAY_BINS,) upper edges in seconds; bucket i spans (E[i-1], E[i]]."""
    i = np.arange(DELAY_BINS, dtype=np.float64)
    return 2.0 ** (DELAY_MIN_EXP + (i + 1) / DELAY_SUB)


def hist_percentile(hist, p: float) -> np.ndarray:
    """Recover a percentile from bucket counts (host side).

    ``hist``: (..., DELAY_BINS) counts. Returns the upper edge of the bucket
    holding the p-quantile observation (<= ~9% conservative). An all-zero
    row (a window that saw no observations) is explicitly NaN — never a
    clamped bucket edge — so downstream consumers (:func:`rolling_percentile`
    series, the SLO burn rate, the dashboards' gap-aware sparklines) can
    tell "no data" from "fast"."""
    h = np.asarray(hist, np.float64)
    tot = h.sum(axis=-1)
    cum = h.cumsum(axis=-1)
    target = p * tot
    idx = np.minimum((cum < target[..., None]).sum(axis=-1), DELAY_BINS - 1)
    out = bucket_edges()[idx]
    return np.where(tot > 0, out, np.nan)


def rolling_percentile(hist_rows, p: float, window: int) -> np.ndarray:
    """Percentile series over a trailing window of histogram delta rows.

    ``hist_rows``: (S, DELAY_BINS) per-slot deltas; row i's value is the
    p-quantile of slots max(0, i-window+1)..i combined. Windows whose
    combined rows are all zero report NaN (inherited from
    :func:`hist_percentile`)."""
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    h = np.asarray(hist_rows, np.float64)
    c = h.cumsum(axis=0)
    lo = np.concatenate([np.zeros_like(c[:window]), c[:-window]], axis=0) \
        if window < len(c) else np.zeros_like(c)
    return hist_percentile(c - lo, p)


def _map(d: dict, fn) -> dict:
    return {name: fn(v) for name, v in d.items()}


@dataclasses.dataclass(frozen=True)
class TimelineBuf:
    """Per-slot series + histogram deltas as tensors.

    pos:    () int32 slots appended (ring mode; ``capacity`` in windowed
            mode). Gains a leading case axis in a sweep and under :meth:`concat`.
    series: name -> (S,) float32 per-slot values
    hists:  name -> (S, B) int32 per-slot histogram deltas
    ``capacity`` (S) and ``window`` (samples per slot; 1 = per-round ring)
    are plain ints."""

    pos: torch.Tensor
    series: dict
    hists: dict
    capacity: int
    window: int

    @classmethod
    def zeros(cls, capacity: int, series=(), hists=None, window: int = 1, *,
              device=None) -> "TimelineBuf":
        """An empty ring of ``capacity`` slots on ``device`` (default: the card)."""
        dev = resolve_device(device)
        return cls(
            pos=torch.zeros((), dtype=torch.int32, device=dev),
            series={n: torch.zeros(int(capacity), dtype=torch.float32, device=dev)
                    for n in series},
            hists={n: torch.zeros((int(capacity), int(b)), dtype=torch.int32, device=dev)
                   for n, b in dict(hists or {}).items()},
            capacity=int(capacity),
            window=int(window),
        )

    # ---- updates ------------------------------------------------------------
    def append(self, values: dict, hist_obs: dict | None = None) -> "TimelineBuf":
        """Write one slot at ``pos % capacity`` (ring semantics).

        ``values``: name -> scalar (a number or a 0-d tensor) for the series
        slots. ``hist_obs``: name -> (bucket_idx, weight) vectors scattered
        into that slot's delta row (pass a 0/1 weight mask to drop padded
        entries)."""
        dev = self.pos.device
        i = torch.remainder(self.pos, self.capacity).to(torch.int64).reshape(1)
        series = dict(self.series)
        for name, v in values.items():
            series[name] = series[name].index_copy(
                0, i, as_device(v, torch.float32, dev).reshape(1))
        hists = dict(self.hists)
        for name, (idx, w) in (hist_obs or {}).items():
            bins = hists[name].shape[-1]
            idx = torch.clamp(as_device(idx, torch.int64, dev).reshape(-1), 0, bins - 1)
            w = as_device(w, torch.int32, dev).expand(idx.shape)
            row = torch.zeros(bins, dtype=torch.int32, device=dev).scatter_add(0, idx, w)
            hists[name] = hists[name].index_copy(0, i, row[None])
        return dataclasses.replace(self, pos=self.pos + 1, series=series, hists=hists)

    # ---- folds --------------------------------------------------------------
    def reduce_rows(self, rows: int | None = None) -> "TimelineBuf":
        """Cut the tail padding a chunk launch adds by repeating its last
        real row. Unlike MetricsBuf this does NOT reduce across cases —
        timelines stay per case; chunks then :meth:`concat`."""

        def cut(a):
            return a[:rows] if rows is not None else a

        return dataclasses.replace(self, pos=cut(self.pos), series=_map(self.series, cut),
                                   hists=_map(self.hists, cut))

    def take(self, i: int) -> "TimelineBuf":
        """Case ``i`` of a per-case timeline, as a one-case buffer."""

        def row(a):
            return a[i]

        return dataclasses.replace(self, pos=row(self.pos), series=_map(self.series, row),
                                   hists=_map(self.hists, row))

    def concat(self, other: "TimelineBuf") -> "TimelineBuf":
        """Stack two per-case timelines along the leading case axis."""
        if (self.capacity, self.window) != (other.capacity, other.window):
            raise ValueError(
                f"cannot concat timelines with different slotting: "
                f"{(self.capacity, self.window)} vs {(other.capacity, other.window)}")
        return dataclasses.replace(
            self,
            pos=torch.cat([torch.atleast_1d(self.pos), torch.atleast_1d(other.pos)]),
            series={n: torch.cat([v, other.series[n]]) for n, v in self.series.items()},
            hists={n: torch.cat([v, other.hists[n]]) for n, v in self.hists.items()},
        )

    # ---- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """The one host sync: tensors -> numpy, ring order restored.

        Ring mode (scalar ``pos``): slots come back oldest-first and cut to
        the appended count. Windowed/stacked mode (per-case ``pos``): the
        per-case arrays pass through as-is."""
        pos = self.pos.cpu().numpy()
        series = {n: v.cpu().numpy() for n, v in self.series.items()}
        hists = {n: v.cpu().numpy() for n, v in self.hists.items()}
        if pos.ndim == 0:
            m = int(pos)
            if m <= self.capacity:
                order = np.arange(m)
            else:  # wrapped: the oldest slot sits at pos % capacity
                order = (np.arange(self.capacity) + m) % self.capacity
            series = {n: v[order] for n, v in series.items()}
            hists = {n: v[order] for n, v in hists.items()}
            slots = len(order)
        else:
            slots = self.capacity
        return {
            "window": self.window,
            "capacity": self.capacity,
            "slots": slots,
            "pos": pos.tolist(),
            "series": series,
            "hists": hists,
        }


def _window_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """(..., S * window) -> (..., S) window sums as a pairwise tree of
    elementwise adds (each result independent of the leading shape)."""
    x = x.reshape(*x.shape[:-1], -1, window)
    width = 1 << (window - 1).bit_length()
    if width != window:  # zero lanes keep every sum exact
        x = F.pad(x, (0, width - window))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def sweep_timeline(out: dict, interarrivals, *, window: int, valid=None, backlog=None,
                   horizon: int | None = None) -> TimelineBuf:
    """Windowed timeline of a scan's outputs, one row per case.

    ``out`` holds (G, T) (or one case's (T,)) ``total``, ``n`` and ``k``;
    ``interarrivals`` the matching gaps. Per window of ``window`` arrivals:
    ``lam`` (valid arrivals / elapsed seconds), ``served`` (valid count),
    mean ``pick_n``/``pick_k``, the optional ``backlog`` series mean, and a
    ``delay`` histogram delta of the total delays under the fixed log
    buckets. ``horizon`` (default T) is the time axis the slots cover: the
    reference's pow2 bucket, so S = horizon / window slots, and the slots
    past T are empty. ``valid`` is a (G, T) or (T,) real-arrival mask."""
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    total = torch.as_tensor(out["total"])
    single = total.ndim == 1
    T = total.shape[-1]
    H = T if horizon is None else int(horizon)
    if H % window or H < T:
        raise ValueError(f"horizon {H} not divisible by window {window} or shorter than "
                         f"the {T} arrivals")
    S = H // window

    def rows(x):
        x = torch.as_tensor(x, device=total.device)
        return x.reshape(1, -1) if single else x

    total = rows(total)
    G = total.shape[0]
    mask = (torch.ones_like(total, dtype=torch.bool) if valid is None
            else rows(valid).expand(G, T))
    w = mask.to(torch.float32)

    def wsum(x):  # (G, T) -> (G, S), arrivals past T weigh nothing
        return _window_sum(F.pad(x, (0, H - T)), window)

    cnt = wsum(w)
    denom = torch.clamp_min(cnt, 1.0)

    def wmean(x):
        return wsum(rows(x).to(torch.float32) * w) / denom

    span = wsum(rows(interarrivals).to(torch.float32) * w)
    lam = torch.where(span > 0, cnt / torch.clamp_min(span, 1e-12), 0.0)
    series = {"lam": lam, "served": cnt, "pick_n": wmean(out["n"]), "pick_k": wmean(out["k"])}
    if backlog is not None:
        series["backlog"] = wmean(backlog)
    slot = torch.arange(T, device=total.device) // window
    flat = (slot * DELAY_BINS + delay_bucket(total)).to(torch.int64)
    hist = torch.zeros((G, S * DELAY_BINS), dtype=torch.int32, device=total.device)
    hist = hist.scatter_add(1, flat, mask.to(torch.int32)).reshape(G, S, DELAY_BINS)
    pos = torch.full((G,), S, dtype=torch.int32, device=total.device)
    buf = TimelineBuf(pos=pos, series=series, hists={"delay": hist}, capacity=S, window=window)
    return buf.take(0) if single else buf
