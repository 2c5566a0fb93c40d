"""Device-resident metrics.

The port of the reference package's ``repro/obs/metrics.py``.
:class:`MetricsBuf` is a frozen dataclass of int32 counters, fixed-bucket
int32 histograms and float32 high-water marks, as tensors on the device the
work runs on. Every update is functional (it returns a new buffer) and is
made of plain tensor operations — a scalar add, a ``scatter_add``, a
``maximum`` — so collecting costs a few small kernels and no host sync:
nothing reads a value back, and a histogram never sizes itself from its
data (``torch.bincount`` on a card would).

A buffer may carry a leading batch axis on every leaf (one row per grid
case, as the reference's vmapped buffers do): :meth:`MetricsBuf.observe`
and :meth:`MetricsBuf.high` then act per row. Collection sites fold per
chunk exactly like the streamed frontier reductions: the engine returns a
per-case buffer, the launcher cuts the tail padding, row-reduces on the
device and union-merges across chunks. The only host sync is
:meth:`MetricsBuf.snapshot`, on demand.
"""
from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch

from repro_torch import resolve_device

# Shared bucket count for picked-(n, k) histograms across the sweep engines.
# Codes in the repro use n well below 32; the last bucket absorbs the clip.
PICK_BINS = 33


def as_device(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` as a ``dtype`` tensor on ``device`` with no host sync for a
    Python number (a fill, not a copy) or a tensor already there. A host
    array is copied (tests; the collection sites pass numbers or device
    tensors)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    if isinstance(value, (numbers.Number, np.number)):
        return torch.full((), value, dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(value), device=device).to(dtype)


def _union(a: dict, b: dict, op) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = op(out[k], v) if k in out else v
    return out


@dataclasses.dataclass(frozen=True)
class MetricsBuf:
    """Counters + fixed-bucket histograms + high-water marks as tensors.

    counters: name -> () int32 running sum
    hists:    name -> (B,) int32; a value v lands in bucket clip(int(v), 0, B-1)
    highs:    name -> () float32 running max (non-negative quantities; zeros init)

    Each leaf may have a leading batch axis (one row per case).
    """

    counters: dict
    hists: dict
    highs: dict

    @classmethod
    def zeros(cls, counters=(), hists=None, highs=(), *, batch: tuple = (),
              device=None) -> "MetricsBuf":
        """A zeroed buffer on ``device`` (default: the card); ``batch`` is
        the leading shape of every leaf (``()`` for one buffer)."""
        dev = resolve_device(device)
        batch = tuple(batch)
        return cls(
            counters={n: torch.zeros(batch, dtype=torch.int32, device=dev) for n in counters},
            hists={n: torch.zeros((*batch, int(b)), dtype=torch.int32, device=dev)
                   for n, b in dict(hists or {}).items()},
            highs={n: torch.zeros(batch, dtype=torch.float32, device=dev) for n in highs},
        )

    # ---- updates ------------------------------------------------------------
    def count(self, name: str, by=1) -> "MetricsBuf":
        c = dict(self.counters)
        old = c[name]
        c[name] = old + (by.to(torch.int32) if isinstance(by, torch.Tensor) else int(by))
        return dataclasses.replace(self, counters=c)

    def observe(self, name: str, value, weight=None) -> "MetricsBuf":
        """Bucket scalar or vector values; repeated indices scatter-add.
        ``weight`` (same shape, int) scales each observation — pass a 0/1
        validity mask to drop padded entries without a dynamic shape. On a
        batched buffer ``value`` is (rows, ...) and lands in its row."""
        h = dict(self.hists)
        old = h[name]
        bins = old.shape[-1]
        v = (value.to(old.device) if isinstance(value, torch.Tensor)
             else as_device(value, torch.float32, old.device))
        idx = torch.clamp(v.to(torch.int32), 0, bins - 1).to(torch.int64)
        idx = idx.reshape(*old.shape[:-1], -1)
        if weight is None:
            w = torch.ones_like(idx, dtype=torch.int32)
        else:
            w = as_device(weight, torch.int32, old.device).expand_as(v).reshape(idx.shape)
        h[name] = old.scatter_add(old.ndim - 1, idx, w)
        return dataclasses.replace(self, hists=h)

    def high(self, name: str, value) -> "MetricsBuf":
        hi = dict(self.highs)
        old = hi[name]
        v = as_device(value, torch.float32, old.device)
        if v.ndim > old.ndim:
            v = v.reshape(*old.shape, -1).amax(-1)
        hi[name] = torch.maximum(old, v)
        return dataclasses.replace(self, highs=hi)

    # ---- folds --------------------------------------------------------------
    def reduce_rows(self, rows: int | None = None) -> "MetricsBuf":
        """Fold a batched buf (leading batch axis on every leaf) to one
        buffer: sum counters/hists, max highs. ``rows`` drops the tail
        padding a chunk launch adds by repeating its last real row."""

        def cut(a):
            return a[:rows] if rows is not None else a

        return MetricsBuf(
            counters={n: cut(v).sum(0, dtype=torch.int32) for n, v in self.counters.items()},
            hists={n: cut(v).sum(0, dtype=torch.int32) for n, v in self.hists.items()},
            highs={n: cut(v).amax(0) for n, v in self.highs.items()},
        )

    def merge(self, other: "MetricsBuf") -> "MetricsBuf":
        """Union-merge: add counters/hists, max highs; disjoint names pass through."""
        return MetricsBuf(
            counters=_union(self.counters, other.counters, lambda a, b: a + b),
            hists=_union(self.hists, other.hists, lambda a, b: a + b),
            highs=_union(self.highs, other.highs, torch.maximum),
        )

    # ---- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """The one host sync: device tensors -> plain python dicts."""
        return {
            "counters": {n: int(v) for n, v in self.counters.items()},
            "hists": {n: v.cpu().numpy().astype(int).tolist() for n, v in self.hists.items()},
            "highs": {n: float(v) for n, v in self.highs.items()},
        }

    def to_prometheus(self, prefix: str = "repro", labels: dict | None = None) -> str:
        return to_prometheus(self.snapshot(), prefix=prefix, labels=labels)


def _escape_label_value(v) -> str:
    """Prometheus exposition-format label-value escaping (backslash first)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: dict | None, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in sorted((labels or {}).items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus(snap: dict, prefix: str = "repro", labels: dict | None = None) -> str:
    """Prometheus-style text exposition of a :meth:`MetricsBuf.snapshot`.

    Each metric family carries its ``# HELP`` / ``# TYPE`` header lines.
    ``labels`` (e.g. ``{"engine": "fleet"}``) are attached to every sample
    with exposition-format value escaping. Histogram buckets are unit-width
    (`le="i"` covers values <= i); the last bucket is `+Inf` (clipped
    tail), so cumulative counts are monotone.
    """
    lines = []
    base = _label_str(labels)
    for n, v in sorted(snap.get("counters", {}).items()):
        name = f"{prefix}_{n}_total"
        lines.append(f"# HELP {name} Running count of '{n}'.")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name}{base} {v}")
    for n, buckets in sorted(snap.get("hists", {}).items()):
        name = f"{prefix}_{n}"
        lines.append(f"# HELP {name} Fixed-bucket histogram of '{n}'.")
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for i, c in enumerate(buckets):
            cum += int(c)
            le = "+Inf" if i == len(buckets) - 1 else str(i)
            le_labels = _label_str(labels, 'le="%s"' % le)
            lines.append(f"{name}_bucket{le_labels} {cum}")
        lines.append(f"{name}_count{base} {cum}")
    for n, v in sorted(snap.get("highs", {}).items()):
        name = f"{prefix}_{n}"
        lines.append(f"# HELP {name} High-water mark of '{n}'.")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{base} {v}")
    return "\n".join(lines) + "\n"


def sweep_point_metrics(out: dict, prefix: str, valid=None) -> MetricsBuf:
    """Per-case metrics of a scan's (G, T) outputs — requests served, tasks
    issued, picked-(n, k) histograms and the worst per-request delay — as a
    buffer with one row per case; the launcher folds it per chunk.

    ``valid`` is a (G, T) or (T,) boolean mask of real arrivals (the
    ``obs_count`` rows, see :func:`valid_mask`); entries it drops are not
    counted."""
    n, k, total = out["n"], out["k"], out["total"]
    G = n.shape[0]
    if valid is None:
        valid = torch.ones_like(n, dtype=torch.bool)
    valid = valid.expand_as(n)
    w = valid.to(torch.int32)
    buf = MetricsBuf.zeros(
        counters=(f"{prefix}_requests", f"{prefix}_tasks"),
        hists={f"{prefix}_pick_n": PICK_BINS, f"{prefix}_pick_k": PICK_BINS},
        highs=(f"{prefix}_delay_hi",),
        batch=(G,), device=n.device,
    )
    buf = buf.count(f"{prefix}_requests", w.sum(1))
    buf = buf.count(f"{prefix}_tasks", (n.to(torch.int32) * w).sum(1))
    buf = buf.observe(f"{prefix}_pick_n", n, weight=w)
    buf = buf.observe(f"{prefix}_pick_k", k, weight=w)
    buf = buf.high(f"{prefix}_delay_hi", torch.where(valid, total, 0.0))
    return buf


def valid_mask(cfg: dict, horizon: int):
    """(G, horizon) mask of real arrivals from the per-case ``obs_count``
    row the sweeps add when collection is on (None when absent)."""
    cnt = cfg.get("obs_count")
    if cnt is None:
        return None
    return torch.arange(horizon, device=cnt.device)[None, :] < cnt[:, None]
