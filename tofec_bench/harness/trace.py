"""The traced run's reading of ``torch.profiler``.

The traced stretch is one ``bench.traced`` host range; inside it the drivers
mark what the host is doing with ``bench.*`` ranges (:func:`label`), so an
idle gap on the device is named by the host's range and the innermost
PyTorch operation the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import heapq
import time

import torch

#: device kernels of K1 (``kernels/gf2mm/csrc/gf2_rs_bytes.cu``)
K1_KERNELS = ("k1_regs_kernel", "k1_general_kernel")
TOP = 10


def label(on: bool, name: str):
    """A ``bench.<name>`` host range in a traced run, nothing otherwise."""
    return torch.profiler.record_function(f"bench.{name}") if on else contextlib.nullcontext()


class Tracer:
    """Profiles the stretch between :meth:`start` and :meth:`stop`."""

    def __init__(self, warm: bool = True):
        """With ``warm``, start and stop the profiler once now: its first
        start in a process takes seconds (the tracing library's set-up), so
        a caller that traces from the window's start pays it at set-up. The
        library then stays loaded and slows every later kernel launch, so a
        caller that reads host-bound phases outside the traced stretch
        passes ``warm=False`` and starts the profiler where it traces."""
        self.prof = None
        self._range = None
        if warm:
            self._profile().start()
            torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
            _sync()
            self._last.stop()

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._last = profile(activities=acts)
        return self._last

    def start(self) -> None:
        _sync()
        self.prof = self._profile()
        self.prof.start()
        self._range = torch.profiler.record_function("bench.traced")
        self._range.__enter__()
        self._enter_ns = time.time_ns()

    def stop(self) -> dict:
        _sync()
        self._range.__exit__(None, None, None)
        self.prof.stop()
        out = summarize(self.prof.profiler.kineto_results.events(), self._enter_ns)
        self.prof = None
        return out


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, enter_ns: int | None = None) -> dict:
    """``busy_s`` (union of device intervals inside the traced range),
    ``window_s`` (the range's length), the device operations with most
    time, the longest idle gaps named by the host's work, and K1's calls
    and device seconds."""
    from torch.autograd import DeviceType

    dev, host, window = [], [], None
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            # the profiler mirrors host ranges on the device's timeline as
            # annotations; they are not device work
            if not ev.name().startswith("bench."):
                dev.append((ev.name(), s, e))
        else:
            if ev.name() == "bench.traced":
                window = (s, e)
            host.append((ev.name(), s, e))
    if window is None:
        raise RuntimeError("the profile holds no bench.traced range")
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    busy = _merge([(s, e) for _, s, e in dev])
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict[str, float] = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
    longest = heapq.nlargest(TOP, [g for g in gaps if g[0] > 0])
    k1 = sorted((s, e) for n, s, e in dev if any(k in n for k in K1_KERNELS))
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_events": len(dev),
        "device_ops": [[n[:160], t] for n, t in heapq.nlargest(TOP, by_name.items(),
                                                               key=lambda kv: kv[1])],
        "idle_gaps": [[_host_at(host, (a + b) // 2), g / 1e9] for g, a, b in longest],
        #: the same gaps' middles, on the profiler's clock (wall-clock ns)
        "idle_gap_mid_ns": [(a + b) // 2 for _, a, b in longest],
        #: the host's bench.* ranges: name -> [(start ns, end ns)], in order
        "ranges": _ranges(host),
        #: the profiler's clock minus the host's wall clock (time.time_ns),
        #: from the traced range's start
        "clock_offset_ns": 0 if enter_ns is None else w0 - enter_ns,
        "k1_calls": len(k1),
        "k1_s": sum(e - s for s, e in k1) / 1e9,
        #: K1's kernels: (start ns, end ns), in order
        "k1_kernels": k1,
    }


def _ranges(host) -> dict:
    out: dict[str, list] = {}
    for n, s, e in sorted(host, key=lambda h: h[1]):
        if n.startswith("bench."):
            out.setdefault(n, []).append((s, e))
    return out


def _host_at(host, t: int) -> str:
    """``<bench range> / <innermost op>`` of the host at time ``t``."""
    ranges = [(e - s, n) for n, s, e in host if s <= t < e and n != "bench.traced"]
    benches = sorted(r for r in ranges if r[1].startswith("bench."))
    ops = sorted(r for r in ranges if not r[1].startswith("bench."))
    where = benches[0][1] if benches else "bench.traced"
    return f"{where} / {ops[0][1]}" if ops else f"{where} / no PyTorch operation"
