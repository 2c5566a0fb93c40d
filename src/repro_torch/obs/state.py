"""Enablement switches for the telemetry layer.

:func:`enabled` drives the device-resident metrics and the host span tracer:
``REPRO_OBS=1`` in the environment, or :func:`set_enabled` for programmatic
control (tests).  The flag is read at *call* time, never baked into module
state, so flipping it mid-process works — engines that jit-cache on it put
the flag into their cache key, which keeps compile-count pins exact: a
constant flag yields exactly the same bucket counts as before this layer
existed.

:func:`tracing` drives the host span tracer alone: it is also true while a
``torch.profiler`` session runs anywhere in the process, so a profiled
stretch records the program's spans beside the profiler's events without
flipping any engine's ``collect`` (and with it no bucket key or output).
"""
from __future__ import annotations

import os

import torch.autograd.profiler as _profiler

_OVERRIDE: list = [None]


def set_enabled(value: bool | None) -> None:
    """Force telemetry on/off; ``None`` restores env (``REPRO_OBS``) control."""
    _OVERRIDE[0] = None if value is None else bool(value)


def enabled() -> bool:
    if _OVERRIDE[0] is not None:
        return _OVERRIDE[0]
    return os.environ.get("REPRO_OBS", "0") not in ("", "0")


def tracing() -> bool:
    """Whether the host span tracer records: :func:`enabled`, or a
    ``torch.profiler`` session running in any thread of the process.

    The profiler's own thread-local switch is false in every thread but the
    one that started it (the proxy's workers never see it), so this reads
    the process-wide flag the profiler sets on start and clears on stop."""
    return enabled() or _profiler._is_profiler_enabled
