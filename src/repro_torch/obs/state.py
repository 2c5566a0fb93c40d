"""Enablement switch for the telemetry layer.

One flag drives both the device-resident metrics and the host span tracer:
``REPRO_OBS=1`` in the environment, or :func:`set_enabled` for programmatic
control (tests).  The flag is read at *call* time, never baked into module
state, so flipping it mid-process works — engines that jit-cache on it put
the flag into their cache key, which keeps compile-count pins exact: a
constant flag yields exactly the same bucket counts as before this layer
existed.
"""
from __future__ import annotations

import os

_OVERRIDE: list = [None]


def set_enabled(value: bool | None) -> None:
    """Force telemetry on/off; ``None`` restores env (``REPRO_OBS``) control."""
    _OVERRIDE[0] = None if value is None else bool(value)


def enabled() -> bool:
    if _OVERRIDE[0] is not None:
        return _OVERRIDE[0]
    return os.environ.get("REPRO_OBS", "0") not in ("", "0")
