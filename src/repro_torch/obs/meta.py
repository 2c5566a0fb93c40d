"""Uniform run metadata stamped into every BENCH_*.json artifact.

The port of the reference package's ``repro/obs/meta.py``: the same fields,
with the device count from ``torch.cuda.device_count()`` and the card's name
added, so a number recorded on one card is never read as another's.
"""
from __future__ import annotations

import os
import subprocess

# Version of the *meta block* shared by all artifacts (each artifact keeps
# its own "schema" path string for payload layout).
SCHEMA_VERSION = 2


def git_rev() -> str | None:
    """Short rev of the repo containing this file; None outside a checkout."""
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True,
            text=True,
            timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    rev = proc.stdout.strip()
    return rev if proc.returncode == 0 and rev else None


def run_meta(mesh_shape=None) -> dict:
    """The meta block: ``host_devices`` counts CUDA cards (0 without one)
    and ``device_name`` names card 0 (None without one)."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "schema_version": SCHEMA_VERSION,
        "git_rev": git_rev(),
        "host_cores": os.cpu_count() or 1,
        "host_devices": count,
        "device_name": torch.cuda.get_device_name(0) if count else None,
        "mesh_shape": list(mesh_shape) if mesh_shape else [],
    }
