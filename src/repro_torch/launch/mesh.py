"""Meshes: the production plan's H100 meshes and the sweeps' device lists.

Single-pod: (16, 16) → ("data", "model") — 256 H100s.
Multi-pod:  (2, 16, 16) → ("pod", "data", "model") — 512 H100s.

The port of the reference package's ``repro/launch/mesh.py``, whose shapes
it keeps so the two plans compare leaf for leaf. A :class:`Mesh` is a plain
frozen record: the production meshes are plans (each position stands for
one H100 in nodes of 8 along the last axis; no device is touched), and a
grid mesh is a list of devices the sweeps cut their grid across
(:mod:`repro_torch.fleet.shard`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` and ``axis_names``, one per mesh axis; ``devices`` the flat
    tuple of ``torch.device`` in row-major order, or None for a plan."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    devices: tuple | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ in rank")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of {self.size}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The cards this process sees, as a 1-D ``'data'`` mesh."""
    n = torch.cuda.device_count()
    return Mesh((n,), ("data",), tuple(torch.device("cuda", i) for i in range(n)))


def make_grid_mesh(n: int | None = None, devices=None) -> Mesh:
    """The first ``n`` devices (default: all) as a 1-D ``'grid'`` mesh.

    The devices are the cards this process sees, or ``devices`` when given:
    any list of devices, repeats allowed (``["cuda:0", "cuda:0"]`` or
    ``["cpu"] * 4``), so one card or the CPU can stand in for a mesh and
    the sharded sweeps be held bit for bit against the single-device ones.
    A CUDA device is named with its index (``"cuda"`` is the current card)
    and raises without a card, as every entry point does.
    """
    pool = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if devices is None else [resolve_device(d) for d in devices])
    n = len(pool) if n is None else int(n)
    if not 1 <= n <= len(pool):
        raise ValueError(f"need 1 <= n <= {len(pool)} devices, got {n}")
    return Mesh((n,), ("grid",), tuple(pool[:n]))
