"""Grid sharding and streaming frontier reductions for the chunked sweep
engines.

The port of the reference package's ``repro/fleet/shard.py``. Two
orthogonal capabilities, shared by :class:`repro_torch.fleet.FleetSweep`,
:class:`repro_torch.sched.SchedSweep` and :class:`repro_torch.taskq.TaskqSweep`
through their common :class:`repro_torch.fleet.sweep.ChunkedSweep` base:

**Grid sharding** (:func:`resolve_grid_mesh` + :func:`shard_grid`): each
chunked launch's grid rows are cut into equal slices across a 1-D device
mesh (:func:`repro_torch.launch.mesh.make_grid_mesh`) — per-case config
rows and streams go one slice to each device, while grid-shared broadcast
operands (the taskq trace pools) are copied once to each distinct device —
and the slices' outputs are concatenated on the mesh's first device in
slice order. Grid rows are independent and every reduction inside a launch
body is per row, so the sharded result is bit-exact against the
single-device path (``tests/test_torch_shard.py``). A mesh may repeat a
device (``["cuda:0", "cuda:0"]``, ``["cpu"] * 4``): its slices then run one
after another, which proves the cut on one card without claiming a speedup.

**Streaming frontier reductions** (:class:`StreamSpec` + :class:`StreamedStats`):
instead of materializing the whole (G, T) per-request output block and
reducing it afterwards, a streamed run folds every chunk's scan outputs into
fixed-size per-row frontier statistics on the device — the reductions in
:mod:`repro_torch.fleet.stats` — and drops the (chunk, T) block before the
next launch. Peak memory becomes O(chunk × T) per launch plus O(G) for the
carried statistics. The fold runs the *same* reduction the materialized
frontier uses, over blocks of the same row count, so the streamed
statistics are bit-exact equals of the materialized ones.

The telemetry side-channels ride the streamed path unchanged: per-case
:class:`repro_torch.obs.MetricsBuf` rows fold per chunk (cut → row-reduce →
merge) and per-case :class:`repro_torch.obs.TimelineBuf` timelines keep
their case axis (cut → concat), in the same chunk loop
(``ChunkedSweep._launch_chunks``) as the materialized path, so both carry
the same metrics and timelines bit for bit.

The launch loop folds a sharded launch's concatenated outputs exactly as
an unsharded one's, so the streamed and telemetry paths ride the mesh
unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.launch.mesh import Mesh, make_grid_mesh
from repro_torch.tree import tree_leaves, tree_map


def resolve_grid_mesh(mesh):
    """Normalize a sweep's ``mesh`` argument to a 1-D :class:`Mesh` (or None).

    Accepts ``None`` (the single-device path), an int device count (the
    first n cards, :func:`repro_torch.launch.mesh.make_grid_mesh`), a list
    of devices (repeats allowed), or an existing 1-D Mesh of any axis name.
    Raises ``ValueError`` for a mesh of more than one axis, for 0 devices and
    for more cards than there are.
    """
    if mesh is None:
        return None
    if isinstance(mesh, int):
        return make_grid_mesh(mesh)
    if isinstance(mesh, (list, tuple)):
        return make_grid_mesh(devices=mesh)
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"sweep meshes are 1-D (the grid axis); got axes {mesh.axis_names}"
        )
    if mesh.devices is None:
        raise ValueError("a sweep mesh needs devices; a production mesh is only a plan")
    return mesh


def _gather(parts: list, device):
    """Concatenate the slices' outputs along their leading (case) axis on
    ``device``: tensors, dicts of them and the telemetry buffers (dataclasses
    of them; their plain-int fields must agree)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], device) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _gather([getattr(p, f.name) for p in parts], device)
            for f in dataclasses.fields(first) if f.init})
    if any(p != first for p in parts):
        raise ValueError(f"slices disagree on {first!r}")
    return first


def shard_grid(fn, mesh: Mesh, in_axes: tuple):
    """Wrap a whole-chunk launch body to run sliced across ``mesh``.

    ``in_axes`` has one entry per positional argument of ``fn``: 0 for a
    per-case operand (a tensor or a dict of tensors whose leading axis is
    the grid), cut into ``mesh.size`` equal row slices, slice i going to
    device i; None for a grid-shared operand, passed whole (tensors in it
    copied once to each distinct device) — the reference's ``in_axes=None``
    convention. Each slice runs ``fn``; the outputs, telemetry buffers
    included, come back concatenated on the mesh's first device in slice
    order.
    """
    devices = list(mesh.devices)

    def to(tree, dev):
        return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)

    def sharded(*args):
        if len(args) != len(in_axes):
            raise ValueError(f"{len(args)} arguments for in_axes {in_axes}")
        rows = tree_leaves(next(a for a, ax in zip(args, in_axes) if ax == 0))[0].shape[0]
        if rows % len(devices):
            raise ValueError(f"{rows} grid rows do not cut into {len(devices)} equal slices")
        per = rows // len(devices)
        shared = {}
        outs = []
        for i, dev in enumerate(devices):
            if dev not in shared:
                shared[dev] = [to(a, dev) if ax is None else None for a, ax in zip(args, in_axes)]
            part = [to(tree_map(lambda x: x[i * per:(i + 1) * per], a), dev) if ax == 0
                    else shared[dev][j] for j, (a, ax) in enumerate(zip(args, in_axes))]
            with obs.span("sweep.shard", slice=i, device=str(dev), rows=per):
                outs.append(fn(*part))
        return _gather(outs, devices[0])

    return sharded


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Ask a sweep run to stream: fold each chunk into frontier statistics.

    The warmup cut must be fixed before the first chunk is folded, so it is
    part of the run request rather than a reduction-time argument; the
    frontier consumers validate that their ``warmup_frac`` lands on the same
    cut (:meth:`StreamedStats.require`).
    """

    warmup_frac: float = 0.05


class StreamedStats:
    """Running frontier-reduction state carried by a streamed sweep result.

    Holds the per-row statistics (name → (G,) numpy arrays) that the
    per-chunk folds accumulated, plus the warmup cut they were folded at.
    :mod:`repro_torch.fleet.frontier` consumes this in place of the (G, T)
    output block — same API surface, no materialized grid.
    """

    def __init__(self, warmup_frac: float, count: int, red: dict):
        self.warmup_frac = float(warmup_frac)
        self.count = int(count)
        # The streamed path's one device→host download of the folded stats.
        with obs.span("sweep.stream_finalize", stats=len(red)):
            self.red = {name: v.cpu().numpy() for name, v in red.items()}

    @property
    def warmup(self) -> int:
        return int(self.count * self.warmup_frac)

    def require(self, warmup_frac: float) -> dict[str, np.ndarray]:
        """The streamed statistics, checked against a requested warmup cut.

        Streaming fixes the cut at launch time; asking the frontier for a
        different one afterwards cannot be served from the carry.
        """
        if int(self.count * warmup_frac) != self.warmup:
            raise ValueError(
                f"result was streamed at warmup_frac={self.warmup_frac} "
                f"(cut {self.warmup}); re-run the sweep with "
                f"StreamSpec(warmup_frac={warmup_frac}) to reduce at a "
                "different cut"
            )
        return self.red


def resolve_stream(stream) -> StreamSpec | None:
    """Normalize a run's ``stream`` argument: None/False | True | StreamSpec."""
    if not stream:
        return None
    return stream if isinstance(stream, StreamSpec) else StreamSpec()
