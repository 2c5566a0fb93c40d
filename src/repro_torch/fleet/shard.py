"""Streaming frontier reductions for the chunked sweep engine.

The single-device part of the reference package's ``repro/fleet/shard.py``:

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

**Grid sharding** across several cards (``shard_grid`` in the reference) is
not ported yet (``ROADMAP.md`` item 12): :func:`resolve_grid_mesh` accepts
only the single-device path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs


def resolve_grid_mesh(mesh):
    """Normalize a sweep's ``mesh`` argument: ``None`` or 1 is the
    single-device path (returns None). A mesh of several devices raises:
    sharding the grid axis across cards is ``ROADMAP.md`` item 12."""
    if mesh is None or (isinstance(mesh, int) and mesh == 1):
        return None
    raise NotImplementedError(
        f"sweep mesh {mesh!r}: sharding the grid over several cards is not ported yet "
        "(ROADMAP.md item 12, fleet/shard.py); pass mesh=None for one card"
    )


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
