"""repro_torch.sched — shared-pool multi-class scheduler simulation.

The port of the reference package's ``repro.sched``. §IV of the paper
analyses multiple (type, size) request classes contending for ONE pool of
L parallel connections. The fleet's ``tenant_cases`` path approximates that
with Poisson splitting — independent per-class fluid queues that each think
they own the pool — which erases cross-class interference. This package
simulates the shared pool jointly:

* :mod:`repro_torch.sched.scan` — ``multiclass_scan_core``: one loop over
  the merged arrival stream for a grid of rows, carrying per-class backlog
  and TOFEC state, with FIFO / strict-priority / weighted-fair admission as
  select logic on data.
* :mod:`repro_torch.sched.sweep` — ``SchedSweep``: (mix × discipline ×
  seed) grids through the scan with the fleet's bucket cache and chunked
  launches; grids mixing disciplines share one bucket.
* :mod:`repro_torch.sched.frontier` — per-class delay percentiles, the Jain
  fairness index, interference headlines and the ``BENCH_multiclass.json``
  artifact.

The event oracle is :func:`repro_torch.core.simulator.simulate_shared_pool`;
cross-validation lives in ``tests/test_torch_sched.py``.
"""

from repro_torch.sched.frontier import (
    MulticlassPoint,
    by_discipline,
    interference_summary,
    jain_index,
    multiclass_points,
    write_multiclass_artifact,
)
from repro_torch.sched.scan import (
    DISC_FIFO,
    DISC_NAMES,
    DISC_PRIORITY,
    DISC_WFQ,
    multiclass_scan_core,
)
from repro_torch.sched.sweep import (
    DisciplineSpec,
    SchedCase,
    SchedResult,
    SchedSweep,
    sched_cases,
)

__all__ = [
    "DISC_FIFO",
    "DISC_PRIORITY",
    "DISC_WFQ",
    "DISC_NAMES",
    "multiclass_scan_core",
    "DisciplineSpec",
    "SchedCase",
    "SchedResult",
    "SchedSweep",
    "sched_cases",
    "MulticlassPoint",
    "multiclass_points",
    "by_discipline",
    "interference_summary",
    "jain_index",
    "write_multiclass_artifact",
]
