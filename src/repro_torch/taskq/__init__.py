"""repro_torch.taskq — the exact trace-driven task-level queue engine.

The port of the reference package's ``repro.taskq``. The fleet
(:mod:`repro_torch.fleet`) and scheduler (:mod:`repro_torch.sched`) sweeps
run the paper's *fluid* §IV-A approximation — fast, but per-request delay
is modeled, not simulated. This package runs the **exact** §II-A
task-level system on the device: per-request delay is the k-th order
statistic of n correlated chunk-task delays racing over a shared L-thread
pool with preemptive cancellation of stragglers, exactly as the event
oracle computes it — and matching that oracle draw for draw when both read
the same pre-sampled trace pools.

* :mod:`repro_torch.taskq.engine` — ``taskq_scan_core``: the exact
  per-request recurrence (FIFO assignment with own-completion feedback,
  k-of-n completion, cancellation replay) as one loop over arrivals for a
  grid of rows.
* :mod:`repro_torch.taskq.policies` — policies as data: threshold tables
  (TOFEC / static / fixed-k, shared with the fleet) plus §V-A's
  ``greedy_select``, which needs the idle-thread count only the exact
  engine observes.
* :mod:`repro_torch.taskq.sweep` — ``TaskqSweep``: (λ × policy × seed)
  grids in chunked launches with the fleet's bucket cache, trace pools
  shared grid-wide; ``TaskqSweep.replay_flight``, which re-runs one cell
  with the flight recorder on and returns its ``repro_torch.obs.FlightLog``;
  the ``BENCH_taskq.json`` artifact writer.
"""

from repro_torch.taskq.engine import taskq_scan, taskq_scan_core
from repro_torch.taskq.policies import (
    POL_GREEDY,
    POL_TABLE,
    EncodedPolicy,
    encode_policy,
    greedy_select,
)
from repro_torch.taskq.sweep import (
    TaskqResult,
    TaskqSweep,
    taskq_streams,
    write_taskq_artifact,
)

__all__ = [
    "taskq_scan",
    "taskq_scan_core",
    "POL_TABLE",
    "POL_GREEDY",
    "EncodedPolicy",
    "encode_policy",
    "greedy_select",
    "TaskqSweep",
    "TaskqResult",
    "taskq_streams",
    "write_taskq_artifact",
]
