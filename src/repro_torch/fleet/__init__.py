"""repro_torch.fleet — the fleet simulator for TOFEC experiment grids.

The port of the reference package's ``repro.fleet``. The paper's evaluation
story (Fig.1/7/8) is a sweep over (arrival rate × policy × seed); this
package evaluates such a grid in a handful of chunked device launches:

* :mod:`repro_torch.fleet.workloads` — the workload-generator family
  (Poisson, MMPP, diurnal, flash-crowd, piecewise replay, tenant mixes),
  host numpy streams draw for draw the reference's.
* :mod:`repro_torch.fleet.sweep` — :func:`repro_torch.core.fluid_scan.
  tofec_scan_core` over a stacked config axis with memory-bounded chunks
  and the reference's shape-bucket keys.
* :mod:`repro_torch.fleet.frontier` — reductions to throughput-delay
  frontiers, delay percentiles, capacity estimates, adaptation-convergence
  stats, and the ``BENCH_fleet.json`` artifact writer.
* :mod:`repro_torch.fleet.shard` — streaming per-chunk frontier reductions
  (``run(..., stream=...)``) and grid sharding across a device list
  (``mesh=``, :func:`shard_grid`).
"""

from repro_torch.fleet.frontier import (
    FrontierPoint,
    capacity_estimates,
    convergence_stats,
    frontier,
    frontier_points,
    headline_ratios,
    write_fleet_artifact,
)
from repro_torch.fleet.shard import (
    StreamedStats,
    StreamSpec,
    resolve_grid_mesh,
    shard_grid,
)
from repro_torch.fleet.sweep import (
    BIG,
    FleetSweep,
    PolicySpec,
    SweepCase,
    SweepResult,
    fixedk_tables,
    grid_cases,
    policy_tables,
    static_tables,
    tenant_cases,
)
from repro_torch.fleet.workloads import (
    DiurnalWorkload,
    FlashCrowdWorkload,
    MMPPWorkload,
    PiecewiseWorkload,
    PoissonWorkload,
    TenantMix,
    Workload,
)

__all__ = [
    "BIG",
    "Workload",
    "PoissonWorkload",
    "MMPPWorkload",
    "DiurnalWorkload",
    "FlashCrowdWorkload",
    "PiecewiseWorkload",
    "TenantMix",
    "FleetSweep",
    "SweepCase",
    "SweepResult",
    "PolicySpec",
    "grid_cases",
    "tenant_cases",
    "policy_tables",
    "static_tables",
    "fixedk_tables",
    "FrontierPoint",
    "frontier",
    "frontier_points",
    "capacity_estimates",
    "convergence_stats",
    "headline_ratios",
    "write_fleet_artifact",
    "StreamSpec",
    "StreamedStats",
    "resolve_grid_mesh",
    "shard_grid",
]
