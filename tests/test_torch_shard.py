"""Grid sharding in the port (``repro_torch.fleet.shard``) on the CPU,
mirroring the mesh half of ``tests/test_shard.py``.

A mesh here is a list that repeats the CPU (``["cpu"] * 2``, ``["cpu"] * 4``),
as the reference's tests use virtual host devices: every launch's grid rows
are cut into equal slices, each slice runs the launch body, and the outputs
are concatenated. The sharded fleet, sched and taskq sweeps must equal the
unsharded ones bit for bit (raw outputs, streamed frontier statistics,
telemetry timelines and metrics), with the bucket uses pinned per mesh shape
through ``stats.by_mesh``. Slices below and above the 64-row reduction block
(``repro_torch.fleet.stats.ROW_BLOCK``) are both covered.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import PAPER_READ_3MB, RequestClass
from repro_torch.core.traces import TraceStore
from repro_torch.fleet import (
    FleetSweep,
    PolicySpec,
    TenantMix,
    convergence_stats,
    frontier_points,
    grid_cases,
    resolve_grid_mesh,
    shard_grid,
)
from repro_torch.fleet.stats import ROW_BLOCK
from repro_torch.launch.mesh import Mesh, make_grid_mesh, make_production_mesh
from repro_torch.sched import DisciplineSpec, SchedSweep, multiclass_points, sched_cases
from repro_torch.taskq import TaskqSweep

R3 = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
R1 = RequestClass("read1mb", 1.0, PAPER_READ_3MB, k_max=4, r_max=2.0, n_max=8)
L = 16
CPU = "cpu"


def cpus(d: int) -> list[str]:
    return [CPU] * d


def fleet_grid(n_lam: int = 4) -> list:
    """Mixed-policy fleet grid: TOFEC adaptive + static + fixed-k points."""
    lams = np.linspace(5.0, 60.0, n_lam)
    pols = [PolicySpec.tofec(), PolicySpec.static(6, 3), PolicySpec.fixedk(4)]
    return grid_cases(lams, pols, [0], R3, L)


def sched_grid() -> list:
    """Mixed-discipline joint grid over a 2-class tenant mix."""
    mixes = [TenantMix(lam, (R3, R1), (0.6, 0.4)) for lam in (15.0, 35.0)]
    discs = [DisciplineSpec.fifo(), DisciplineSpec.priority(0, 1),
             DisciplineSpec.wfq(2.0, 1.0)]
    return sched_cases(mixes, discs, [0], L=L)


def taskq_grid() -> list:
    """Threshold (tofec) + greedy exact-engine grid."""
    lams = np.linspace(10.0, 50.0, 3)
    pols = [PolicySpec.tofec(), PolicySpec.greedy()]
    return grid_cases(lams, pols, [0], R3, L)


@pytest.fixture(scope="module")
def pools():
    sizes = tuple(R3.file_mb / k for k in range(1, R3.k_max + 1))
    store = TraceStore.generate(PAPER_READ_3MB, sizes, threads=R3.n_max,
                                samples=1024, correlation=0.12, seed=3)
    return store.device_pools(n_max=R3.n_max, device=CPU)


def assert_points_equal(a, b):
    """Bit-exact frontier/multiclass point equality, NaN-aware."""
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert json.dumps(pa.to_dict()) == json.dumps(pb.to_dict())


def assert_out_equal(res, ref, names):
    for name in names:
        torch.testing.assert_close(res.out[name], ref.out[name], rtol=0, atol=0)


def test_resolve_grid_mesh_validates():
    mesh = resolve_grid_mesh(cpus(1))
    assert mesh.axis_names == ("grid",) and mesh.size == 1 and mesh.shape == (1,)
    assert resolve_grid_mesh(None) is None
    assert resolve_grid_mesh(mesh) is mesh
    assert make_grid_mesh(2, devices=cpus(3)).devices == (torch.device(CPU),) * 2
    with pytest.raises(ValueError):
        resolve_grid_mesh(torch.cuda.device_count() + 1)  # more cards than there are
    with pytest.raises(ValueError):
        resolve_grid_mesh(0)
    with pytest.raises(ValueError):
        make_grid_mesh(3, devices=cpus(2))
    with pytest.raises(ValueError, match="1-D"):
        resolve_grid_mesh(Mesh((2, 2), ("a", "b"), (torch.device(CPU),) * 4))
    with pytest.raises(ValueError, match="plan"):
        resolve_grid_mesh(Mesh((4,), ("grid",)))
    with pytest.raises(ValueError, match="1-D"):
        resolve_grid_mesh(make_production_mesh())


def test_shard_grid_cuts_rows_and_copies_shared_operands():
    """Slices in order, shared operands whole, dict operands cut leaf by
    leaf; a row count that does not cut evenly is refused."""
    seen = []

    def body(cfg, x, shared, scale):
        seen.append((cfg["a"].shape[0], x.shape[0], shared.shape[0], scale))
        return {"y": x * scale + cfg["a"][:, None] + shared.sum()}

    cfg, x, shared = {"a": torch.arange(6.0)}, torch.ones((6, 3)), torch.arange(5.0)
    fn = shard_grid(body, make_grid_mesh(devices=cpus(3)), (0, 0, None, None))
    out = fn(cfg, x, shared, 2.0)
    torch.testing.assert_close(out["y"], body(cfg, x, shared, 2.0)["y"], rtol=0, atol=0)
    assert seen[:3] == [(2, 2, 5, 2.0)] * 3
    with pytest.raises(ValueError, match="equal slices"):
        fn({"a": torch.arange(4.0)}, torch.ones((4, 3)), shared, 2.0)


@pytest.mark.parametrize("d", [2, 4])
def test_fleet_mesh_bit_exact(d):
    """Sharded (d-device) sweep == unsharded, raw outputs bitwise; bucket
    uses pinned per mesh shape via ``stats.by_mesh``."""
    cases = fleet_grid()
    ref = FleetSweep(chunk=8, device=CPU).run(cases, 700)
    sweep = FleetSweep(chunk=8, mesh=cpus(d))
    assert sweep.device == torch.device(CPU)
    res = sweep.run(cases, 700)
    assert res.mesh_shape == (d,)
    assert_out_equal(res, ref, ("total", "queueing", "service", "n", "k"))
    assert sweep.stats.by_mesh == {(d,): 1}
    # Same bucket, different grid size: no new bucket on this mesh shape.
    sweep.run(fleet_grid(2), 700)
    assert sweep.stats.by_mesh == {(d,): 1}
    # Sharded AND streamed: still bit-exact vs unsharded materialized.
    st = sweep.run(cases, 700, stream=True)
    assert_points_equal(frontier_points(ref), frontier_points(st))
    assert convergence_stats(ref) == convergence_stats(st)


def test_fleet_mesh_slices_above_the_row_block():
    """A 256-row chunk on 2 devices: 128-row slices, each above the 64-row
    reduction block, materialized and streamed."""
    cases = fleet_grid(44)
    assert len(cases) == 132
    ref = FleetSweep(chunk=256, device=CPU).run(cases, 300)
    sweep = FleetSweep(chunk=256, mesh=cpus(2))
    assert sweep.bucket_key(len(cases), 300, R3.n_max, R3.k_max + 1, R3.n_max + 1)[0] \
        == 256 > 2 * ROW_BLOCK
    res = sweep.run(cases, 300)
    assert_out_equal(res, ref, ("total", "queueing", "service", "n", "k"))
    st = sweep.run(cases, 300, stream=True)
    assert_points_equal(frontier_points(ref), frontier_points(st))
    assert convergence_stats(ref) == convergence_stats(st)
    assert sweep.stats.by_mesh == {(2,): 1}


def test_sched_mesh_bit_exact():
    cases = sched_grid()
    ref = SchedSweep(chunk=4, device=CPU).run(cases, 500)
    sweep = SchedSweep(chunk=4, mesh=cpus(2))
    res = sweep.run(cases, 500)
    assert_out_equal(res, ref, ("total", "queueing", "service", "n", "k", "cls_ids"))
    assert sweep.stats.by_mesh == {(2,): 1}
    st = sweep.run(cases, 500, stream=True)
    assert_points_equal(multiclass_points(ref), multiclass_points(st))


def test_taskq_mesh_bit_exact(pools):
    """Exact engine on a mesh: the grid is cut, the one trace-pool copy goes
    whole to every device (in_axes None)."""
    cases = taskq_grid()
    ref = TaskqSweep(chunk=8, device=CPU).run(cases, 500, pools)
    sweep = TaskqSweep(chunk=8, mesh=cpus(2))
    res = sweep.run(cases, 500, pools)
    assert_out_equal(res, ref, ("total", "queueing", "service", "n", "k"))
    assert sweep.stats.by_mesh == {(2,): 1}
    st = sweep.run(cases, 500, pools, stream=True)
    assert_points_equal(frontier_points(ref), frontier_points(st))


def test_chunk_rounds_up_to_mesh_multiple():
    """chunk=6 on a 4-device mesh pads to 8 so every slice gets equal rows;
    results for the real rows are untouched by the padding."""
    cases = fleet_grid()[:5]
    sweep = FleetSweep(chunk=6, mesh=cpus(4))
    key = sweep.bucket_key(len(cases), 700, R3.n_max, R3.k_max + 1, R3.n_max + 1)
    assert key[0] == 8
    res = sweep.run(cases, 700)
    assert res.launches == 1
    ref = FleetSweep(chunk=8, device=CPU).run(cases, 700)
    assert_out_equal(res, ref, ("total", "queueing", "service", "n", "k"))


def _collected(run):
    obs.set_enabled(True)
    try:
        return run()
    finally:
        obs.set_enabled(None)


@pytest.mark.parametrize("engine", ["fleet", "sched", "taskq"])
def test_mesh_timeline_and_metrics_bit_exact(engine, pools):
    """Timelines fold per case (cut -> concat) and metrics per chunk, so a
    collected mesh-sharded run carries the single-device path's timeline and
    metrics exactly, beside its unchanged primary outputs."""
    if engine == "fleet":
        def run(**kw):
            return FleetSweep(chunk=8, **kw).run(fleet_grid(), 700)
    elif engine == "sched":
        def run(**kw):
            return SchedSweep(chunk=4, **kw).run(sched_grid(), 500)
    else:
        def run(**kw):
            return TaskqSweep(chunk=8, **kw).run(taskq_grid(), 500, pools)
    ref = _collected(lambda: run(device=CPU))
    res = _collected(lambda: run(mesh=cpus(2)))
    assert_out_equal(res, ref, ("total", "n", "k"))
    a, b = ref.timeline.snapshot(), res.timeline.snapshot()
    assert a["window"] == b["window"] and set(a["series"]) == set(b["series"])
    for name in a["series"]:
        np.testing.assert_array_equal(a["series"][name], b["series"][name])
    np.testing.assert_array_equal(a["hists"]["delay"], b["hists"]["delay"])
    assert ref.metrics.snapshot() == res.metrics.snapshot()
