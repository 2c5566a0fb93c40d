"""Grid sharding and the launch planner's work count on the card. Each test
is marked ``cuda`` and skips where no CUDA card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_launch_cuda.py

A mesh that repeats the card (``["cuda:0", "cuda:0"]``) cuts every launch's
grid rows in two halves that run one after the other; the sharded fleet,
sched and taskq sweeps must equal the unsharded ones on the card bit for
bit. The work count of mixtral's smoke prefill on the card (where the MoE
experts' product is ``aten.bmm.dtype``) must equal its count on ``meta``
exactly: the planner counts the card's path.
"""

import pytest
import torch

from repro_torch.core import PAPER_READ_3MB, RequestClass
from repro_torch.core.traces import TraceStore
from repro_torch.fleet import FleetSweep, PolicySpec, TenantMix, frontier_points, grid_cases
from repro_torch.launch.specs import dryrun_target
from repro_torch.models import ShapeSpec, get
from repro_torch.models.registry import make_batch
from repro_torch.obs import count_work
from repro_torch.sched import DisciplineSpec, SchedSweep, sched_cases
from repro_torch.taskq import TaskqSweep

pytestmark = pytest.mark.cuda

R3 = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
R1 = RequestClass("read1mb", 1.0, PAPER_READ_3MB, k_max=4, r_max=2.0, n_max=8)
L = 16
MESH = ["cuda:0", "cuda:0"]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _equal(res, ref, names):
    for name in names:
        torch.testing.assert_close(res.out[name], ref.out[name], rtol=0, atol=0)


def test_fleet_on_a_repeated_card_mesh_is_bit_equal():
    cases = grid_cases([5.0, 20.0, 40.0, 60.0],
                       [PolicySpec.tofec(), PolicySpec.static(6, 3), PolicySpec.fixedk(4)],
                       [0], R3, L)
    ref = FleetSweep(chunk=8).run(cases, 700)
    sweep = FleetSweep(chunk=8, mesh=MESH)
    res = sweep.run(cases, 700)
    _equal(res, ref, ("total", "queueing", "service", "n", "k"))
    assert sweep.stats.by_mesh == {(2,): 1}
    st = sweep.run(cases, 700, stream=True)
    assert [p.to_dict() for p in frontier_points(ref)] == \
        [p.to_dict() for p in frontier_points(st)]


def test_sched_and_taskq_on_a_repeated_card_mesh_are_bit_equal():
    mixes = [TenantMix(lam, (R3, R1), (0.6, 0.4)) for lam in (15.0, 35.0)]
    cases = sched_cases(mixes, [DisciplineSpec.fifo(), DisciplineSpec.priority(0, 1),
                                DisciplineSpec.wfq(2.0, 1.0)], [0], L=L)
    ref = SchedSweep(chunk=4).run(cases, 500)
    sweep = SchedSweep(chunk=4, mesh=MESH)
    _equal(sweep.run(cases, 500), ref, ("total", "queueing", "service", "n", "k", "cls_ids"))
    assert sweep.stats.by_mesh == {(2,): 1}

    sizes = tuple(R3.file_mb / k for k in range(1, R3.k_max + 1))
    pools = TraceStore.generate(PAPER_READ_3MB, sizes, threads=R3.n_max, samples=1024,
                                correlation=0.12, seed=3).device_pools(n_max=R3.n_max)
    cases = grid_cases([10.0, 30.0, 50.0], [PolicySpec.tofec(), PolicySpec.greedy()], [0], R3, L)
    ref = TaskqSweep(chunk=8).run(cases, 500, pools)
    sweep = TaskqSweep(chunk=8, mesh=MESH)
    _equal(sweep.run(cases, 500, pools), ref, ("total", "queueing", "service", "n", "k"))
    assert sweep.stats.by_mesh == {(2,): 1}


def test_moe_prefill_count_on_the_card_equals_its_count_on_meta():
    arch = get("mixtral-8x7b", smoke=True)
    shape = ShapeSpec("p", "prefill", 32, 4)
    fn, meta_args, _ = dryrun_target(arch, shape, None)
    on_meta = count_work(fn, *meta_args)
    params = arch.init(device="cuda")
    on_card = count_work(fn, params, make_batch(arch.cfg, shape, device="cuda"))
    assert on_card == on_meta and on_card[0] > 0
