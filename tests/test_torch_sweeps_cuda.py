"""The exact task engine and the shared-pool scan on the card, against the
same runs on the CPU. Each test is marked ``cuda`` and skips where no CUDA
card is present.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sweeps_cuda.py

Tolerances: the task engine's step is elementwise float32 operations,
integer counts, ``argmin`` and a sort, each exact on either device, so the
card's outputs equal the CPU's. The joint scan sums over the class axis and
the Exp draws, which the card may add in another order: picks equal on
≥ 0.999 of arrivals, delays within rtol 1e-4 / atol 1e-6 (the fluid-scan
mirror's tolerance). Runs on one device are held bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import PAPER_READ_3MB, RequestClass
from repro_torch.core.traces import TraceStore
from repro_torch.fleet import FleetSweep, PolicySpec, TenantMix, grid_cases
from repro_torch.sched import (
    DisciplineSpec,
    SchedCase,
    SchedSweep,
    multiclass_points,
    sched_cases,
)
from repro_torch.taskq import TaskqSweep

pytestmark = pytest.mark.cuda

R3 = RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=6, r_max=2.0, n_max=12)
R1 = RequestClass("read1mb", 1.0, PAPER_READ_3MB, k_max=4, r_max=2.0, n_max=8)
L = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _pools(device):
    store = TraceStore.generate(PAPER_READ_3MB, [3.0 / k for k in range(1, 7)], threads=12,
                                samples=2048, correlation=0.14, seed=3)
    return store.device_pools(n_max=12, device=device)


def test_taskq_sweep_on_card_equals_cpu(cuda):
    cases = grid_cases([10.0, 35.0, 60.0],
                       [PolicySpec.tofec(), PolicySpec.greedy(), PolicySpec.static(12, 6)],
                       [7], R3, L)
    got = TaskqSweep(chunk=4, device=cuda).run(cases, 600, _pools(cuda))
    want = TaskqSweep(chunk=4, device="cpu").run(cases, 600, _pools("cpu"))
    assert got.out["total"].device.type == "cuda"
    assert (got.compiles, got.launches) == (want.compiles, want.launches) == (1, 3)
    a, b = got.to_numpy(), want.to_numpy()
    for name in ("total", "queueing", "service", "n", "k"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_taskq_streamed_equals_materialized_on_card(cuda):
    from repro_torch.fleet import frontier_points

    cases = grid_cases([20.0, 50.0], [PolicySpec.tofec(), PolicySpec.greedy()], [1], R3, L)
    pools = _pools(cuda)
    mat = TaskqSweep(chunk=2, device=cuda).run(cases, 500, pools)
    strm = TaskqSweep(chunk=2, device=cuda).run(cases, 500, pools, stream=True)
    assert [p.to_dict() for p in frontier_points(strm)] == \
        [p.to_dict() for p in frontier_points(mat)]


def test_sched_sweep_on_card_matches_cpu(cuda):
    mixes = [TenantMix(lam, (R3, R1), (0.5, 0.5)) for lam in (25.0, 55.0)]
    cases = sched_cases(mixes, [DisciplineSpec.fifo(), DisciplineSpec.priority(0, 1),
                                DisciplineSpec.wfq(2.0, 1.0)], [1], L=L)
    got = SchedSweep(chunk=8, device=cuda).run(cases, 800)
    want = SchedSweep(chunk=8, device="cpu").run(cases, 800)
    assert got.out["total"].device.type == "cuda"
    a, b = got.to_numpy(), want.to_numpy()
    np.testing.assert_array_equal(a["cls_ids"], b["cls_ids"])
    for name in ("n", "k"):
        assert (a[name] == b[name]).mean() >= 0.999, name
    for name in ("total", "queueing", "service"):
        np.testing.assert_allclose(a[name], b[name], rtol=1e-4, atol=1e-6, err_msg=name)
    strm = SchedSweep(chunk=8, device=cuda).run(cases, 800, stream=True)
    assert [p.to_dict() for p in multiclass_points(strm)] == \
        [p.to_dict() for p in multiclass_points(got)]


def test_single_class_mix_equals_fluid_scan_on_card(cuda):
    cases = [SchedCase(mix=TenantMix(40.0, (R3,), (1.0,)), discipline=d, seed=5, L=L)
             for d in (DisciplineSpec.fifo(), DisciplineSpec.priority(0),
                       DisciplineSpec.wfq(1.0))]
    got = SchedSweep(chunk=4, device=cuda).run(cases, 800).to_numpy()
    want = FleetSweep(chunk=4, device=cuda).run(
        grid_cases([40.0], [PolicySpec.tofec()], [5], R3, L), 800).to_numpy()
    for g in range(len(cases)):
        for name in ("total", "queueing", "service", "n", "k"):
            np.testing.assert_array_equal(got[name][g], want[name][0], err_msg=name)
