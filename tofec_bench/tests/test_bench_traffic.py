"""The traffic generator: deterministic for a seed, the rate kept, the same
work in another order for another seed; and the emulated store's delays."""

import collections

import numpy as np
import pytest

from tofec_bench.harness import store, traffic

POISSON = {"arrivals": "poisson", "rate_per_s": 52.0, "keys": "uniform"}
BIG_SEED = 2**31 + 2**33 + 17


@pytest.mark.parametrize("seed", [0, 5, BIG_SEED])
def test_schedule_is_deterministic_and_keeps_its_rate(seed):
    a = traffic.due_times(POISSON, seed, 45.0)
    b = traffic.due_times(POISSON, seed, 45.0)
    assert np.array_equal(a, b)
    assert len(a) == round(52.0 * 45.0)
    assert np.all(np.diff(a) >= 0) and a[0] == 0.0 and a[-1] < 45.0
    assert abs(len(a) / (a[-1] + np.diff(a).mean()) - 52.0) < 0.02 * 52.0


def test_seeds_change_the_order_not_the_work():
    a, b = (traffic.due_times(POISSON, s, 45.0) for s in (1, 2))
    assert not np.array_equal(a, b)
    ga, gb = np.sort(np.diff(a)), np.sort(np.diff(b))
    # the gaps are one multiset (minus the last gap each), so close in order
    assert len(ga) == len(gb)
    assert abs(ga.sum() - gb.sum()) < 0.05 * 45.0
    ka, kb = (traffic.key_order(POISSON, s, 256, len(a)) for s in (1, 2))
    assert not np.array_equal(ka, kb)
    assert collections.Counter(ka.tolist()) == collections.Counter(kb.tolist())


def test_keys_are_uniform():
    keys = traffic.key_order(POISSON, BIG_SEED, 256, 2340)
    counts = np.bincount(keys, minlength=256)
    assert counts.max() - counts.min() <= 1
    assert np.array_equal(keys, traffic.key_order(POISSON, BIG_SEED, 256, 2340))


def test_writes_take_no_delay():
    s = store.EmulatedS3(store.PAPER_READ_3MB, seed_rng=traffic.rng(4, "store"), time_scale=1.0)
    s.delay_on = True
    s.put("a", b"x" * 2**20)
    s.upload_part("b", 0, b"y" * 2**20)
    s.complete_multipart("b", [0])
    assert s.tasks == [] and s.get_range("b", 0, 4) == b"yyyy"


def test_backlog_has_no_schedule():
    with pytest.raises(ValueError):
        traffic.due_times({"arrivals": "backlog"}, 1, 10.0)


def test_streams_are_independent():
    a = traffic.rng(9, "arrivals").random(4)
    b = traffic.rng(9, "keys").random(4)
    assert not np.allclose(a, b)
    assert 0 <= traffic.stream_seed(BIG_SEED, "weights") < 2**63


def test_store_delay_mean_matches_the_frozen_constants():
    s = store.EmulatedS3(store.PAPER_READ_3MB, seed_rng=traffic.rng(4, "store"), time_scale=0.0)
    blob = bytes(range(256)) * 4096  # 1 MiB
    s.put("a", blob)
    assert s.tasks == []  # delay off
    s.delay_on = True
    for _ in range(20000):
        assert s.get_range("a", 1000, 2**19) == blob[1000:1000 + 2**19]
    d = np.array([t for _, t, _ in s.tasks])
    mb = 0.5
    assert d.min() >= store.PAPER_READ_3MB.floor_s(mb)
    assert abs(d.mean() - store.PAPER_READ_3MB.mean_s(mb)) < 0.02 * store.PAPER_READ_3MB.mean_s(mb)
    tail = d - store.PAPER_READ_3MB.floor_s(mb)
    assert abs(tail.std() - store.PAPER_READ_3MB.tail_s(mb)) < 0.03 * store.PAPER_READ_3MB.tail_s(mb)


def test_every_seed_draws_the_same_tails_block_by_block():
    tails = [store.EmulatedS3(store.PAPER_READ_3MB, seed_rng=traffic.rng(seed, "store"))._tails
             for seed in (4, BIG_SEED)]
    assert not np.array_equal(tails[0], tails[1])
    for b in (0, 1, store.BLOCKS - 1):
        blocks = [np.sort(t[b * store.BLOCK:(b + 1) * store.BLOCK]) for t in tails]
        assert np.array_equal(blocks[0], blocks[1])


def test_frozen_constants_are_the_papers_calibration():
    # §V-A read, 3 MB class: Δ̄, Δ̃ (s/MB), Ψ̄, Ψ̃ (s/MB)
    r = store.PAPER_READ_3MB
    assert (r.delta_bar, r.delta_tilde, r.psi_bar, r.psi_tilde) == (0.050, 0.018, 0.015, 0.030)
    # the (1, 1) task of a 3 MB read: 104 ms floor + 105 ms tail
    assert abs(r.mean_s(3.0) - 0.209) < 1e-12
