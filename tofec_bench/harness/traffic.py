"""The one traffic generator: every traffic file is parameters for it.

A traffic file's keys:

* ``arrivals``: ``"poisson"`` (an open loop: requests fall due on a
  schedule, whether or not earlier ones have finished) or ``"backlog"``
  (the queue never empties: requests are taken as fast as they are served);
* ``rate_per_s`` (poisson): the offered rate;
* ``keys``: ``"uniform"``, every object equally often.

Every seed gets the same work in another order: a window of ``s`` seconds
at rate ``r`` holds ``round(r * s)`` arrivals, whose gaps are the
exponential distribution's quantiles at (i + 1/2) / n, shuffled by the
seed; the keys are the objects repeated evenly to the count, shuffled by
the seed. So the count of requests, the multiset of gaps and how often
each key is read do not change with the seed, and runs of two seeds differ
only by order.
"""

from __future__ import annotations

import numpy as np

#: tags of the independent streams drawn from one seed
_STREAMS = {"arrivals": 1, "keys": 2, "store": 3, "payloads": 4, "sample": 5, "weights": 6}


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one stream of a run, from ``--seed`` (any whole
    number ≥ 0, also beyond 32 bits)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), _STREAMS[stream]]))


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a ``torch.Generator``, from ``--seed`` and a stream."""
    return int(rng(seed, stream).integers(0, 2**63 - 1))


def due_times(traffic: dict, seed: int, seconds: float) -> np.ndarray:
    """Offsets in seconds from the window's start, ascending, all below
    ``seconds``, of the open loop's arrivals."""
    if traffic["arrivals"] != "poisson":
        raise ValueError(f"arrivals {traffic['arrivals']!r} have no schedule")
    rate = float(traffic["rate_per_s"])
    n = int(round(rate * seconds))
    if not n:
        return np.zeros(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / max(gaps.sum(), seconds)  # the arrivals fit the window
    rng(seed, "arrivals").shuffle(gaps)
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return t[t < seconds]


def key_order(traffic: dict, seed: int, n_keys: int, count: int) -> np.ndarray:
    """``count`` object indices in ``[0, n_keys)``: each object equally often
    (to within one), in an order drawn from the seed."""
    if traffic.get("keys", "uniform") != "uniform":
        raise ValueError(f"keys {traffic['keys']!r} unknown")
    keys = np.resize(np.arange(n_keys), count)
    rng(seed, "keys").shuffle(keys)
    return keys
