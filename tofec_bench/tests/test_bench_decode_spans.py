"""The reader of the closed loop's decode counts (``harness/decode_spans.py``)
on recorded traces: the window's tagged ``serve.generate`` spans, None where
the program tagged none, and a traced CPU run of the batch cell, where every
decode step runs eagerly."""

import time

import pytest
import torch

from repro_torch import obs
from tofec_bench.harness import decode_spans, spec
from tofec_bench.harness.record import Record


@pytest.fixture
def tracer(monkeypatch):
    t = obs.Tracer()
    monkeypatch.setattr(decode_spans, "_tracer", lambda: t)
    return t


def _generate(t, at, **tags):
    e = t.anchor[0]
    t.complete("serve.generate", e + at, e + at + 0.5, depth=1, parent="serve.round",
               steps=64, device_ms=480.0, **tags)


def _rec(t):
    e = t.anchor[0]
    return Record(t0=e + 10.0, t1=e + 20.0)


def test_the_share_of_the_windows_rounds(tracer):
    _generate(tracer, 9.0, graph_replays=0, eager_steps=63)  # before the window
    _generate(tracer, 11.0, graph_replays=63, eager_steps=0)
    _generate(tracer, 12.0, graph_replays=31, eager_steps=0)
    _generate(tracer, 13.0, graph_replays=0, eager_steps=31)
    _generate(tracer, 20.0, graph_replays=0, eager_steps=63)  # after it
    assert decode_spans.decode_graph_share(_rec(tracer)) == pytest.approx(
        100.0 * 94 / 125)


def test_untagged_spans_read_none(tracer):
    """The parent's spans: ``serve.generate`` without the counts."""
    _generate(tracer, 11.0)
    assert decode_spans.decode_graph_share(_rec(tracer)) is None


def test_no_spans_read_none(tracer):
    assert decode_spans.decode_graph_share(_rec(tracer)) is None
    _generate(tracer, 11.0, graph_replays=0, eager_steps=0)  # a round of one token
    assert decode_spans.decode_graph_share(_rec(tracer)) is None


def test_a_tracer_without_a_window_reads_none(monkeypatch):
    class Older:
        def events(self):
            return []

    monkeypatch.setattr(decode_spans, "_tracer", Older)
    assert decode_spans.decode_graph_share(Record(t0=0.0, t1=1.0)) is None


def test_a_traced_cpu_run_decodes_every_step_eagerly(small):
    cell = spec.load_cell("zamba2-decode-batch", small)
    obs.reset_trace()
    try:
        rec = spec.driver(cell).run(cell, seed=2**31 + 11, seconds=10.0, traced=True,
                                    device=torch.device("cpu"), process_start=time.monotonic())
        assert all(c.holds for c in rec.checks if c.name != "k1_launches_in_window")
        assert spec.metric_reader(cell, "decode_graph_share.batch")(rec) == 0.0
    finally:
        obs.reset_trace()
