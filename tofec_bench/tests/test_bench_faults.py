"""The harness, past its look for a card, drives whole runs at CPU sizes with
the timed path broken underneath, and ``correct`` comes out false for each
fault a cell can have; a sound run comes out true. (No cell runs on more
than one chip, so no exchange between chips can be left out.)"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from tofec_bench.harness import spec

CPU = torch.device("cpu")


def _run(root, workload, hook=None, **kw):
    cell = spec.load_cell(workload, root)
    rec = spec.driver(cell).run(cell, seed=2**31 + 77, seconds=1.5, traced=False, device=CPU,
                                process_start=time.monotonic(), hook=hook, **kw)
    return {c.name: c for c in rec.checks}, rec


def _correct(checks):
    return all(c.holds for c in checks.values())


# -- a proxy cell -------------------------------------------------------------


def _decode_returns_its_input(name, dep):
    if name == "deployment":
        dep.codec.decode = lambda rows, present, n, k: rows


def _half_left_out(name, dep):
    if name == "deployment":
        inner = dep.layout.reconstruct_batch

        def half(items, codec=None):
            return inner(items, codec=codec)[: max(1, len(items) // 2)] if len(items) > 1 \
                else inner(items, codec=codec)

        object.__setattr__(dep.layout, "reconstruct_batch", half)


def _answer_altered(name, dep):
    if name == "deployment":
        inner = dep.layout.reconstruct_batch

        def altered(items, codec=None):
            return [bytes([b[0] ^ 1]) + b[1:] for b in inner(items, codec=codec)]

        object.__setattr__(dep.layout, "reconstruct_batch", altered)


def test_sound_proxy_run_is_correct(small):
    checks, rec = _run(small, "read3mb-poisson")
    assert _correct(checks), checks
    assert rec.attempted > 100 and rec.failed == 0


@pytest.mark.parametrize("fault, number", [
    (_decode_returns_its_input, "reads_wrong_or_failed"),
    (_half_left_out, "reads_never_answered"),
    (_answer_altered, "reads_wrong_or_failed"),
])
def test_proxy_faults_are_not_correct(small, fault, number):
    checks, _ = _run(small, "read3mb-poisson", hook=fault)
    assert not checks[number].holds, checks[number]
    assert not _correct(checks)


# -- a served model -----------------------------------------------------------


class _Stuck:
    """The model's decode step, returning the cache it was given."""

    def __init__(self, arch):
        self._arch = arch

    def __getattr__(self, name):
        return getattr(self._arch, name)

    def decode_step(self, params, token, cache):
        logits, _ = self._arch.decode_step(params, token, cache)
        return logits, cache


def _state_unchanged(name, obj):
    if name == "server":
        obj.engine.arch = _Stuck(obj.engine.arch)


def _serve_half(name, server):
    if name == "server":
        inner = server.serve_round

        def half(keys, *, steps):
            res = inner(keys, steps=steps)
            keep = len(res.tokens) // 2
            return dataclasses.replace(res, tokens=res.tokens[:keep],
                                       ok=[i < keep for i in range(len(res.ok))],
                                       codes=res.codes[:keep])

        server.serve_round = half


def _token_altered(name, server):
    if name == "server":
        inner = server.serve_round
        vocab = server.engine.arch.cfg.vocab

        def altered(keys, *, steps):
            res = inner(keys, steps=steps)
            toks = np.array(res.tokens)
            toks[:, 0] = (toks[:, 0] + 1) % vocab
            return dataclasses.replace(res, tokens=toks)

        server.serve_round = altered


def test_sound_served_run_is_correct(small):
    checks, rec = _run(small, "zamba2-chat-poisson")
    assert _correct(checks), checks
    assert rec.failed == 0 and "control_gaps" not in rec.extra


@pytest.mark.parametrize("fault, number", [
    (_state_unchanged, "mean_sq_logit_gap"),
    (_serve_half, "requests_not_served"),
    (_token_altered, "mean_sq_logit_gap"),
])
def test_served_faults_are_not_correct(small, fault, number):
    checks, _ = _run(small, "zamba2-chat-poisson", hook=fault)
    assert not checks[number].holds, checks[number]
    assert not _correct(checks)


def test_fp8_control_reads_wider_gaps_than_the_program(small):
    """The control in the program's place, at CPU size: the tokens the
    reference in float8 products puts first are judged by the run's own
    check, and lie further below the float32 reference's best than the
    bfloat16 program's tokens do. (At CPU shapes the float8 error moves few
    tokens; the card test below holds the control to the limit at the
    cell's own size.)"""
    checks, rec = _run(small, "zamba2-chat-poisson", control="fp8")
    program, control = (np.asarray(rec.extra[k]) for k in ("program_gaps", "control_gaps"))
    assert checks["mean_sq_logit_gap"].value == pytest.approx(np.mean(control ** 2))
    assert len(program) == len(control) > 0 and control.max() > program.max()
    assert rec.extra["notes"][0].startswith("control fp8 tokens judged")


@pytest.mark.cuda
@pytest.mark.parametrize("workload, seconds", [("zamba2-chat-poisson", 16.0),
                                               ("zamba2-decode-batch", 12.0)])
def test_fp8_control_is_not_correct_at_the_cells_size(card, workload, seconds):
    """The control at the cell's own size on the card: the reference in
    float8 products, put in the program's place, comes out not correct."""
    cell = spec.load_cell(workload)
    rec = spec.driver(cell).run(cell, seed=2**31 + 4321, seconds=seconds, traced=False,
                                device=card, process_start=time.monotonic(), control="fp8")
    checks = {c.name: c for c in rec.checks}
    assert not checks["mean_sq_logit_gap"].holds, checks["mean_sq_logit_gap"]
    assert np.mean(np.square(rec.extra["program_gaps"])) < checks["mean_sq_logit_gap"].limit
