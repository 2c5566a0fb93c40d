"""Driver of a model served through the proxy by ``ClosedLoopServer``.

Set-up makes the model's weights on the device from the seed
(``harness.weights``), builds the proxy deployment, the fused serving step
and the closed-loop server, stores the configuration's ``prompts`` seeded
prompts as coded objects (delay off), and warms every batch bucket the
traffic can use with a round of two tokens (delay off).

The window then runs ``serve_round`` over the traffic:

* ``arrivals: poisson``: each round takes every request due when the
  previous round ended, up to ``max_round``, oldest first; when none is
  due it waits for the next. A request's delay runs from its due time to
  the round's end, when its tokens are on the host. After the close the
  requests already due are served to the last.
* ``arrivals: backlog``: rounds of ``round`` prompts run back to back; the
  window ends with the last round started before the close.

The traced run profiles rounds ``trace_from`` to ``trace_from +
traced_rounds - 1`` whole, with the host's waits between them. The
profiler starts there and not before: once loaded, its tracing library
slows every kernel launch, so the round metrics of a traced run are read
from the rounds before it.

Once the window has closed and the peak memory is read, the program's
state is freed and the configuration's reference runs over a sample of the
served requests, drawn from the seed: each prompt with its served tokens,
in one pass. Every served token's gap below the reference's best logit at
its position is read, and the mean of their squares is held to the
configuration's limit: a gap is nought where the served token is the
reference's first, and both how often a token departs and how far grow
with the program's error, so the square's mean parts a lower precision
from the program's where the widest gap or the mean cannot (PERF.md §2).
The control puts the reference in a lower precision in the program's
place: the tokens it puts first at the same positions are judged instead.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import resource
import time

import numpy as np
import torch

from tofec_bench.harness import deploy, spec, trace, traffic, weights
from tofec_bench.harness.record import Check, Record


def arch_for(config: dict):
    """The port's architecture at the configuration's sizes."""
    from repro_torch.models import registry

    base = registry.get(config["arch"])
    return registry.Arch(dataclasses.replace(base.cfg, **config["model"]), base.module)


def buckets(traffic_cfg: dict) -> list[int]:
    """Every batch bucket (a power of two) the traffic's rounds can fill."""
    most = int(traffic_cfg.get("max_round") or traffic_cfg["round"])
    if traffic_cfg["arrivals"] == "backlog":
        return [1 << (most - 1).bit_length()]
    return [1 << i for i in range((most - 1).bit_length() + 1)]


def token_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """(rows, steps) gap of each served token's logit below the best."""
    best = ref_logits.max(dim=-1).values
    got = torch.gather(ref_logits, -1, served.long()[..., None])[..., 0]
    return best - got


def _steal_s() -> float:
    """CPU seconds the hypervisor has taken from this machine's CPUs, summed
    over them (``/proc/stat``), or 0 where that is not kept."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


class HostUse:
    """What the host does in a round: the main thread's CPU time and the
    times the kernel preempted it, the other threads' CPU time, the garbage
    collector's time, and the CPU time the hypervisor took."""

    def __init__(self):
        self.gc_s = 0.0
        self._gc_t = None
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self._gc_t = None

    def close(self):
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)

    def mark(self) -> tuple:
        t = resource.getrusage(resource.RUSAGE_THREAD)
        p = resource.getrusage(resource.RUSAGE_SELF)
        return (t.ru_utime + t.ru_stime, t.ru_nivcsw, p.ru_utime + p.ru_stime, self.gc_s,
                _steal_s())

    @staticmethod
    def between(a: tuple, b: tuple) -> dict:
        return {"main_cpu_s": b[0] - a[0], "main_nivcsw": b[1] - a[1],
                "other_cpu_s": (b[2] - a[2]) - (b[0] - a[0]), "gc_s": b[3] - a[3],
                "steal_s": b[4] - a[4]}


def store_seconds_in(tasks: list, lo: float, hi: float, scale: float) -> float:
    """Seconds of the store's tasks (``EmulatedS3.tasks``) spent asleep
    between ``lo`` and ``hi`` on the monotonic clock."""
    return sum(max(0.0, min(t0 + d * scale, hi) - max(t0, lo)) for _, d, t0 in tasks)


def run(cell, *, seed: int, seconds: float, traced: bool, device, process_start: float,
        hook=None, control: str | None = None) -> Record:
    """One run of the cell. ``hook(name, obj)``, where given, sees the
    deployment and the server before set-up (the fault tests break them
    there). ``control``, a reference precision, puts the control in the
    program's place: the tokens that precision puts first are judged
    instead of the served ones (``rec.extra`` keeps both sets of gaps)."""
    from repro_torch.serve.engine import ClosedLoopServer, FusedServingStep, ServingEngine

    cfg, tr = cell.config, cell.traffic
    prompt, gen = int(tr["prompt_tokens"]), int(tr["gen_tokens"])
    arch = arch_for(cfg)
    params = weights.seeded_params(arch, traffic.stream_seed(seed, "weights"), device)
    dep = deploy.Deployment(cfg["deployment"], seed, device)
    rec = Record(config=cfg, traffic=tr)
    try:
        step = FusedServingStep.for_class(dep.request_class, dep.L, codec=dep.codec)
        engine = ServingEngine(arch, params, max_seq=prompt + gen)
        server = ClosedLoopServer(engine, dep.proxy, dep.layout, step, prompt_len=prompt)
        if hook:
            hook("deployment", dep)
            hook("server", server)
        n_p = int(cfg["prompts"])
        tgen = torch.Generator(device=device).manual_seed(traffic.stream_seed(seed, "payloads"))
        prompts = torch.randint(0, arch.cfg.vocab, (n_p, prompt), dtype=torch.int32,
                                device=device, generator=tgen).cpu().numpy()
        keys = [deploy.key_name(i) for i in range(n_p)]
        dep.store_objects(keys, [p.tobytes() for p in prompts])
        for b in buckets(tr):
            server.serve_round(keys[:b], steps=2)
        dep.store.delay_on = True
        launches0 = dep.k1_count()
        served: dict[int, np.ndarray] = {}
        t0 = time.monotonic()
        rec.setup_s = t0 - process_start
        close = t0 + seconds
        if tr["arrivals"] == "poisson":
            due = t0 + traffic.due_times(tr, seed, seconds)
            order = traffic.key_order(tr, seed, n_p, len(due))
            most = int(tr["max_round"])
        else:
            due = None
            most = int(tr["round"])
            order = traffic.key_order(tr, seed, n_p, 64 * n_p)
        trace_from = int(tr.get("trace_from", 1))
        trace_to = trace_from + int(tr.get("traced_rounds", 1))
        nxt = 0
        host = HostUse()
        while True:
            r = len(rec.rounds)
            if traced and r == trace_from:
                tracer = trace.Tracer(warm=False)
                tracer.start()
            if due is None:
                if time.monotonic() >= close:
                    break
                take = list(range(nxt, nxt + most))
                for j in take:
                    rec.requests.append({"due": time.monotonic(), "done": None, "ok": False,
                                         "key": int(order[j % len(order)])})
            else:
                if nxt >= len(due):
                    break
                with trace.label(traced and trace_from <= r < trace_to, "wait_arrivals"):
                    deploy.wait_until(due[nxt])
                now = time.monotonic()
                stop = nxt
                while stop < len(due) and stop - nxt < most and due[stop] <= now:
                    stop += 1
                take = list(range(nxt, stop))
                for j in take:
                    rec.requests.append({"due": float(due[j]), "done": None, "ok": False,
                                         "key": int(order[j])})
            nxt += len(take)
            round_keys = [keys[rec.requests[j]["key"]] for j in take]
            call = len(dep.policy.calls)
            task0 = len(dep.store.tasks)
            mark = host.mark()
            start = time.monotonic()
            with trace.label(traced, "round"):
                res = server.serve_round(round_keys, steps=gen)
            end = time.monotonic()
            use = HostUse.between(mark, host.mark())
            gen_start = start + (res.phase_ms["fetch"] + res.phase_ms["launch"]) / 1e3
            use["store_s_in_generate"] = store_seconds_in(dep.store.tasks[task0:], gen_start, end,
                                                          dep.store.time_scale)
            rows = iter(range(len(res.tokens)))
            for pos, (j, ok) in enumerate(zip(take, res.ok)):
                req = rec.requests[j]
                req.update(done=end, round=r, ok=bool(ok), call=call + pos)
                if ok:
                    row = next(rows)
                    served[j] = res.tokens[row]
                    req["n"], req["k"] = res.codes[row]
            rec.rounds.append({"start": start, "end": end, "rows": len(take),
                               "padded": 1 << (len(take) - 1).bit_length(), "steps": gen,
                               "prompt": prompt, "phase_ms": dict(res.phase_ms),
                               "traced": traced and trace_from <= r < trace_to,
                               "after_profiler": traced and r >= trace_from, "host": use})
            if traced and r == trace_to - 1:
                rec.trace = tracer.stop()
                _name_fetch_gaps(rec.trace, rec.rounds)
        host.close()
        if traced and rec.trace is None:
            raise RuntimeError(f"the window ran {len(rec.rounds)} rounds; the trace needs "
                               f"round {trace_to - 1}")
        rec.t0, rec.t1 = t0, (rec.rounds[-1]["end"] if due is None else close)
        launches = dep.k1_count() - launches0
        if device.type == "cuda":
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        want = dep.reference_codes()
        dep.close()
        del server, engine, step
        dep.store = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        program, ctrl = reference_gaps(cell, params, prompts, rec, served, seed, device,
                                       control=control)
        gaps = program if ctrl is None else ctrl
        rec.extra["program_gaps"] = program.tolist()
        if ctrl is not None:
            rec.extra["control_gaps"] = ctrl.tolist()
        mean_sq = float((gaps.double() ** 2).mean()) if gaps.numel() else math.inf
        if gaps.numel():
            rec.extra["notes"] = [
                f"{'control ' + control if control else 'served'} tokens judged: {gaps.numel()}, "
                f"{int((gaps > 0).sum())} off the reference's first, mean gap "
                f"{float(gaps.mean())!r}, widest {float(gaps.max())!r}"]
        rec.checks = [
            Check("requests_not_served", sum(1 for r in rec.requests if not r["ok"]), 0),
            Check("codes_unlike_reference",
                  sum(1 for r in rec.requests if r["ok"] and (r["n"], r["k"]) != want[r["call"]]),
                  0),
            Check("k1_launches_in_window", launches, 1, at_least=True),
            Check("mean_sq_logit_gap", mean_sq, float(cfg["check"]["max_mean_sq_logit_gap"])),
        ]
        return rec
    finally:
        dep.close()


def _name_fetch_gaps(tr: dict, rounds: list[dict]) -> None:
    """Name an idle gap that falls in a profiled round's fetch phase, where
    the host waits in the proxy's threads (which the profiler does not
    follow) with no PyTorch operation of its own."""
    spans = tr["ranges"].get("bench.round", [])
    profiled = [r for r in rounds if r["traced"]]
    for gap, mid in zip(tr["idle_gaps"], tr["idle_gap_mid_ns"]):
        for (s, e), r in zip(spans, profiled):
            if (s <= mid < e and mid - s < r["phase_ms"]["fetch"] * 1e6
                    and gap[0].endswith("no PyTorch operation")):
                gap[0] = "bench.round / fetch: the proxy's raw reads (host waits on the store)"


def sample_requests(served: dict, seed: int, tokens: int, gen: int) -> list[int]:
    """Served requests drawn from the seed, enough for ``tokens`` served
    tokens."""
    ids = sorted(served)
    count = min(len(ids), math.ceil(tokens / gen))
    pick = traffic.rng(seed, "sample").choice(len(ids), size=count, replace=False)
    return [ids[i] for i in sorted(pick)]


def reference_gaps(cell, params, prompts, rec, served, seed, device, control: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Gaps below the reference's best logit of the sampled requests'
    served tokens and, with ``control`` (a reference precision), of the
    tokens that reference puts first at the same positions."""
    cfg, tr = cell.config, cell.traffic
    prompt, gen = int(tr["prompt_tokens"]), int(tr["gen_tokens"])
    ref = spec.reference(cell)
    ids = sample_requests(served, seed, int(cfg["check"]["sample_tokens"]), gen)
    program, ctrl = [], []
    rows = int(cfg["check"]["ref_rows"])
    positions = list(range(prompt - 1, prompt + gen - 1))
    for i in range(0, len(ids), rows):
        block = ids[i:i + rows]
        toks = np.stack([np.concatenate([prompts[rec.requests[j]["key"]], served[j][:-1]])
                         for j in block])
        got = torch.from_numpy(np.stack([served[j] for j in block])).to(device)
        seq = torch.from_numpy(toks.astype(np.int64)).to(device)
        lg = ref.logits(params, cfg, seq, positions)
        program.append(token_gaps(lg, got).flatten().cpu())
        if control is not None:
            first = ref.logits(params, cfg, seq, positions, precision=control).argmax(-1)
            ctrl.append(token_gaps(lg, first).flatten().cpu())
    empty = torch.zeros(0)
    return (torch.cat(program) if program else empty,
            (torch.cat(ctrl) if ctrl else empty) if control is not None else None)
