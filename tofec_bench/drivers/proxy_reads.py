"""Driver of a proxy deployment under open-loop reads (no model).

Set-up stores the configuration's ``objects`` seeded payloads, coded, with
the store's delay off, and warms the read path with one burst of reads
(delay off, all submitted at once, so the backlog walks the controller
through its codes). The window then submits each read at its due time
through ``Proxy.read_async`` (``raw=False``: the proxy decodes each
admission round's completed reads in one batched K1 call) and, once it has
closed, waits for every read, a configuration's ``drain_s`` at the most.

A read's delay runs from its due time to the proxy's ``t_done`` for its
decoded bytes. It is correct when its bytes are the payload's and its
(n, k) is the reference controller's for the backlog the program's
controller was given.
"""

from __future__ import annotations

import time

import torch

from tofec_bench.harness import deploy, trace, traffic
from tofec_bench.harness.record import Check, Record

WARM_READS = 64


def run(cell, *, seed: int, seconds: float, traced: bool, device, process_start: float,
        hook=None) -> Record:
    """One run of the cell. ``hook(name, obj)``, where given, sees the
    deployment before set-up (the control and the fault tests break it
    there)."""
    cfg, tr = cell.config, cell.traffic
    dep = deploy.Deployment(cfg["deployment"], seed, device)
    if hook:
        hook("deployment", dep)
    rec = Record(config=cfg, traffic=tr)
    try:
        n_obj = int(cfg["objects"])
        keys = [deploy.key_name(i) for i in range(n_obj)]
        payloads = deploy.random_bytes(seed, n_obj, dep.file_bytes, device)
        dep.store_objects(keys, payloads)
        warm = [dep.proxy.read_async(keys[i % n_obj], dep.layout, dep.file_bytes)
                for i in range(WARM_READS)]
        for req in warm:
            dep.proxy.wait(req, timeout=600)
        offsets = traffic.due_times(tr, seed, seconds)
        order = traffic.key_order(tr, seed, n_obj, len(offsets))
        if traced:
            dep.record_k1()
            tracer = trace.Tracer()
        dep.store.delay_on = True
        launches0 = dep.k1_count()
        t0 = time.monotonic()
        rec.setup_s = t0 - process_start
        if traced:
            tracer.start()
        sent = []
        with trace.label(traced, "submit_reads"):
            for off, i in zip(offsets, order):
                due = t0 + float(off)
                deploy.wait_until(due)
                call = len(dep.policy.calls)
                req = dep.proxy.read_async(keys[i], dep.layout, dep.file_bytes)
                sent.append((due, int(i), call, time.monotonic() - due, req))
            deploy.wait_until(t0 + seconds)
        if traced:
            rec.trace = tracer.stop()
            dep.stop_k1()
        rec.t0, rec.t1 = t0, t0 + seconds
        launches = dep.k1_count() - launches0
        deadline = rec.t1 + float(cfg["drain_s"])
        for due, i, call, late, req in sent:
            try:
                res = dep.proxy.wait(req, timeout=max(0.0, deadline - time.monotonic()))
            except TimeoutError:
                rec.requests.append({"due": due, "done": None, "ok": False, "late_s": late,
                                     "call": call, "key": i})
                continue
            rec.requests.append({
                "due": due, "done": res.t_done, "ok": res.ok and res.data == payloads[i],
                "late_s": late, "call": call, "key": i, "n": res.n, "k": res.k,
                "queue_s": res.queueing_s, "service_s": res.service_s})
        if device.type == "cuda":
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        want = dep.reference_codes()
        wrong_bytes = sum(1 for r in rec.requests if r["done"] is not None and not r["ok"])
        wrong_codes = sum(1 for r in rec.requests
                          if r["done"] is not None and (r["n"], r["k"]) != want[r["call"]])
        rec.extra["k1_calls"] = [(s, b, d) for s, b, d in dep.k1_calls]
        rec.extra["notes"] = [_work_line(rec, dep.store.tasks)]
        rec.checks = [
            Check("reads_never_answered", sum(r["done"] is None for r in rec.requests), 0),
            Check("reads_wrong_or_failed", wrong_bytes, 0),
            Check("codes_unlike_reference", wrong_codes, 0),
            Check("k1_launches_in_window", launches, 1, at_least=True),
        ]
        return rec
    finally:
        dep.close()


def _work_line(rec: Record, tasks) -> str:
    """What a run's window asked of the store and how late the host was: the
    store's task seconds drawn after the window opened, the submit loop's
    worst lateness, and the reads' mean k, queueing and service."""
    drawn = [d for _, d, start in tasks if start >= rec.t0]
    late = [r["late_s"] for r in rec.requests]
    done = [r for r in rec.requests if r["done"] is not None]

    def mean(xs):
        return sum(xs) / len(xs) if xs else float("nan")

    return (f"work: {len(drawn)} store tasks, {sum(drawn):.3f} task s (mean "
            f"{mean(drawn) * 1e3:.3f} ms); submit late max {max(late, default=0) * 1e3:.1f} ms, "
            f"{sum(x > 0.05 for x in late)} reads > 50 ms late; mean k "
            f"{mean([r['k'] for r in done]):.4f}, queue {mean([r['queue_s'] for r in done]) * 1e3:.2f} "
            f"ms, service {mean([r['service_s'] for r in done]) * 1e3:.2f} ms")
