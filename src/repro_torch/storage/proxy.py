"""The front-end proxy of Fig.2, executing real I/O against an ObjectStore.

A :class:`Proxy` owns L connection threads, a FIFO request queue, and a FIFO
task queue, and serves high-level read/write requests with (n, k) MDS codes
chosen per request by a :class:`repro_torch.core.controller.Policy` — the
real-I/O twin of the reference package's event simulator (the statistics
oracle).

Reads use the Shared-Key layout: the coded object (N·b bytes) lives under
one key; each task is a ranged read of one chunk; the request completes when
k chunks arrive and the remaining tasks are cancelled (best-effort: queued
tasks are dropped; in-flight ones are abandoned — their results discarded —
matching a proxy that closes the connection).

Writes encode k chunks into n, upload each as a part, and complete when any
k parts are durable (the paper's write model); the remaining uploads continue
as background tasks (footnote 1), and once every issued task has resolved the
proxy assembles the durable parts into the readable coded object and records
which strips exist in its write registry — subsequent reads of that key only
target chunks whose strips were actually written. The write path has its own
policy hook (``write_policy``, e.g. :class:`repro_torch.core.controller.FeedbackPolicy`
fed by the fused serving controller), closing the §III control loop: each
admission round encodes queued writes under the currently-adapted (n, k) via
:meth:`SharedKeyLayout.encode_files`'s chunk-level code.

Coding on BOTH directions of the hot path goes through the unified batched
codec engine, amortized per admission round (the coding-overhead Ψ cap of
FAST CLOUD §IV):

* writes — each round drains every queued write and encodes all same-layout
  payloads with ONE batched :meth:`SharedKeyLayout.encode_files` call;
* reads — completed reads accumulate (workers only collect chunks and hand
  the finished request to the admit loop) and each round reconstructs the
  whole accumulation with ONE batched :meth:`SharedKeyLayout.reconstruct_batch`
  call, per-item ``present`` masks carrying each request's own erasure
  pattern and chunk level through a single ``codec.decode``.

The admission *rule* (inject the next request's tasks only when the task
queue is drained and a thread idles) is unchanged — batching moves coding
off the per-request critical path, not the paper's queueing model. Callers
that want the raw chunks instead (e.g. the fused serving step in
:mod:`repro_torch.serve.engine`, which decodes inside its fused step) pass
``raw=True``; those requests skip proxy-side decode and return their
surviving chunks + indices in :attr:`RequestResult.chunks`.

Tracing (:func:`repro_torch.obs.tracing`, decided per request when it is
submitted, so a request begun while tracing is recorded whole): a
``proxy.pick`` instant per request (the backlog and idle connections the
policy was given, the (n, k) used), a ``proxy.task`` complete event per chunk
task (its connection time and outcome: ``used``, ``abandoned``, ``failed`` or
``skipped``), a ``proxy.read`` complete event per read (arrival to answer,
with its stages) and a ``proxy.decode`` complete event per batched decode
(its reads, and the operand shapes the codec hands its kernel). Events of
one request share its ``rid``.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue as _queue
import threading
import time
from collections import deque

import numpy as np

from repro_torch import obs
from repro_torch.coding import codec as codec_mod
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core.controller import Policy
from repro_torch.storage.backend import ObjectStore, StorageError


_log = logging.getLogger(__name__)

#: admit-loop wakeup marker: a completed read is waiting for batched decode.
_WAKE = object()


@dataclasses.dataclass
class RequestResult:
    key: str
    op: str
    n: int
    k: int
    ok: bool
    data: bytes | None
    t_arrival: float
    t_first_start: float
    t_done: float
    failures: int = 0
    #: raw reads only: surviving chunk index -> chunk bytes (data stays None)
    chunks: dict[int, bytes] | None = None
    #: reads: when the k-th chunk arrived (None where the read failed first),
    #: and when the batched decode that served it began (None for raw reads)
    t_kth: float | None = None
    t_decode: float | None = None

    @property
    def total_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def queueing_s(self) -> float:
        return self.t_first_start - self.t_arrival

    @property
    def service_s(self) -> float:
        return self.t_done - self.t_first_start


class _Request:
    def __init__(self, op, key, layout, payload, payload_len, n, k, cls_id, t_arrival,
                 raw=False, rid=None):
        self.op = op
        self.key = key
        self.layout: SharedKeyLayout = layout
        self.payload = payload
        self.payload_len = payload_len
        self.n = n
        self.k = k
        self.cls_id = cls_id
        self.raw = raw
        #: the request's id in the trace, or None when it is not traced
        self.rid = rid
        self.traced = rid is not None
        self.t_arrival = t_arrival
        self.t_first_start = None
        self.t_kth = None
        self.t_decode = None
        self.done = threading.Event()
        self.lock = threading.Lock()
        self.completed: dict[int, bytes] = {}
        self.failures = 0
        self.cancelled = False
        self.result: RequestResult | None = None
        self.coded: bytes | None = None  # write path: batch-encoded object
        self.n_issued = n  # tasks actually injected (registry may shrink it)
        self.settled = threading.Event()  # write path: all issued tasks resolved


class Proxy:
    """L-threaded proxy with TOFEC admission control."""

    def __init__(self, store: ObjectStore, policy: Policy, *, L: int = 16,
                 codec: codec_mod.Codec | None = None,
                 write_policy: Policy | None = None):
        self.store = store
        self.policy = policy
        #: optional separate policy for the write path (closed-loop feedback);
        #: None = writes share the read policy.
        self.write_policy = write_policy
        self.L = L
        self.codec = codec or codec_mod.get_codec()
        #: key -> set of strip ids known durable (adapted writes store a strip
        #: prefix; reads only target chunks whose strips are all present).
        self._written: dict[str, set[int]] = {}
        self._write_reqs: list[_Request] = []
        self._task_q: _queue.Queue = _queue.Queue()
        self._request_q: _queue.Queue = _queue.Queue()
        # Completed (non-raw) reads awaiting the admission round's ONE
        # batched reconstruct; fed by workers, drained by the admit loop.
        self._decode_q: _queue.Queue = _queue.Queue()
        self._idle = L
        # Requests the admit loop has drained but not yet injected: still
        # queued from the policy's point of view (TOFEC's q signal).
        self._admit_backlog = 0
        self._state_lock = threading.Lock()
        self._shutdown = False
        self._rids = itertools.count()
        self.results: list[RequestResult] = []
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"proxy-{i}")
            for i in range(L)
        ]
        self._admitter = threading.Thread(target=self._admit_loop, daemon=True)
        for t in self._threads:
            t.start()
        self._admitter.start()

    # -- public API ---------------------------------------------------------

    def read(self, key: str, layout: SharedKeyLayout, payload_len: int | None = None,
             cls_id: int = 0, timeout: float = 60.0, *, raw: bool = False) -> RequestResult:
        return self.wait(self.read_async(key, layout, payload_len, cls_id, raw=raw), timeout)

    def read_async(self, key: str, layout: SharedKeyLayout, payload_len: int | None = None,
                   cls_id: int = 0, *, raw: bool = False) -> _Request:
        """Submit a read without blocking; pair with :meth:`wait`.

        ``raw=True`` skips proxy-side decode: the result carries the
        surviving chunks + indices (for callers that decode in their own
        batched/fused step).
        """
        return self._submit("read", key, layout, None, payload_len, cls_id, raw=raw)

    @staticmethod
    def wait(req: _Request, timeout: float = 60.0) -> RequestResult:
        req.done.wait(timeout)
        if req.result is None:
            raise TimeoutError(f"{req.op} {req.key} timed out")
        return req.result

    def read_many(self, keys: list[str], layout: SharedKeyLayout,
                  payload_len: int | None = None, *, cls_id: int = 0,
                  raw: bool = False, timeout: float = 60.0) -> list[RequestResult]:
        """Batched fetch: submit every key up front, then collect.

        Submitting the whole round before waiting lets the policy see the
        true backlog (TOFEC's q signal) and lets the admit loop reconstruct
        the completions in batched decode calls instead of one per request.
        """
        with obs.span("proxy.read_many", keys=len(keys), raw=raw):
            reqs = [self.read_async(k, layout, payload_len, cls_id, raw=raw)
                    for k in keys]
            return [self.wait(r, timeout) for r in reqs]

    def write(self, key: str, layout: SharedKeyLayout, payload: bytes,
              cls_id: int = 0, timeout: float = 60.0) -> RequestResult:
        req = self.write_async(key, layout, payload, cls_id)
        req.done.wait(timeout)
        if req.result is None:
            raise TimeoutError(f"write {key} timed out")
        return req.result

    def write_async(self, key: str, layout: SharedKeyLayout, payload: bytes,
                    cls_id: int = 0) -> _Request:
        """Submit a write without blocking; pair with :meth:`wait`.

        The request completes (``done``) at k durable parts; the remaining
        uploads run in background and ``settled`` fires once the assembled
        object is readable (:meth:`flush_writes` waits for all of them).
        """
        return self._submit("write", key, layout, payload, len(payload), cls_id)

    def flush_writes(self, timeout: float = 60.0) -> None:
        """Drain the write path's background tasks (footnote 1).

        Blocks until every submitted write's issued uploads have resolved and
        the assembled coded object + its registry entry are visible to reads.
        """
        with self._state_lock:
            reqs, self._write_reqs = self._write_reqs, []
        deadline = time.monotonic() + timeout
        with obs.span("proxy.flush_writes", writes=len(reqs)):
            for r in reqs:
                if not r.settled.wait(max(deadline - time.monotonic(), 0.0)):
                    with self._state_lock:
                        self._write_reqs.extend(
                            rr for rr in reqs if not rr.settled.is_set())
                    raise TimeoutError(f"write {r.key} did not settle")

    def close(self):
        self._shutdown = True
        self._request_q.put(None)
        for _ in self._threads:
            self._task_q.put(None)

    # -- internals ----------------------------------------------------------

    def _submit(self, op, key, layout, payload, payload_len, cls_id, raw=False) -> _Request:
        t_arrival = time.monotonic()
        rid = next(self._rids) if obs.tracing() else None
        with self._state_lock:
            q_len = self._request_q.qsize() + self._admit_backlog
            idle = self._idle
        pol = self.write_policy if (op == "write" and self.write_policy is not None) \
            else self.policy
        n, k = pol.select(q=q_len, idle=idle, cls_id=cls_id, now=t_arrival)
        # Clamp to what the layout supports: k | K, n ≤ N/m.
        k = max(kk for kk in layout.supported_k() if kk <= k)
        n_max, _, _ = layout.code_for_k(k)
        n = max(k, min(n, n_max))
        if rid is not None:
            obs.instant("proxy.pick", rid=rid, op=op, q=q_len, idle=idle, n=n, k=k,
                        cls_id=cls_id)
        req = _Request(op, key, layout, payload, payload_len, n, k, cls_id, t_arrival,
                       raw=raw, rid=rid)
        if op == "write":
            with self._state_lock:
                self._write_reqs.append(req)
        self._request_q.put(req)
        return req

    def _admit_loop(self):
        pending: deque[_Request] = deque()
        while not self._shutdown:
            if not pending:
                req = self._request_q.get()
                if req is None:
                    break
                if req is _WAKE:  # a read completed while we were idle
                    self._flush_completed_reads()
                    continue
                pending.append(req)
            # Drain everything else that already arrived, then batch-encode
            # all queued writes (and batch-decode all completed reads) in one
            # codec call per layout class.
            while True:
                try:
                    req = self._request_q.get_nowait()
                except _queue.Empty:
                    break
                if req is None:
                    self._flush_completed_reads()
                    return
                if req is _WAKE:
                    continue
                pending.append(req)
            with self._state_lock:
                self._admit_backlog = len(pending)
            self._flush_completed_reads()
            self._encode_pending_writes(pending)
            req = pending.popleft()
            with self._state_lock:
                self._admit_backlog = len(pending)
            # Paper's admission rule: wait until the task queue is drained
            # and a thread is idle before injecting the next batch.
            while not self._shutdown:
                with self._state_lock:
                    ready = self._idle > 0 and self._task_q.empty()
                if ready:
                    break
                self._flush_completed_reads()  # decode while tasks drain
                time.sleep(1e-4)
            self._inject(req)
        self._flush_completed_reads()

    def _flush_completed_reads(self) -> None:
        """One batched reconstruct per layout group of completed reads.

        This is the read-side twin of :meth:`_encode_pending_writes`: all
        reads that finished since the last round — any mix of chunk levels
        and erasure patterns — decode in a single ``codec.decode`` per
        layout via per-item ``present`` masks.
        """
        reqs: list[_Request] = []
        while True:
            try:
                reqs.append(self._decode_q.get_nowait())
            except _queue.Empty:
                break
        if not reqs:
            return
        groups: dict[SharedKeyLayout, list[_Request]] = {}
        for r in reqs:
            groups.setdefault(r.layout, []).append(r)
        for lay, group in groups.items():
            t_decode = time.monotonic()
            for r in group:
                r.t_decode = t_decode
            self._decode_group(lay, group)
            rids = [r.rid for r in group if r.traced]
            if rids:
                mats, data = self.codec.matmul_shapes("dec", lay.N, lay.K, lay.strip_bytes,
                                                      len(group))
                obs.complete("proxy.decode", t_decode, time.monotonic(), reads=len(group),
                             rids=rids, bitmat=list(mats), data=list(data))

    def _decode_group(self, lay: SharedKeyLayout, group: list[_Request]) -> None:
        """Decode one layout's completed reads in one batched call and answer
        each."""
        try:
            datas = lay.reconstruct_batch(
                [(r.k, r.completed, r.payload_len) for r in group], codec=self.codec
            )
        except Exception as batch_err:
            # Torn batch (e.g. one malformed chunk): fall back to
            # per-request decode so one bad item can't wedge the rest.
            _log.warning("batched reconstruct failed (%s); retrying "
                         "per-request", batch_err)
            for r in group:
                try:
                    data = lay.reconstruct(r.k, r.completed, r.payload_len,
                                           codec=self.codec)
                    self._finish(r, True, data=data)
                except Exception:
                    _log.exception("reconstruct failed for read %r "
                                   "(k=%d, chunks=%s)", r.key, r.k,
                                   sorted(r.completed))
                    self._finish(r, False)
            return
        for r, data in zip(group, datas):
            self._finish(r, True, data=data)

    def _encode_pending_writes(self, pending: "deque[_Request]") -> None:
        """One batched encode per (layout, n, k) group of queued writes.

        Grouping by the adapted chunk-level code means each admission round's
        writes encode under whatever (n, k) the (possibly feedback-driven)
        write policy picked at submission — the closed-loop write path.
        """
        todo = [r for r in pending if r.op == "write" and r.coded is None]
        groups: dict[tuple[SharedKeyLayout, int, int], list[_Request]] = {}
        for r in todo:
            groups.setdefault((r.layout, r.n, r.k), []).append(r)
        for (lay, n, k), reqs in groups.items():
            with obs.span("proxy.encode_writes", n=n, k=k, writes=len(reqs)):
                coded = lay.encode_files([r.payload for r in reqs],
                                         codec=self.codec, n=n, k=k)
            for r, c in zip(reqs, coded):
                r.coded = c

    def _inject(self, req: _Request):
        if req.op == "read":
            n_max, _, m = req.layout.code_for_k(req.k)
            with self._state_lock:
                avail = self._written.get(req.key)
            if avail is None:
                cand = list(range(n_max))  # pre-coded object: all chunks exist
            else:
                # Proxy-written key: only chunks whose strips are all durable.
                cand = [ci for ci in range(n_max)
                        if all(s in avail for s in range(ci * m, (ci + 1) * m))]
            # Prefer spread of chunk indices across the object (diversity).
            order = np.random.default_rng(hash(req.key) & 0xFFFF).permutation(len(cand))
            issue = [cand[i] for i in order[: req.n]]
            req.n_issued = len(issue)
            if req.n_issued < req.k:
                with req.lock:
                    req.cancelled = True
                    self._finish(req, False)
                return
            for ci in issue:
                self._task_q.put((req, int(ci), None))
        else:
            coded = req.coded
            if coded is None:  # direct _inject callers outside the admit loop
                coded = req.layout.encode_file(req.payload, codec=self.codec,
                                               n=req.n, k=req.k)
            req.n_issued = req.n
            for ci in range(req.n):
                off, ln = req.layout.chunk_range(req.k, ci)
                self._task_q.put((req, int(ci), coded[off : off + ln]))

    def _worker(self):
        while True:
            item = self._task_q.get()
            if item is None:
                return
            req, ci, blob = item
            if req.cancelled:
                if req.traced:  # dropped before it started: no connection time
                    t = time.monotonic()
                    obs.complete("proxy.task", t, t, rid=req.rid, op=req.op, chunk=ci,
                                 outcome="skipped")
                continue
            with self._state_lock:
                self._idle -= 1
            t_start = time.monotonic() if req.traced or req.t_first_start is None else None
            if req.t_first_start is None:
                req.t_first_start = t_start
            try:
                if req.op == "read":
                    off, ln = req.layout.chunk_range(req.k, ci)
                    data = self.store.get_range(req.key, off, ln)
                else:
                    self.store.upload_part(req.key, ci, blob)
                    data = blob
                ok = True
            except StorageError:
                ok = False
            finally:
                t_end = time.monotonic() if req.traced else None
                with self._state_lock:
                    self._idle += 1
            outcome = self._on_task_done(req, ci, data if ok else None, ok)
            if req.traced:
                obs.complete("proxy.task", t_start, t_end, rid=req.rid, op=req.op, chunk=ci,
                             outcome=outcome)

    def _on_task_done(self, req: _Request, ci: int, data, ok: bool) -> str:
        """Count one finished task toward its request; returns the task's
        outcome: ``used`` (its chunk counted toward k, its part toward the
        write), ``abandoned`` (the read already had k chunks or had failed:
        the connection's time was spent for nothing) or ``failed``."""
        assemble = False
        with req.lock:
            if req.op == "read":
                if req.cancelled:
                    return "abandoned"
                if ok:
                    req.completed[ci] = data
                else:
                    req.failures += 1
                if len(req.completed) >= req.k:
                    req.t_kth = time.monotonic()
                    req.cancelled = True  # preemptive cancellation of the rest
                    if not req.raw:
                        # Hand off to the admit loop: the round's completions
                        # reconstruct together in one batched decode.
                        self._decode_q.put(req)
                        self._request_q.put(_WAKE)
                        if self._shutdown:
                            # The admit loop may already have done its final
                            # flush; decode inline so the waiter isn't stranded.
                            self._flush_completed_reads()
                    else:
                        self._finish(req, True)
                elif req.failures > req.n_issued - req.k:
                    req.cancelled = True
                    self._finish(req, False)
                return "used" if ok else "failed"
            # write: never cancelled — uploads past the k-th durable part run
            # as background tasks (footnote 1).
            if ok:
                req.completed[ci] = data
            else:
                req.failures += 1
            if req.result is None:
                if len(req.completed) >= req.k:
                    self._finish(req, True)
                elif req.failures > req.n_issued - req.k:
                    self._finish(req, False)
            if len(req.completed) + req.failures >= req.n_issued:
                assemble = True
        if assemble:
            self._finalize_write(req)
        return "used" if ok else "failed"

    def _finalize_write(self, req: _Request) -> None:
        """All issued uploads resolved: assemble the durable parts into the
        readable coded object and record its strips in the write registry.

        Failed chunks leave zero-filled holes; the registry keeps reads off
        them. Runs on the worker that resolved the last task (background —
        off the request's completion path).
        """
        with obs.span("proxy.finalize_write", key=req.key, n=req.n, k=req.k):
            self._finalize_write_inner(req)

    def _finalize_write_inner(self, req: _Request) -> None:
        try:
            _, _, m = req.layout.code_for_k(req.k)
            b = req.layout.strip_bytes
            if req.completed:
                obj = bytearray(req.n_issued * m * b)
                strips: set[int] = set()
                for ci, blob in req.completed.items():
                    off, ln = req.layout.chunk_range(req.k, ci)
                    obj[off:off + ln] = blob
                    strips.update(range(ci * m, (ci + 1) * m))
                try:
                    self.store.put(req.key, bytes(obj))
                    with self._state_lock:
                        self._written[req.key] = strips
                except StorageError:
                    _log.warning("write finalize failed for %r", req.key)
        finally:
            req.settled.set()

    def _finish(self, req: _Request, ok: bool, data: bytes | None = None):
        chunks = None
        if req.op == "read" and req.raw:
            # Raw reads surface whatever chunks arrived even on failure: a
            # partially-failed batch item carries its own per-item error mask
            # (ok=False) + partial data instead of wedging the whole batch.
            chunks = dict(req.completed)
        elif ok and req.op == "read" and data is None:
            # direct callers bypassing the admit loop
            data = req.layout.reconstruct(req.k, req.completed, req.payload_len,
                                          codec=self.codec)
        # writes: k parts durable → request complete; the remaining uploads
        # keep running in background (footnote 1) and _finalize_write
        # assembles the readable object once they all resolve.
        req.result = res = RequestResult(
            key=req.key,
            op=req.op,
            n=req.n,
            k=req.k,
            ok=ok,
            data=data,
            t_arrival=req.t_arrival,
            t_first_start=req.t_first_start or time.monotonic(),
            t_done=time.monotonic(),
            failures=req.failures,
            chunks=chunks,
            t_kth=req.t_kth,
            t_decode=req.t_decode,
        )
        if req.traced and req.op == "read":
            obs.complete("proxy.read", res.t_arrival, res.t_done, rid=req.rid, n=req.n,
                         k=req.k, ok=ok, raw=req.raw, **_stages_ms(res))
        self.results.append(req.result)
        req.done.set()


def _stages_ms(res: RequestResult) -> dict:
    """A read's life in stages that sum to ``total_s``, in ms: ``queue``
    (arrival to its first task's start), ``store`` (to its k-th chunk) and,
    where the proxy decoded it, ``decode_wait`` (to the start of the batched
    decode that served it) and ``decode`` (to its answer). A raw or failed
    read's ``store`` runs to its answer."""
    t0, t1 = res.t_arrival, res.t_first_start
    out = {"queue_ms": (t1 - t0) * 1e3}
    if res.t_decode is None or res.t_kth is None:
        out["store_ms"] = (res.t_done - t1) * 1e3
    else:
        out.update(store_ms=(res.t_kth - t1) * 1e3,
                   decode_wait_ms=(res.t_decode - res.t_kth) * 1e3,
                   decode_ms=(res.t_done - res.t_decode) * 1e3)
    return out


def store_coded_object(store: ObjectStore, key: str, layout: SharedKeyLayout, payload: bytes,
                       codec: codec_mod.Codec | None = None):
    """Pre-code and store a file for later proxy reads (paper: files are
    pre-coded with the (n_max, k) code and stored on the cloud). ``codec``
    defaults to :func:`repro_torch.coding.codec.get_codec`."""
    store.put(key, layout.encode_file(payload, codec=codec))
