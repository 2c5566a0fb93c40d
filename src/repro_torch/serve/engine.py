"""Batched serving engine with TOFEC-admitted prompt storage.

The port of the reference package's ``repro/serve/engine.py``. Flow per
request: the prompt blob is fetched from the object store through the TOFEC
proxy (erasure-coded ranged reads, adaptive (n, k) from the proxy backlog),
tokenized prompts are batched, prefilled, and decoded with the arch's cached
``decode_step``. The storage path is the paper's system; the LM path is the
substrate it feeds.

Three fetch paths:

* **unfused** — :meth:`ServingEngine.fetch_prompts` submits the whole round
  through :meth:`Proxy.read_many`; the proxy batch-decodes completions per
  admission round.
* **fused** — pass a :class:`FusedServingStep`: the proxy returns raw chunks
  (``raw=True``) and one call of :meth:`FusedServingStep.decode_batch` (or
  ``encode_batch``) runs the admission update and the batched codec work
  back to back on the device: the controller's carry stays there between
  rounds, and the codec's K1 launch follows the controller's update on the
  same stream. The controller is runtime data (:class:`ServeTables`):
  TOFEC, static, fixed-k (threshold form, same encodings as the fleet
  sweeps) and MPC (cost-model argmin,
  :func:`repro_torch.core.controller.mpc_step`) all run through one step,
  so swapping the policy swaps tensors.
* **closed loop** — :class:`ClosedLoopServer` extends the fused step with
  the LM prefill: admission update → batched decode (K1) → bytes→tokens →
  prefill run back to back on the device with no host round trip between
  them, and the controller's (n, k) pick is pushed into the proxy's write
  policy (:class:`repro_torch.core.controller.FeedbackPolicy`) so the next
  admission round's queued writes encode under the adapted code. This is
  the paper's §III loop closed end to end.

Shapes are bucketed exactly like :mod:`repro_torch.coding.codec` (powers of
two on batch / parity rows / strip width), and the per-item decode matrices
are runtime inputs built host-side from the cached Cauchy tables;
``stats.traces`` counts the first use of each shape bucket, which keeps the
reference's bound on buckets visible (asserted in the tests).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.coding import codec as codec_mod
from repro_torch.coding import rs
from repro_torch.coding.layout import SharedKeyLayout
from repro_torch.core.controller import (
    FeedbackPolicy,
    MPCTables,
    TofecTables,
    _f32,
    _to,
    mpc_step,
    mpc_tables,
    tofec_threshold_step,
)
from repro_torch.core.delay_model import RequestClass
from repro_torch.core.static_optimizer import build_class_plan
from repro_torch.models.registry import Arch
from repro_torch.storage.proxy import Proxy, store_coded_object
from repro_torch.tree import tree_leaves, tree_map

#: ServeTables.pol ids: threshold-table controllers (tofec / static / fixedk)
#: vs the MPC cost-model argmin.
POL_THRESH = 0
POL_MPC = 1


@dataclasses.dataclass(frozen=True)
class ServeTables:
    """The serving controller as pure runtime data (one request class).

    Every field is a device tensor, so the four policies (TOFEC / static /
    fixed-k in threshold form + MPC) share one step: ``pol`` selects the lane
    inside it. Threshold encodings follow the fleet sweep convention (BIG
    sentinel, inert trailing zeros); the MPC lane rides in
    :class:`repro_torch.core.controller.MPCTables`.
    """

    pol: torch.Tensor  # () int32: POL_THRESH | POL_MPC
    h_k: torch.Tensor  # (k_max + 1,) float32 thresholds (zeros on the MPC lane)
    h_n: torch.Tensor  # (n_max + 1,) float32
    r_max: torch.Tensor  # () float32
    alpha: torch.Tensor  # () float32 backlog-EWMA memory (threshold lane)
    mpc: MPCTables

    @classmethod
    def from_tofec(cls, tables: TofecTables, *, alpha: float = 0.99) -> "ServeTables":
        dev = tables.h_k.device
        return cls(
            pol=torch.tensor(POL_THRESH, dtype=torch.int32, device=dev),
            h_k=tables.h_k.to(torch.float32),
            h_n=tables.h_n.to(torch.float32),
            r_max=_f32(tables.r_max, dev),
            alpha=_f32(alpha, dev),
            mpc=MPCTables.trivial(dev),
        )

    def to(self, device) -> "ServeTables":
        return dataclasses.replace(_to(self, device), mpc=self.mpc.to(device))


def serve_tables_from_arrays(arrays: dict, device) -> ServeTables:
    """Build :class:`ServeTables` from the reference's ``ServeTables``
    leaves converted with ``np.asarray``: keys ``pol``, ``h_k``, ``h_n``,
    ``r_max``, ``alpha``, and ``mpc``, a dict of the ``MPCTables`` fields.
    This is how the two packages run the same controller on the same state.
    """
    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    mpc = MPCTables(**{f.name: t(arrays["mpc"][f.name])
                       for f in dataclasses.fields(MPCTables)})
    return ServeTables(pol=t(arrays["pol"]).to(torch.int32), h_k=t(arrays["h_k"]),
                       h_n=t(arrays["h_n"]), r_max=t(arrays["r_max"]),
                       alpha=t(arrays["alpha"]), mpc=mpc)


def carry_from_arrays(arrays, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (q_ewma, mean_ia, has_rate) carry from three numpy scalars."""
    q_ewma, mean_ia, has_rate = (_f32(float(a), device) for a in arrays)
    return q_ewma, mean_ia, has_rate


def serve_policy_step(
    carry: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    q,
    dt,
    tables: ServeTables,
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One admission update with the policy as runtime data.

    Carry = (q_ewma, mean_ia, has_rate) 0-d float32 tensors, initialized to
    (-1.0, 0.0, 0.0): ``q_ewma < 0`` is the cold-start sentinel (the first
    observation seeds the EWMA) and the rate pair only advances on
    ``dt ≥ 0`` (see :func:`repro_torch.core.controller.mpc_step`). Both lanes
    are evaluated and ``tables.pol`` selects.
    """
    q_ewma, mean_ia, has_rate = carry
    q = _f32(q, q_ewma.device)
    dt = _f32(dt, q_ewma.device)
    q_thr, n_thr, k_thr = tofec_threshold_step(
        q_ewma, q, tables.h_k, tables.h_n, tables.r_max, tables.alpha
    )
    (q_mpc, mean_ia, has_rate), n_mpc, k_mpc = mpc_step(
        (q_ewma, mean_ia, has_rate), q, dt, tables.mpc
    )
    is_mpc = tables.pol == POL_MPC
    carry = (torch.where(is_mpc, q_mpc, q_thr), mean_ia, has_rate)
    n = torch.where(is_mpc, n_mpc, n_thr)
    k = torch.where(is_mpc, k_mpc, k_thr)
    return carry, n, k


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Declarative serving controller: tofec | static | fixedk | mpc.

    :meth:`tables` resolves it to :class:`ServeTables` for one request
    class; all four kinds produce identically-shaped tables for the same
    class, so a live policy swap (``FusedServingStep.set_policy``) adds no
    shape bucket.
    """

    kind: str
    n: int = 0
    k: int = 0
    alpha: float = 0.99
    eq7_factor: float = 2.0
    alpha_rate: float = 0.05
    util_cap: float = 0.9
    q_guard: float = 4.0
    alpha_q: float = 0.1

    @classmethod
    def tofec(cls, alpha: float = 0.99, eq7_factor: float = 2.0) -> "ServePolicy":
        return cls("tofec", alpha=alpha, eq7_factor=eq7_factor)

    @classmethod
    def static(cls, n: int, k: int) -> "ServePolicy":
        return cls("static", n=n, k=k)

    @classmethod
    def fixedk(cls, k: int, eq7_factor: float = 2.0) -> "ServePolicy":
        return cls("fixedk", k=k, eq7_factor=eq7_factor)

    @classmethod
    def mpc(cls, *, alpha_rate: float = 0.05, util_cap: float = 0.9,
            q_guard: float = 4.0, alpha_q: float = 0.1) -> "ServePolicy":
        return cls("mpc", alpha_rate=alpha_rate, util_cap=util_cap,
                   q_guard=q_guard, alpha_q=alpha_q)

    def tables(self, request_class: RequestClass, L: int, device=None) -> ServeTables:
        """The tables on ``device`` (default ``cuda``)."""
        # The MPC lane is always populated (shape-stable swaps); threshold
        # kinds just never select it.
        mpc_t = mpc_tables(
            request_class, L, alpha_rate=self.alpha_rate, util_cap=self.util_cap,
            q_guard=self.q_guard, alpha_q=self.alpha_q, device=device,
        )
        dev = mpc_t.u.device
        if self.kind == "mpc":
            h_k = np.zeros(request_class.k_max + 1, np.float32)
            h_n = np.zeros(request_class.n_max + 1, np.float32)
            r_max = request_class.r_max
            pol = POL_MPC
        else:
            from repro_torch.fleet.sweep import PolicySpec, policy_tables

            spec = PolicySpec(self.kind, n=self.n, k=self.k, alpha=self.alpha,
                              eq7_factor=self.eq7_factor)
            h_k, h_n, r_max = policy_tables(spec, request_class, L)
            pol = POL_THRESH
        return ServeTables(
            pol=torch.tensor(pol, dtype=torch.int32, device=dev),
            h_k=_f32(h_k, dev),
            h_n=_f32(h_n, dev),
            r_max=_f32(r_max, dev),
            alpha=_f32(self.alpha, dev),
            mpc=mpc_t,
        )


def _device_codec(codec: codec_mod.Codec | None) -> codec_mod.Codec:
    """``codec`` (default :func:`get_codec`), refused if it is host-only."""
    codec = codec or codec_mod.get_codec()
    if not codec.backend.on_device:
        env = os.environ.get("REPRO_TORCH_CODEC_BACKEND")
        raise ValueError(
            f"codec backend {codec.name!r} is host-only: the fused serving step "
            "keeps the controller and the codec work on the device and needs the "
            "kernel or torch backend. Fix: set REPRO_TORCH_CODEC_BACKEND=kernel "
            "(or =torch) in the environment, or pass codec=Codec('kernel', "
            f"device=...) explicitly (REPRO_TORCH_CODEC_BACKEND is currently {env!r})."
        )
    return codec


class _BucketStats:
    """``stats`` (a :class:`obs.CompileStats`) whose ``traces`` counts the
    first use of each shape bucket; ``.traces`` is the public pin."""

    def __init__(self, label: str):
        self.stats = obs.CompileStats(label=label)
        self._seen: set[tuple] = set()
        self._lock = threading.Lock()

    @property
    def traces(self) -> int:
        return self.stats.traces

    def _note_bucket(self, key: tuple) -> None:
        with self._lock:
            if key not in self._seen:
                self._seen.add(key)
                self.stats.traces += 1


class FusedServingStep(_BucketStats):
    """One step per serving round: admission update + batched MDS codec work
    (encode or decode), back to back on the device.

    State: the controller carry (q̄ backlog EWMA + the MPC rate pair) lives
    on the device and is threaded through successive calls. Each call
    returns the payloads and the (n, k) the controller picks for the next
    round.

    Matrices are runtime inputs: decode matrices come from
    :meth:`Codec.decode_mats` (host-cached per erasure pattern), parity
    matrices from the cached Cauchy generator, both padded to the shape
    bucket and run through ``backend.prep_mats``; the controller is runtime
    data too (:class:`ServeTables`) — so changing the code, the erasure
    pattern or the policy never adds a shape bucket.
    """

    def __init__(self, tables: TofecTables | ServeTables, *,
                 codec: codec_mod.Codec | None = None, alpha: float = 0.99):
        self.codec = _device_codec(codec)
        self.device = self.codec.device
        if isinstance(tables, TofecTables):
            tables = ServeTables.from_tofec(tables.to(self.device), alpha=alpha)
        self.tables = tables.to(self.device)
        self.alpha = alpha
        super().__init__("serve.FusedServingStep")
        self.reset()

    @classmethod
    def for_class(cls, request_class, L: int, *, codec: codec_mod.Codec | None = None,
                  alpha: float = 0.99, eq7_factor: float = 2.0) -> "FusedServingStep":
        codec = _device_codec(codec)
        plan = build_class_plan(request_class, L, eq7_factor=eq7_factor)
        return cls(TofecTables.from_plan(plan, device=codec.device), codec=codec, alpha=alpha)

    @classmethod
    def for_policy(cls, policy: ServePolicy, request_class, L: int, *,
                   codec: codec_mod.Codec | None = None) -> "FusedServingStep":
        codec = _device_codec(codec)
        return cls(policy.tables(request_class, L, device=codec.device), codec=codec,
                   alpha=policy.alpha)

    def reset(self) -> None:
        # (q_ewma, mean_ia, has_rate); -1.0 = cold-start sentinel.
        self.carry = tuple(_f32(v, self.device) for v in (-1.0, 0.0, 0.0))

    @property
    def q_ewma(self) -> torch.Tensor:
        return self.carry[0]

    def set_policy(self, tables: ServeTables) -> None:
        """Swap the controller live. Same table shapes → no new bucket."""
        self.tables = tables.to(self.device)

    def _admit(self, q, dt) -> tuple[torch.Tensor, torch.Tensor]:
        self.carry, n_nxt, k_nxt = serve_policy_step(self.carry, q, dt, self.tables)
        return n_nxt, k_nxt

    def _upload(self, arr):
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device, torch.uint8), True
        return torch.from_numpy(np.ascontiguousarray(arr, np.uint8)).to(self.device), False

    # -- fused entry points ----------------------------------------------------

    def decode_on_device(self, rows: torch.Tensor, present, *, n: int, k: int, q: float,
                         dt: float = -1.0):
        """Admission update + batched reconstruct of (batch, k, B) rows
        already on the device, with no host sync: returns the bucket-padded
        decoded data, the picked (n, k) as 0-d device tensors, and the
        bucket key. Counts nothing; :meth:`decode_batch` and the closed loop
        do."""
        batch = rows.shape[0]
        present = codec_mod._host_present(present, batch, k)
        mats = self.codec.decode_mats(present, n, k)
        mats_p, rows_p, key = self.codec.pad_to_bucket("dec", mats, rows, n, k)
        backend = self.codec.backend
        with obs.span("serve.decode_batch", bucket=str(key), batch=batch):
            prepped = backend.prep_mats(mats_p)
            n_nxt, k_nxt = self._admit(q, dt)
            out = backend.matmul_prepped(prepped, rows_p)
        return out, n_nxt, k_nxt, key

    def decode_batch(self, rows, present, *, n: int, k: int, q: float,
                     dt: float = -1.0):
        """Admission update + batched reconstruct, back to back on the device.

        rows: (batch, k, B) surviving strips (numpy, or a tensor that then
        stays on the device); present: (batch, k) strip ids (or a shared (k,)
        pattern); q: the round's backlog signal; dt: the interarrival seconds
        feeding the MPC rate estimator (< 0 = unknown; threshold policies
        ignore it). Returns ((batch, k, B) decoded data, (n, k) for the next
        round).
        """
        rows, is_tensor = self._upload(rows)
        single = rows.ndim == 2
        if single:
            rows = rows[None]
        batch, _, B = rows.shape
        out, n_nxt, k_nxt, key = self.decode_on_device(rows, present, n=n, k=k, q=q, dt=dt)
        self._note_bucket(key)
        self.stats.launches += 1
        data = out[:batch, :k, :B]
        if not is_tensor:
            data = data.cpu().numpy()
        return (data[0] if single else data), (int(n_nxt), int(k_nxt))

    def encode_batch(self, data, *, n: int, k: int, q: float, dt: float = -1.0):
        """Admission update + batched systematic encode, back to back.

        data: (batch, k, B) → ((batch, n, B) coded strips, next (n, k)).
        """
        data, is_tensor = self._upload(data)
        single = data.ndim == 2
        if single:
            data = data[None]
        batch, _, B = data.shape
        if n == k:  # no parity: admission update only, data passes through
            self._note_bucket(("adm",))
            n_nxt, k_nxt = self._admit(q, dt)
            self.stats.launches += 1
            coded = data
        else:
            par = rs.cauchy_parity_matrix(n, k)
            mats = np.broadcast_to(par, (batch, n - k, k))
            mats_p, data_p, key = self.codec.pad_to_bucket("enc", mats, data, n, k)
            self._note_bucket(key)
            backend = self.codec.backend
            with obs.span("serve.encode_batch", bucket=str(key), batch=batch):
                prepped = backend.prep_mats(mats_p)
                n_nxt, k_nxt = self._admit(q, dt)
                parity = backend.matmul_prepped(prepped, data_p)
            self.stats.launches += 1
            coded = torch.cat([data, parity[:batch, : n - k, :B]], dim=1)
        if not is_tensor:
            coded = coded.cpu().numpy()
        return (coded[0] if single else coded), (int(n_nxt), int(k_nxt))


def tokens_from_strips(data: torch.Tensor, k: int, strip_bytes: int,
                       prompt_len: int) -> torch.Tensor:
    """Bytes→tokens on the device: (batch, ≥k, ≥strip_bytes) decoded uint8
    strips → (batch, prompt_len) int32, little-endian 4-byte words.

    The slice order matters: padding must come OFF before the flatten
    (slicing after would interleave pad bytes into the token stream). The
    words combine in int32, as the reference's do, so a high byte ≥ 128
    gives a negative id (which the closed loop's clip sends to 0).
    """
    flat = data[:, :k, :strip_bytes].reshape(data.shape[0], k * strip_bytes)
    by = flat[:, : prompt_len * 4].reshape(-1, prompt_len, 4).to(torch.int32)
    return by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16) | (by[..., 3] << 24)


#: How many times :meth:`ServingEngine.fetch_prompts` resubmits reads that
#: failed.
FETCH_RETRIES = 3


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (B, steps) generated ids
    storage_total_s: list[float]  # per-request proxy read delays
    codes: list[tuple[int, int]]  # (n, k) used per prompt fetch
    next_code: tuple[int, int] | None = None  # fused path: controller's pick


def greedy_step(arch: Arch, params, state: dict) -> torch.Tensor:
    """One greedy decode step on the static buffers ``state``: a cache of
    the arch's ``init_cache`` layout plus ``"tok"``, the (B, 1) int32 token.
    The step reads the token and ``pos`` there and writes everything back
    in place: the family's decode step advances the cache's own recurrent
    states and KV ring, the argmax goes into ``"tok"``, and ``pos`` is
    advanced. Returns the step's (B, 1, V) logits.

    This is the function :class:`DecodeBucket` captures as a CUDA graph;
    the arch's family must declare its decode step safe to capture
    (``CUDA_GRAPH_DECODE``)."""
    cache = {k: v for k, v in state.items() if k != "tok"}
    logits, _ = arch.decode_step(params, state["tok"], cache)
    state["tok"].copy_(torch.argmax(logits, dim=-1))
    state["pos"].add_(1)
    return logits


class DecodeBucket:
    """Static buffers for greedy decode at one bucket (padded batch, KV
    slots), and on a card the CUDA graph of one :func:`greedy_step` over
    them.

    :meth:`load` copies a round's token and cache in; each :meth:`step`
    then advances the buffers by one token, replaying the graph where one
    was captured and running :func:`greedy_step` eagerly otherwise."""

    #: greedy steps run on a side stream before the capture (cuBLAS and
    #: the allocator set up outside the graph)
    WARMUP = 2

    @torch.inference_mode()
    def __init__(self, arch: Arch, params, tok: torch.Tensor, cache):
        self.arch, self.params = arch, params
        self.state = tree_map(torch.clone, {**cache, "tok": tok})
        self.graph: torch.cuda.CUDAGraph | None = None
        self.logits: torch.Tensor | None = None

    @staticmethod
    def key(tok: torch.Tensor, cache) -> tuple:
        """The bucket of a round: the shape and dtype of every leaf of its
        token and cache, the padded batch and the KV ring's slots among them."""
        return tuple((tuple(t.shape), t.dtype) for t in tree_leaves({**cache, "tok": tok}))

    @torch.inference_mode()
    def load(self, tok: torch.Tensor, cache) -> None:
        """Copy a round's token and prefill cache into the static buffers."""
        for dst, src in zip(tree_leaves(self.state), tree_leaves({**cache, "tok": tok}),
                            strict=True):
            dst.copy_(src)

    @torch.inference_mode()
    def step(self) -> torch.Tensor:
        """One greedy step; the logits (the graph's static output on a card:
        the next step overwrites them)."""
        if self.graph is None:
            self.logits = greedy_step(self.arch, self.params, self.state)
        else:
            self.graph.replay()
        return self.logits

    @torch.inference_mode()
    def capture(self, pool) -> None:
        """Warm up on a side stream, then capture one step into ``pool``.
        Both run on the buffers as they are; :meth:`load` the round after.
        Raises ``RuntimeError`` where the capture fails: there is no eager
        fallback on a card."""
        device = self.state["tok"].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                greedy_step(self.arch, self.params, self.state)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the proxy's threads may use the card meanwhile
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                logits = greedy_step(self.arch, self.params, self.state)
        except RuntimeError as e:
            raise RuntimeError(f"{self.arch.name}: capturing the decode step at batch "
                               f"{self.state['tok'].shape[0]} failed") from e
        self.graph, self.logits = graph, logits


class ServingEngine:
    """Prefill + greedy cached decode of an :class:`Arch` on the device its
    parameters lie on.

    On a card, an arch whose family declares its decode step safe to
    capture (``CUDA_GRAPH_DECODE``, the hybrid family) decodes from CUDA
    graphs: one :class:`DecodeBucket` per bucket, captured at its first
    decode, all in one graph memory pool; each step is one replay. Every
    other family, and every family on the CPU, runs the eager loop.
    ``captures``, ``graph_replays`` and ``eager_steps`` count them."""

    def __init__(self, arch: Arch, params, *, max_seq: int = 128):
        self.arch = arch
        self.params = params
        self.max_seq = max_seq
        self.device = params["embedding"]["embed"].device
        self.uses_graphs = (self.device.type == "cuda"
                            and bool(getattr(arch.module, "CUDA_GRAPH_DECODE", False)))
        self._buckets: dict[tuple, DecodeBucket] = {}
        self._pool = None
        self.captures = 0
        self.graph_replays = 0
        self.eager_steps = 0
        #: for a cache with ``"counters"`` (the family's ``COUNTERS``), the
        #: last :meth:`continue_greedy`'s (counts after the prefill, counts
        #: after the decode steps), on the device
        self.counters: tuple[torch.Tensor, torch.Tensor] | None = None

    # -- storage integration -------------------------------------------------

    @staticmethod
    def store_prompt(store, key: str, layout: SharedKeyLayout, tokens: np.ndarray, *,
                     codec: codec_mod.Codec | None = None):
        store_coded_object(store, key, layout, np.asarray(tokens).astype(np.int32).tobytes(),
                           codec=codec)

    def fetch_prompts(
        self, proxy: Proxy, layout: SharedKeyLayout, keys: list[str], prompt_len: int,
        *, fused: FusedServingStep | None = None,
    ) -> tuple[np.ndarray, list[float], list[tuple[int, int]], tuple[int, int] | None]:
        """Batched prompt fetch: the whole round is submitted up front (the
        proxy's policy sees it as backlog) and reconstructed batched — by the
        proxy's admission round (unfused) or by ``fused``'s admission+decode
        step (raw chunks in, payloads out).

        Reads that exhaust their n − k failure budget (the backlog-adapted
        code can be as lean as (1, 1)) are resubmitted up to
        :data:`FETCH_RETRIES` times; the retry round is smaller, so the
        policy re-picks with more redundancy. Reported delays accumulate across attempts (what the
        client actually waited); codes report the attempt that served."""
        payload_len = prompt_len * 4
        raw = fused is not None
        results = proxy.read_many(keys, layout, payload_len, raw=raw)
        failed_s = [0.0] * len(keys)
        for _ in range(FETCH_RETRIES):
            bad_idx = [i for i, r in enumerate(results) if not r.ok]
            if not bad_idx:
                break
            for i in bad_idx:
                failed_s[i] += results[i].total_s
            redo = proxy.read_many([keys[i] for i in bad_idx], layout, payload_len, raw=raw)
            for i, r in zip(bad_idx, redo):
                results[i] = r
        bad = [k for k, r in zip(keys, results) if not r.ok]
        if bad:
            raise RuntimeError(f"prompt fetch failed for {', '.join(bad)}")
        delays = [r.total_s + extra for r, extra in zip(results, failed_s)]
        codes = [(r.n, r.k) for r in results]
        if fused is None:
            toks = [np.frombuffer(r.data, np.int32) for r in results]
            return np.stack(toks), delays, codes, None
        rows, present = layout.gather_rows_batch([(r.k, r.chunks) for r in results])
        data, next_code = fused.decode_batch(rows, present, n=layout.N, k=layout.K,
                                             q=len(keys))
        toks = [np.frombuffer(data[i].reshape(-1)[:payload_len].tobytes(), np.int32)
                for i in range(len(results))]
        return np.stack(toks), delays, codes, next_code

    # -- generation -----------------------------------------------------------

    def continue_greedy(self, logits: torch.Tensor, cache, steps: int) -> torch.Tensor:
        """Greedy generation from prefill's (logits, cache): (B, steps) int32
        ids, left on the device (no host sync); the decode steps replay the
        round's bucket where the engine uses graphs (see the class)."""
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok[:, 0]]
        prefill_counts = cache["counters"].clone() if "counters" in cache else None
        # steps - 1 decode steps: the reference's last decode is never read
        if self.uses_graphs and steps > 1:
            bucket = self.decode_bucket(tok, cache)
            bucket.load(tok, cache)
            for _ in range(steps - 1):
                bucket.step()
                out.append(bucket.state["tok"][:, 0].clone())
            self.graph_replays += steps - 1
            cache = bucket.state
        else:
            for _ in range(steps - 1):
                logits, cache = self.arch.decode_step(self.params, tok, cache)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                out.append(tok[:, 0])
            self.eager_steps += max(steps - 1, 0)
        if prefill_counts is not None:
            self.counters = (prefill_counts, cache["counters"])
        return torch.stack(out, dim=1)

    def decode_bucket(self, tok: torch.Tensor, cache) -> DecodeBucket:
        """The round's bucket, captured on its first use."""
        key = DecodeBucket.key(tok, cache)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = DecodeBucket(self.arch, self.params, tok, cache)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            bucket.capture(self._pool)
            self._buckets[key] = bucket
            self.captures += 1
        return bucket

    def generate(self, prompts: np.ndarray, steps: int) -> np.ndarray:
        """prompts: (B, S) int32 → (B, steps) greedily generated ids. The vlm
        family sees an all-zero patch grid and encdec all-zero frames, as
        the reference's ``generate`` gives them."""
        tokens = torch.from_numpy(np.asarray(prompts, np.int32)).to(self.device)
        logits, cache = self.arch.prefill_tokens(self.params, tokens, max_seq=self.max_seq)
        return self.continue_greedy(logits, cache, steps).cpu().numpy()

    def serve(
        self,
        proxy: Proxy,
        layout: SharedKeyLayout,
        keys: list[str],
        *,
        prompt_len: int,
        steps: int,
        fused: FusedServingStep | None = None,
    ) -> ServeResult:
        prompts, delays, codes, next_code = self.fetch_prompts(
            proxy, layout, keys, prompt_len, fused=fused
        )
        gen = self.generate(prompts, steps)
        return ServeResult(tokens=gen, storage_total_s=delays, codes=codes,
                           next_code=next_code)


@dataclasses.dataclass
class ClosedLoopResult:
    tokens: np.ndarray  # (G, steps) generated ids, one row per SERVED key
    ok: list[bool]  # per input key: did its read survive (per-item mask)
    served_keys: list[str]  # keys in tokens' row order (the ok subset)
    codes: list[tuple[int, int]]  # read (n, k) per served key
    next_code: tuple[int, int]  # controller's pick, pushed to the write policy
    storage_total_s: list[float]  # proxy read delays per served key
    #: the round's phases in ms: "fetch" (proxy reads + row gather, host
    #: clock), "launch" (rows upload + admission + decode + prefill) and
    #: "generate" (the decode loop), the last two on the device's stream
    #: clock on a card (CUDA events), the host clock on the CPU; for a
    #: family whose prefill takes marks, also "launch.<kind>", its prefill's
    #: layers of each kind.
    phase_ms: dict[str, float] = dataclasses.field(default_factory=dict)


class ClosedLoopServer(_BucketStats):
    """The paper's proxy as a CLOSED loop, one device step per round.

    Each :meth:`serve_round`:

    1. fetches the round's prompts through the proxy (``raw=True`` — chunks
       only, per-item error masks; a partially-failed item drops out of the
       round instead of wedging it),
    2. runs admission update (policy as runtime data,
       :func:`serve_policy_step`) → batched MDS decode (K1) → bytes→tokens →
       LM prefill back to back on the device, with no host round trip
       between those stages (the first two are
       :meth:`FusedServingStep.decode_on_device`),
    3. finishes generation with the engine's cached ``decode_step``,
    4. pushes the controller's (n, k) into the proxy's write policy when it
       is a :class:`repro_torch.core.controller.FeedbackPolicy`, so writes
       queued for the next admission round encode under the adapted code.
       (The pick is read back after generation, which forces the device
       work anyway, so the round never stalls on a mid-round sync.)

    The backlog signal is the round's request count. ``stats.traces``
    counts the first use of each shape bucket: the codec's decode bucket
    extended with (prompt_len, strip_bytes), the prefill's shape inputs;
    and each decode bucket the engine captures as a CUDA graph in a round.
    The ``serve.generate`` span is tagged with the round's decode steps
    replayed from a graph (``graph_replays``) and run eagerly
    (``eager_steps``). For a family whose prefill takes marks
    (``PREFILL_MARKS``), the ``serve.launch`` span is tagged with the
    prefill's device ms by layer kind (``<kind>_ms``); for
    a cache with counters, while tracing, each of the two spans with its
    phase's counts (the family's ``COUNTERS``), read after the round's own
    sync.
    Batch varies within pow2 buckets; prefill and decode run at the padded
    batch and rows are cut to the served subset at the end.

    With ``REPRO_OBS`` on, each round also updates the device telemetry
    (:attr:`metrics`, :attr:`timeline`) and the host :attr:`flight` ring,
    with no host sync; the round's tokens and pick are the same either way.
    Telemetry collection is the last field of the bucket key.
    """

    #: fixed bucket counts for the round histograms (values clip into the
    #: last bucket); one buffer shape per server.
    _Q_BINS = 64

    #: Timeline ring capacity: the last _TL_CAP rounds stay resident; older
    #: slots are overwritten in ring order (snapshot restores oldest-first).
    _TL_CAP = 256

    def __init__(self, engine: ServingEngine, proxy: Proxy, layout: SharedKeyLayout,
                 step: FusedServingStep, *, prompt_len: int):
        if prompt_len * 4 > layout.file_bytes:
            raise ValueError(
                f"prompt_len {prompt_len} needs {prompt_len * 4} bytes but the "
                f"layout holds {layout.file_bytes}"
            )
        if engine.device != step.device:
            raise ValueError(f"the engine's parameters are on {engine.device}, the fused "
                             f"step's codec on {step.device}")
        self.engine = engine
        self.proxy = proxy
        self.layout = layout
        self.step = step
        self.prompt_len = prompt_len
        pol = proxy.write_policy
        self.write_policy = pol if isinstance(pol, FeedbackPolicy) else None
        super().__init__("serve.ClosedLoopServer")
        self._last_now: float | None = None
        self._mbuf = None  # device MetricsBuf, created on the first collected round
        self._tlbuf = None  # device TimelineBuf ring, same lifecycle as _mbuf
        self._flight = None  # host FlightRing, same lifecycle as _mbuf

    @property
    def metrics(self):
        """The device :class:`repro_torch.obs.MetricsBuf` accumulated across
        collected rounds — round, request, served and decode-error counters,
        q / batch / pick histograms, the backlog high-water mark (None until
        a round runs with REPRO_OBS=1). ``.snapshot()`` is the host sync."""
        return self._mbuf

    @property
    def timeline(self):
        """The device :class:`repro_torch.obs.TimelineBuf` ring of per-round
        samples — arrival rate ``lam``, ``backlog`` signal, the controller's
        ``pick_n``/``pick_k``, ``served`` count and the round's ``delay``
        histogram delta. None until a round runs with REPRO_OBS=1; the last
        :data:`_TL_CAP` rounds are retained. ``.snapshot()`` is the host
        sync."""
        return self._tlbuf

    @property
    def flight(self):
        """The host :class:`repro_torch.obs.FlightRing` of per-round phase
        breakdowns (admit → decode → generate on the compacted round clock).
        None until a round runs with REPRO_OBS=1; the last :data:`_TL_CAP`
        rounds are retained, matching the timeline ring."""
        return self._flight

    def put(self, key: str, payload: bytes, cls_id: int = 0):
        """Queue a write through the proxy (encodes under the fed-back code
        at the next admission round). Returns the async request handle."""
        return self.proxy.write_async(key, self.layout, payload, cls_id)

    def _zero_bufs(self, device: torch.device) -> None:
        self._mbuf = obs.MetricsBuf.zeros(
            counters=("serve_rounds", "serve_requested", "serve_served",
                      "serve_decode_errors"),
            hists={"serve_q": self._Q_BINS, "serve_batch": self._Q_BINS,
                   "serve_pick_n": obs.PICK_BINS, "serve_pick_k": obs.PICK_BINS},
            highs=("serve_q_hi",), device=device)
        self._tlbuf = obs.TimelineBuf.zeros(
            self._TL_CAP, series=("lam", "backlog", "pick_n", "pick_k", "served"),
            hists={"delay": obs.DELAY_BINS}, device=device)
        self._flight = obs.FlightRing(self._TL_CAP, label="serve")

    def _collect(self, *, q: float, dt: float, n_nxt: torch.Tensor, k_nxt: torch.Tensor,
                 requested: int, delays: torch.Tensor) -> None:
        """One round's device telemetry: the counters, histograms and one
        timeline slot, from host numbers and device tensors (the pick and the
        served reads' delays, already on the device), with no host sync."""
        served = int(delays.shape[0])
        self._mbuf = (self._mbuf.count("serve_rounds", 1)
                      .count("serve_requested", requested)
                      .count("serve_served", served)
                      .count("serve_decode_errors", requested - served)
                      .observe("serve_q", q)
                      .observe("serve_pick_n", n_nxt)
                      .observe("serve_pick_k", k_nxt)
                      .observe("serve_batch", served)
                      .high("serve_q_hi", q))
        # The reference's float32 rate: served / max(dt, 1e-9), 0 without a
        # previous round.
        lam = (np.float32(served) / np.maximum(np.float32(dt), np.float32(1e-9))
               if dt > 0 else 0.0)
        self._tlbuf = self._tlbuf.append(
            {"lam": float(lam), "backlog": q, "pick_n": n_nxt, "pick_k": k_nxt,
             "served": served},
            {"delay": (obs.delay_bucket(delays), 1)},
        )

    def serve_round(self, keys: list[str], *, steps: int) -> ClosedLoopResult:
        """One closed-loop serving round over ``keys``; see class docstring."""
        with obs.span("serve.round", keys=len(keys), steps=steps):
            return self._serve_round(keys, steps=steps)

    def _serve_round(self, keys: list[str], *, steps: int) -> ClosedLoopResult:
        payload_len = self.prompt_len * 4
        collect = obs.enabled()
        t0 = time.perf_counter()
        with obs.span("serve.fetch", keys=len(keys)):
            results = self.proxy.read_many(keys, self.layout, payload_len, raw=True)
        ok = [r.ok for r in results]
        good = [r for r in results if r.ok]
        if not good:
            raise RuntimeError(f"all {len(keys)} prompt fetches failed this round")
        rows, present = self.layout.gather_rows_batch([(r.k, r.chunks) for r in good])
        phase_ms = {"fetch": (time.perf_counter() - t0) * 1e3}
        now = time.monotonic()
        dt = -1.0 if self._last_now is None else max(now - self._last_now, 1e-9)
        self._last_now = now

        arch, device = self.engine.arch, self.step.device
        q = float(len(keys))
        mark0 = obs.device_mark(device)
        # The reference's key; its last field is telemetry collection.
        key = ("pfd", *self.step.codec.bucket_key("dec", self.layout.N, self.layout.K,
                                                  rows.shape[2], len(good)),
               self.prompt_len, self.layout.strip_bytes, collect)
        self._note_bucket(key)
        with obs.span("serve.launch", bucket=str(key), batch=len(good)) as launch_span:
            rows_t, _ = self.step._upload(rows)
            if collect:
                # The served reads' delays go up with the rows, before the
                # launch: from pinned memory, asynchronously, on a card.
                delays = torch.tensor([r.total_s for r in good], dtype=torch.float32)
                if device.type == "cuda":
                    delays = delays.pin_memory()
                delays = delays.to(device, non_blocking=True)
            data, n_nxt, k_nxt, _ = self.step.decode_on_device(
                rows_t, present, n=self.layout.N, k=self.layout.K, q=q, dt=dt)
            toks = tokens_from_strips(data, self.layout.K, self.layout.strip_bytes,
                                      self.prompt_len)
            # Bucket-padding rows decode to zeros; the clip keeps any stray
            # word (a high byte ≥ 128 is negative in int32) inside the table.
            toks = torch.clamp(toks, 0, arch.cfg.vocab - 1)
            marks = [] if getattr(arch.module, "PREFILL_MARKS", False) else None
            logits, cache = arch.prefill_tokens(
                self.engine.params, toks, max_seq=self.engine.max_seq,
                **({} if marks is None else {"marks": marks}))
            if collect:
                if self._mbuf is None:
                    self._zero_bufs(device)
                self._collect(q=q, dt=dt, n_nxt=n_nxt, k_nxt=k_nxt, requested=len(keys),
                              delays=delays)
        self.stats.launches += 1
        mark1 = obs.device_mark(device)
        eng = self.engine
        before = eng.captures, eng.graph_replays, eng.eager_steps
        with obs.span("serve.generate", steps=steps) as generate_span:
            # Generation continues at the padded batch; rows are cut to the
            # served subset at the end.
            gen = eng.continue_greedy(logits, cache, steps)
            mark2 = obs.device_mark(device)
            tokens = gen[: len(good)].cpu().numpy()
        with self._lock:
            self.stats.traces += eng.captures - before[0]
        # The pick comes to the host only now: generation forced the launch,
        # so this read costs no stall.
        next_code = (int(n_nxt), int(k_nxt))
        phase_ms["launch"] = obs.mark_ms(mark0, mark1)
        phase_ms["generate"] = obs.mark_ms(mark1, mark2)
        if marks:
            # the prefill's layers by kind, from its marks (all done by now)
            kinds = {}
            for (_, a), (kind, b) in zip(marks, marks[1:]):
                kinds[kind] = kinds.get(kind, 0.0) + obs.mark_ms(a, b)
            phase_ms.update({f"launch.{kind}": ms for kind, ms in kinds.items()})
            launch_span.tag(**{f"{kind}_ms": ms for kind, ms in kinds.items()})
        # The spans time the enqueue; their work's own time is known only now.
        launch_span.tag(device_ms=phase_ms["launch"])
        generate_span.tag(device_ms=phase_ms["generate"],
                          graph_replays=eng.graph_replays - before[1],
                          eager_steps=eng.eager_steps - before[2])
        if eng.counters is not None and obs.tracing():
            # the expert layers' counts, on the device until now
            names = arch.module.COUNTERS
            pre, post = (c.tolist() for c in eng.counters)
            launch_span.tag(**dict(zip(names, pre)))
            generate_span.tag(**{n: b - a for n, a, b in zip(names, pre, post)})
        if collect:
            # Where the round's budget went: "decode" is the whole launch
            # (upload + admission + K1 + prefill), "generate" the token loop.
            self._flight.record(
                [("admit", phase_ms["fetch"] / 1e3), ("decode", phase_ms["launch"] / 1e3),
                 ("generate", phase_ms["generate"] / 1e3)],
                requested=len(keys), served=len(good), code=next_code)
        if self.write_policy is not None:
            self.write_policy.push(*next_code)  # close the write loop
        return ClosedLoopResult(
            tokens=tokens,
            ok=ok,
            served_keys=[r.key for r in good],
            codes=[(r.n, r.k) for r in good],
            next_code=next_code,
            storage_total_s=[r.total_s for r in good],
            phase_ms=phase_ms,
        )
