"""The fused serving step: TOFEC admission + batched MDS coding per round.

The port of the first half of the reference package's
``repro/serve/engine.py``. The proxy returns raw chunks (``raw=True``) and
one call of :meth:`FusedServingStep.decode_batch` (or ``encode_batch``) runs
the admission update and the batched codec work back to back on the device:
the controller's carry stays there between rounds, and the codec's K1 launch
follows the controller's update on the same stream. The controller is
runtime data (:class:`ServeTables`): TOFEC, static, fixed-k (threshold form,
same encodings as the fleet sweeps) and MPC (cost-model argmin,
:func:`repro_torch.core.controller.mpc_step`) all run through one step, so
swapping the policy swaps tensors.

Shapes are bucketed exactly like :mod:`repro_torch.coding.codec` (powers of
two on batch / parity rows / strip width), and the per-item decode matrices
are runtime inputs built host-side from the cached Cauchy tables;
``stats.traces`` counts the first use of each shape bucket, which keeps the
reference's bound on buckets visible (asserted in the tests).

The LM half (``ServingEngine``, ``tokens_from_strips``,
``ClosedLoopServer``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.coding import codec as codec_mod
from repro_torch.coding import rs
from repro_torch.core.controller import (
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


class FusedServingStep:
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
        # First uses of each shape bucket; ``.traces`` is the public pin.
        self.stats = obs.CompileStats(label="serve.FusedServingStep")
        self._seen: set[tuple] = set()
        self._lock = threading.Lock()
        self.reset()

    @property
    def traces(self) -> int:
        return self.stats.traces

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

    def _note_bucket(self, key: tuple) -> None:
        with self._lock:
            if key not in self._seen:
                self._seen.add(key)
                self.stats.traces += 1

    def _admit(self, q, dt) -> tuple[torch.Tensor, torch.Tensor]:
        self.carry, n_nxt, k_nxt = serve_policy_step(self.carry, q, dt, self.tables)
        return n_nxt, k_nxt

    def _upload(self, arr):
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device, torch.uint8), True
        return torch.from_numpy(np.ascontiguousarray(arr, np.uint8)).to(self.device), False

    # -- fused entry points ----------------------------------------------------

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
        present = codec_mod._host_present(present, batch, k)
        mats = self.codec.decode_mats(present, n, k)
        mats_p, rows_p, key = self.codec.pad_to_bucket("dec", mats, rows, n, k)
        self._note_bucket(key)
        backend = self.codec.backend
        with obs.span("serve.decode_batch", bucket=str(key), batch=batch):
            prepped = backend.prep_mats(mats_p)
            n_nxt, k_nxt = self._admit(q, dt)
            out = backend.matmul_prepped(prepped, rows_p)
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
