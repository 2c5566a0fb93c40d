"""Roofline terms of a planned (arch × shape × mesh) cell, on H100 constants.

The port of the reference package's ``repro/launch/roofline.py``. Three
terms per cell, in seconds:

    compute    = FLOPs / (chips × 989.4e12 FLOP/s bf16)
    memory     = bytes / (chips × 3.35e12 B/s HBM3)
    collective = Σ per-device link bytes / the link's rate

FLOPs and bytes are the whole cell's, counted by running it once on
``meta`` tensors (:func:`repro_torch.obs.count_work`): the FLOPs of every
matmul, the bytes every operation reads and writes.

The reference parses its collectives out of the compiled, partitioned HLO.
The port has no compiler to ask, so :func:`collective_bytes` is a MODEL of
the collectives, not a reading of them: per-device link bytes computed from
the specs by the usual ring costs (see its docstring). The reference's own
number cannot serve as its oracle either: the reference's sharded compile
fails on jax 0.9 (``ROADMAP.md``, queue 3).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.obs.profile import HBM_BW, PEAK_FLOPS

#: Per-GPU link rates, one direction. NVLink 4: 450 GB/s per H100 (the
#: NVIDIA H100 SXM data sheet's 900 GB/s is both directions), for a mesh
#: axis of <= 8 devices, which fits in one 8-GPU node. Across nodes: one
#: 400 Gb/s InfiniBand NDR NIC per GPU (the DGX H100 data sheet), 50 GB/s,
#: for every wider axis (an axis of 16 spans two nodes).
NVLINK_BW = 450e9
IB_BW = 50e9
NODE_GPUS = 8


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """What :func:`collective_bytes` reads of a planned cell.

    ``params``: [(bytes, spec)] of every parameter leaf; ``batch_ways``: how
    many ways the batch is cut; ``sublayer_tokens``: tokens through each
    tensor-parallel sublayer of one forward pass; ``act_bytes``: bytes of
    an activation element."""

    kind: str
    axis_sizes: dict
    rules: dict
    params: list
    batch_ways: int
    sublayer_tokens: list
    d_model: int
    act_bytes: int


def _ring(group: int) -> float:
    """Per-device share of a ring all-gather or reduce-scatter of S bytes,
    as a multiple of S (an all-reduce moves twice this)."""
    return (group - 1) / group


def collective_bytes(plan: CollectivePlan) -> dict:
    """Per-device link bytes of one step of the cell, by ring costs.

    * FSDP: each parameter leaf whose spec cuts it over the "embed" axes
      (the data axes) is all-gathered over them in the forward pass, again
      in the backward's recompute, and its gradient reduce-scattered; a leaf
      left whole on those axes has its gradient all-reduced over the batch
      axes instead (both: train only). Each moves the leaf's bytes over the
      other axes that cut it.
    * Tensor parallelism over "model": each sublayer takes an all-gather of
      its (B / batch ways) × S × d residual and a reduce-scatter of its
      output — two pairs a transformer block — in the forward pass, and two
      more a sublayer in the backward (train).
    * Under ``pure_dp_rules``: one all-reduce of every gradient over the
      batch axes (train only).

    Prefill and decode cells count only the forward terms. Returns the
    reference's keys: bytes per kind of collective, ``count`` (operations),
    ``in_loop`` (the per-sublayer activation collectives) and ``in_entry``
    (the parameter collectives), plus the bytes over ``nvlink`` and ``ib``.
    """
    sizes, rules = plan.axis_sizes, plan.rules
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0, "count": 0,
           "in_entry": 0.0, "in_loop": 0.0, "nvlink": 0.0, "ib": 0.0}

    def add(kind: str, nbytes: float, group: int, where: str, ops: int = 1):
        if group <= 1 or nbytes <= 0:
            return
        out[kind] += nbytes
        out["count"] += ops
        out[where] += nbytes
        out["nvlink" if group <= NODE_GPUS else "ib"] += nbytes

    train = plan.kind == "train"
    batch_axes = set(rules.get("batch", ()))
    fsdp_axes = set(rules.get("embed", ()))
    for nbytes, spec in plan.params:
        cut = [((e,) if isinstance(e, str) else e or ()) for e in spec]
        on = [a for axes in cut for a in axes]
        gather = math.prod(sizes[a] for a in on if a in fsdp_axes)
        local = nbytes / math.prod(sizes[a] for a in on if a not in fsdp_axes)
        if gather > 1:
            add("all-gather", _ring(gather) * local, gather, "in_entry")
            if train:
                add("all-gather", _ring(gather) * local, gather, "in_entry")
                add("reduce-scatter", _ring(gather) * local, gather, "in_entry")
        elif train:
            group = math.prod(sizes[a] for a in batch_axes if a not in on)
            add("all-reduce", 2 * _ring(group) * local, group, "in_entry")

    tp = math.prod(sizes[a] for a in rules.get("ff", ()))
    pairs = 2 if train else 1  # forward, and the backward's
    for tokens in plan.sublayer_tokens:
        residual = tokens / plan.batch_ways * plan.d_model * plan.act_bytes
        for _ in range(pairs):
            add("all-gather", _ring(tp) * residual, tp, "in_loop")
            add("reduce-scatter", _ring(tp) * residual, tp, "in_loop")
    return out


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    coll_breakdown: dict

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        # Per-device bytes already; each over its own link's rate.
        return (self.coll_breakdown.get("nvlink", 0.0) / NVLINK_BW
                + self.coll_breakdown.get("ib", 0.0) / IB_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "coll_breakdown": {k: v for k, v in self.coll_breakdown.items() if v},
        }


def analyze(flops: float, hbm_bytes: float, coll: dict, chips: int) -> Roofline:
    """Roofline terms from a cell's counted work and its collective model."""
    return Roofline(flops=flops, hbm_bytes=hbm_bytes,
                    coll_bytes=float(coll["in_loop"] + coll["in_entry"]), chips=chips,
                    coll_breakdown=coll)


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D; decode: D = batch·1."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens
    tokens = shape.batch * 1
    return 2.0 * n_active * tokens
