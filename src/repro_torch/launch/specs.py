"""``meta`` stand-ins and spec trees for every (arch × shape) planning cell.

The port of the reference package's ``repro/launch/specs.py``.
:func:`dryrun_target` returns ``(fn, args, in_specs)``: ``fn`` runs the
port's own entry point (``make_train_step(arch)``, ``arch.prefill`` or
``arch.decode_step``) on ``args``, which are ``meta`` tensors (weights,
optimizer state, batch, cache — shapes and dtypes, no storage), and
``in_specs`` holds one spec tree per argument under the mesh's rules.
Running ``fn`` on ``meta`` under :func:`repro_torch.obs.count_work` counts
the cell's work without a card; :func:`per_device_bytes` reads the
arguments' footprint on each device of the plan from the specs, and
:func:`collective_plan` gathers what the analytic collective model
(:func:`repro_torch.launch.roofline.collective_bytes`) needs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.roofline import CollectivePlan
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.registry import Arch, get
from repro_torch.models.sharding import (
    axis_rules,
    default_rules,
    pure_dp_rules,
    spec_for,
    tree_specs,
)
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import (
    batch_logical_axes,
    make_train_step,
    opt_state_specs,
    param_specs,
)


def resolve_arch(arch: str | Arch, cfg_override: ModelConfig | None = None) -> Arch:
    arch = get(arch) if isinstance(arch, str) else arch
    return arch if cfg_override is None else Arch(cfg=cfg_override, module=arch.module)


def resolve_shape(shape: str | ShapeSpec) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, kind: str, device="meta") -> dict:
    """The cell's batch as ``meta`` tensors (the reference's
    ``ShapeDtypeStruct`` stand-ins)."""
    B, S = shape.batch, shape.seq
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=device)}
    if kind == "train":
        out["labels"] = torch.empty((B, S), dtype=torch.int32, device=device)
    if cfg.family == "encdec":
        out["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
                                    device=device)
    if cfg.family == "vlm":
        out["patches"] = torch.empty((B, cfg.vision_patches, cfg.d_model), dtype=torch.float32,
                                     device=device)
    return out


def cell_rules(mesh, cfg: ModelConfig):
    """The rules a cell plans under: ``pure_dp`` for configs that ask for
    it, the defaults otherwise (None)."""
    if mesh is not None and cfg.sharding_profile == "pure_dp":
        return pure_dp_rules(mesh)
    return None


def _batch_specs_tree(cfg: ModelConfig, batch: dict) -> dict:
    logical = batch_logical_axes(cfg)
    return {name: spec_for(tuple(t.shape), logical.get(name, ("batch",) + (None,) * (t.ndim - 1)))
            for name, t in batch.items()}


def input_specs(arch: Arch, shape: ShapeSpec, mesh, rules=None) -> tuple[tuple, tuple | None]:
    """(args, in_specs) of a cell: ``meta`` arguments of its kind's entry
    point and, with a mesh, one spec tree per argument (None without)."""
    cfg = arch.cfg
    with axis_rules(mesh, rules):
        params = arch.init(device="meta")
        p_specs = param_specs(arch, params)
        if shape.kind == "train":
            batch = batch_specs(cfg, shape, "train")
            args = (params, init_opt_state(params), batch)
            specs = (p_specs, opt_state_specs(p_specs), _batch_specs_tree(cfg, batch))
        elif shape.kind == "prefill":
            batch = batch_specs(cfg, shape, "prefill")
            args = (params, batch)
            specs = (p_specs, _batch_specs_tree(cfg, batch))
        else:  # decode: one new token against a seq-length cache
            B = shape.batch
            cache = arch.init_cache(B, shape.seq, device="meta")
            token = torch.empty((B, 1), dtype=torch.int32, device="meta")
            args = (params, token, cache)
            specs = (p_specs, spec_for((B, 1), ("batch", None)),
                     tree_specs(cache, arch.module.cache_logical_axes(cfg, B)))
    return args, (specs if mesh is not None else None)


def dryrun_target(arch: str | Arch, shape: str | ShapeSpec, mesh,
                  cfg_override: ModelConfig | None = None):
    """(fn, args, in_specs) for one cell under ``mesh`` (None: unsharded,
    as the work count runs it).

    kinds: train → the train step (forward + backward + AdamW); prefill →
    prefill at max_seq = seq; decode → one decode step against a seq-length
    cache."""
    arch = resolve_arch(arch, cfg_override)
    shape = resolve_shape(shape)
    args, specs = input_specs(arch, shape, mesh, cell_rules(mesh, arch.cfg))
    if shape.kind == "train":
        fn = make_train_step(arch)
    elif shape.kind == "prefill":
        def fn(params, batch):
            return arch.prefill(params, batch, max_seq=shape.seq)
    else:
        def fn(params, token, cache):
            return arch.decode_step(params, token, cache)
    return fn, args, specs


def _shard_factor(spec: tuple, sizes: dict[str, int]) -> int:
    """How many ways a spec cuts its tensor."""
    return math.prod(sizes[axis] for entry in spec
                     for axis in ((entry,) if isinstance(entry, str) else entry or ()))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _walk_pairs(fn, tree, specs):
    """``fn(tensor, spec)`` over a tree of tensors and its spec tree (the
    tensors' tree decides the structure; a ``None`` subtree holds none)."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        fn(tree, specs)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _walk_pairs(fn, v, specs[k])
    else:
        for t, s in zip(tree, specs, strict=True):
            _walk_pairs(fn, t, s)


def leaf_specs(args, in_specs) -> list[tuple[torch.Tensor, tuple]]:
    """[(tensor, spec)] of every argument leaf of a cell."""
    out = []
    _walk_pairs(lambda t, spec: out.append((t, spec)), tuple(args), tuple(in_specs))
    return out


def per_device_bytes(args, in_specs, mesh) -> int:
    """Bytes of ``args`` on each device of ``mesh`` under ``in_specs``
    (each leaf's bytes over the ways its spec cuts it)."""
    sizes = mesh.axis_sizes
    return sum(_nbytes(t) // _shard_factor(spec, sizes) for t, spec in leaf_specs(args, in_specs))


def tp_sublayers(cfg: ModelConfig, shape: ShapeSpec) -> list[int]:
    """Tokens through each tensor-parallel sublayer (attention, MLP, a
    recurrent cell) of one forward pass of the cell, in order: each takes an
    all-gather of its residual input and a reduce-scatter of its output
    under Megatron-style sequence parallelism."""
    B = shape.batch
    tokens = B * (1 if shape.kind == "decode" else shape.seq)
    if cfg.family == "encdec":
        enc = [] if shape.kind == "decode" else [B * cfg.encoder_seq] * (2 * cfg.encoder_layers)
        return enc + [tokens] * (3 * cfg.n_layers)  # self-attention, cross-attention, MLP
    if cfg.family == "ssm":
        return [tokens] * cfg.n_layers
    if cfg.family == "hybrid":
        sites = sum(cfg.attn_every > 0 and (i + 1) % cfg.attn_every == 0
                    for i in range(cfg.n_layers))
        return [tokens] * (cfg.n_layers + 2 * sites)
    if cfg.family == "vlm" and shape.kind != "decode":
        tokens = B * (cfg.vision_patches + shape.seq)
    return [tokens] * (2 * cfg.n_layers)


def collective_plan(arch: Arch, shape: ShapeSpec, mesh, rules, args, in_specs) -> CollectivePlan:
    """What the analytic collective model reads of a planned cell."""
    cfg = arch.cfg
    rules = rules or default_rules(mesh)
    sizes = mesh.axis_sizes
    params = [(_nbytes(t), spec) for t, spec in leaf_specs(args[:1], in_specs[:1])]
    with axis_rules(mesh, rules):
        tok_spec = spec_for((shape.batch, 1), ("batch", None))
    return CollectivePlan(
        kind=shape.kind, axis_sizes=sizes, rules=rules, params=params,
        batch_ways=_shard_factor(tok_spec, sizes), sublayer_tokens=tp_sublayers(cfg, shape),
        d_model=cfg.d_model, act_bytes=getattr(torch, cfg.dtype).itemsize)


def flops_pass_cfg(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Config for the FLOPs pass: scans unrolled; full-attention chunks
    enlarged (rectangular-chunk FLOPs are chunk-size invariant, so this only
    shrinks the unrolled HLO); windowed/banded attention keeps its real chunk
    sizes (band FLOPs DO depend on them). In the port the larger chunks cut
    the Python-dispatched block count of the ``meta`` run."""
    kw = dict(scan_unroll=True)
    if not (cfg.sliding_window or cfg.local_global_period):
        kw["attn_q_chunk"] = min(shape.seq, 4096)
        kw["attn_kv_chunk"] = min(shape.seq, 4096)
    return dataclasses.replace(cfg, **kw)


def slstm_flops_correction(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """The reference's count of the sLSTM's missing scan iterations: its
    FLOPs pass counts the per-token scan body once, so it adds the (S−1)
    iterations of the recurrent matmul h@R: 2·B·d·4d flops each, ×4 for
    train (fwd + full-remat recompute + ~2× bwd). The port's sLSTM is a
    Python loop over positions, so its ``meta`` count already holds every
    position and does not add this; it is kept to compare the two counts."""
    if cfg.family != "ssm" or cfg.slstm_every <= 0:
        return 0.0
    n_slstm = sum(
        1 for i in range(cfg.n_layers) if (i + 1) % cfg.slstm_every == 0
    )
    if shape.kind == "decode":
        return 0.0  # decode is a single step; nothing missing
    per_step = 2.0 * shape.batch * cfg.d_model * 4 * cfg.d_model
    mult = 4.0 if shape.kind == "train" else 1.0
    return n_slstm * (shape.seq - 1) * per_step * mult
