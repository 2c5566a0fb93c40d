"""The launch plan on H100s: plan every (arch × shape × mesh) cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
        [--mesh single|multi|both] [--opt] [--no-save] [--out DIR]

The port of the reference package's ``repro/launch/dryrun.py``. The
reference AOT-compiles each cell for a v5e pod; the port has no XLA, so it
plans the cell on ``meta`` tensors, which allocate nothing, and needs no
card. Per cell it records:
  * the per-device bytes of the cell's arguments under the specs (does it
    fit an 80 GiB H100?),
  * FLOPs and HBM bytes counted by running the cell once, unsharded, on
    ``meta`` (:func:`repro_torch.obs.count_work`), the FLOPs-pass config's
    enlarged attention chunks included (:func:`~repro_torch.launch.specs.flops_pass_cfg`),
  * the per-device collective bytes of the analytic model
    (:func:`repro_torch.launch.roofline.collective_bytes`),
  * the three roofline terms on H100 constants + the dominant one.

``temp_size_b`` and ``peak_b`` are None: the ``meta`` device has no
allocator, so there is no compiled temp or peak to read (the report prints
"—" for them). Records go to ``build/dryrun_torch/<cell>.json`` (``--out``
to change it); :mod:`repro_torch.launch.report` renders them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import analyze, collective_bytes, model_flops
from repro_torch.launch.specs import (
    cell_rules,
    collective_plan,
    dryrun_target,
    flops_pass_cfg,
    leaf_specs,
    per_device_bytes,
    resolve_arch,
    resolve_shape,
)
from repro_torch.models.config import SHAPES, cell_is_runnable
from repro_torch.models.registry import arch_names, get
from repro_torch.obs.profile import count_work

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun_torch")

#: One H100 SXM's memory (the data sheet's 80 GB are 80 GiB).
HBM_BYTES = 80 * 2**30

# Cache: global (FLOPs, bytes) per (arch, shape) — mesh-independent, counted once.
_WORK_CACHE: dict[tuple, tuple[float, float]] = {}


def _count(arch, shape) -> tuple[float, float]:
    fn, args, _ = dryrun_target(arch, shape, None, cfg_override=flops_pass_cfg(arch.cfg, shape))
    return count_work(fn, *args)


def position_loop_base(cfg, shape) -> int | None:
    """The length S0 from which :func:`global_work` extends a count, or None
    to count the cell whole.

    The sLSTM is a Python loop over positions, ~24 dispatched operations a
    position, each ~0.2 ms on ``meta``: xlstm-350m's six sLSTM layers at
    32,768 positions would take most of an hour to count. From two chunks
    on (one chunk takes a shorter path) a prefill's FLOPs and bytes are
    affine in S for S a multiple of the chunk, so the prefill is counted
    at 2, 3 and 4 chunks and the parabola through them (exact for a line,
    and for a term in S²) is read at S. Train cells are counted whole:
    their chunked loss needs S a multiple of 512 past 512, so the shorter
    lengths would save little. Decode cells are one step."""
    if cfg.family != "ssm" or cfg.slstm_every <= 0 or shape.kind != "prefill":
        return None
    s0 = cfg.ssm_chunk
    return s0 if shape.seq > 4 * s0 and shape.seq % s0 == 0 else None


def global_work(arch, shape) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of the whole cell: an unsharded ``meta`` run of
    the FLOPs-pass config. The port's scans are Python loops, so every
    iteration is counted and no correction is added; the sLSTM's cells are
    extended from three shorter runs (:func:`position_loop_base`)."""
    arch, shape = resolve_arch(arch), resolve_shape(shape)
    key = (arch.cfg, shape)
    if key not in _WORK_CACHE:
        s0 = position_loop_base(arch.cfg, shape)
        if s0 is None:
            _WORK_CACHE[key] = _count(arch, shape)
        else:
            f2, f3, f4 = (_count(arch, dataclasses.replace(shape, seq=k * s0)) for k in (2, 3, 4))
            x = shape.seq // s0  # Lagrange through x = 2, 3, 4
            w2, w3, w4 = (x - 3) * (x - 4) // 2, -(x - 2) * (x - 4), (x - 2) * (x - 3) // 2
            _WORK_CACHE[key] = tuple(w2 * a + w3 * b + w4 * c for a, b, c in zip(f2, f3, f4))
    return _WORK_CACHE[key]


def mesh_label(mesh, multi_pod: bool, custom: bool) -> str:
    if custom:
        return "x".join(map(str, mesh.shape))
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch_name, shape_name, multi_pod: bool = False, *, save: bool = True,
             optimized: bool = False, mesh=None, out_dir: str | None = None) -> dict:
    """Plan one cell and return (and save) its record. ``arch_name`` is an
    arch id or an :class:`~repro_torch.models.registry.Arch` (a smoke
    config, in tests), ``shape_name`` a name of ``SHAPES`` or a
    :class:`~repro_torch.models.config.ShapeSpec`; ``mesh`` replaces the
    production mesh."""
    custom = mesh is not None
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    arch, shape = resolve_arch(arch_name), resolve_shape(shape_name)
    cfg = arch.cfg
    cfg_override = None
    if optimized:
        # The reference's beyond-paper levers: weight gathering, full
        # decode-cache sharding, and microbatching for the largest models.
        accum = 8 if cfg.param_count_dense() > 1e11 else 1
        cfg_override = dataclasses.replace(
            cfg, weight_gather=True, decode_cache_seq_shard=True, grad_accum=accum)
        cfg = cfg_override
    ok, reason = cell_is_runnable(cfg, shape)
    label = mesh_label(mesh, multi_pod, custom)
    tag = f"{arch.name}×{shape.name}×{label}{'×opt' if optimized else ''}"
    rec = {
        "arch": arch.name,
        "shape": shape.name,
        "mesh": label + ("-opt" if optimized else ""),
        "chips": chips,
        "kind": shape.kind,
        "optimized": optimized,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        print(f"[dryrun] {tag}: SKIP ({reason})", flush=True)
        _save(rec, save, out_dir)
        return rec

    t0 = time.monotonic()
    try:
        rules = cell_rules(mesh, cfg)
        fn, args, in_specs = dryrun_target(arch, shape, mesh, cfg_override=cfg_override)
        arg_bytes = per_device_bytes(args, in_specs, mesh)
        coll = collective_bytes(collective_plan(arch, shape, mesh, rules, args, in_specs))
        t_plan = time.monotonic() - t0
        flops, hbm = global_work(arch, shape)
        t_count = time.monotonic() - t0 - t_plan
        roof = analyze(flops, hbm, coll, chips)
        mf = model_flops(cfg, shape, shape.kind)
        rec.update(
            status="ok",
            plan_s=round(t_plan, 2),
            count_s=round(t_count, 2),
            n_specs=len(leaf_specs(args, in_specs)),
            roofline=roof.as_dict(),
            model_flops=mf,
            useful_flops_ratio=(mf / roof.flops) if roof.flops else None,
            memory={
                "argument_size_b": arg_bytes,
                "output_size_b": None,
                "temp_size_b": None,  # the meta device has no allocator
                "peak_b": None,
            },
            fits=arg_bytes <= HBM_BYTES,
        )
        print(
            f"[dryrun] {tag}: OK  args/dev={arg_bytes / 2**30:.2f} GiB "
            f"t_comp={roof.t_compute:.4f}s t_mem={roof.t_memory:.4f}s "
            f"t_coll={roof.t_collective:.4f}s dominant={roof.dominant} "
            f"(plan {t_plan:.1f}s count {t_count:.1f}s)", flush=True)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
        print(f"[dryrun] {tag}: ERROR {type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
    _save(rec, save, out_dir)
    return rec


def _save(rec: dict, save: bool, out_dir: str | None):
    if not save:
        return
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh'].replace('x', '_')}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the levers (weight_gather, decode cache sharding, microbatching)")
    ap.add_argument("--out", default=None, help=f"record directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    archs = arch_names() if args.arch == "all" else [get(args.arch).name]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, save=not args.no_save, optimized=args.opt,
                               out_dir=args.out)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_err += rec["status"] == "error"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
