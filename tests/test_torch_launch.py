"""The port's launch planner (``repro_torch.launch``) and its work count
(``repro_torch.obs.count_work``) on the CPU, at smoke sizes on ``meta``.

Exact checks: ``count_work`` of a dense smoke prefill equals the closed-form
matmul count; the MoE experts' ``aten.bmm.dtype`` product is counted on
``meta``, which takes the card's branch of ``bmm_f32``; the sLSTM's
per-position loop is counted position by position (its forward count is
the closed form, its train count linear in S); ``collective_bytes`` equals
the ring formulas written out by hand for a smoke config on a (2, 4) mesh;
``run_cell`` writes the reference's record keys for the four kinds, and
``report`` renders them. ``repro.launch.dryrun`` is never imported (it sets
512 host devices at import).
"""

import dataclasses
import json

import pytest
import torch

from repro.launch.roofline import Roofline as RefRoofline
from repro_torch.launch import dryrun, report
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.roofline import collective_bytes
from repro_torch.launch.specs import cell_rules, collective_plan, dryrun_target
from repro_torch.models import ShapeSpec, get, ssm
from repro_torch.kernels import products
from repro_torch.models import moe
from repro_torch.models.registry import Arch
from repro_torch.obs import count_work
from repro_torch.tree import tree_flatten

MESH = Mesh((2, 4), ("data", "model"))
SHAPES = {"train_4k": ShapeSpec("train_4k", "train", 64, 8),
          "prefill_32k": ShapeSpec("prefill_32k", "prefill", 64, 8),
          "decode_32k": ShapeSpec("decode_32k", "decode", 64, 8),
          "long_500k": ShapeSpec("long_500k", "decode", 128, 1)}
REF_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "optimized", "status",
                   "roofline", "model_flops", "useful_flops_ratio", "memory"}


def test_count_work_of_dense_prefill_is_the_closed_form():
    """yi-6b's smoke config (GQA, GLU MLP): every matmul of one prefill."""
    arch = get("yi-6b", smoke=True)
    cfg = arch.cfg
    B, S = 8, 64
    fn, args, _ = dryrun_target(arch, ShapeSpec("p", "prefill", S, B), None)
    flops, nbytes = count_work(fn, *args)
    T, d, hd = B * S, cfg.d_model, cfg.hd
    assert min(cfg.attn_q_chunk, cfg.attn_kv_chunk) >= S  # one attention block
    per_layer = (2 * T * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd  # q, k, v
                 + 2 * 2 * B * S * S * cfg.n_heads * hd  # scores and values
                 + 2 * T * cfg.n_heads * hd * d  # output projection
                 + (3 if cfg.glu else 2) * 2 * T * d * cfg.d_ff)  # MLP
    assert flops == cfg.n_layers * per_layer + 2 * B * d * cfg.vocab  # last-token head
    assert nbytes > 0


def test_bmm_dtype_is_counted_on_meta_on_the_cards_branch():
    E, M, K, N = 4, 6, 8, 5
    a = torch.empty((E, M, K), dtype=torch.bfloat16, device="meta")
    b = torch.empty((E, K, N), dtype=torch.bfloat16, device="meta")
    flops, nbytes = count_work(products._BmmF32.apply, a, b)
    assert flops == 2 * E * M * N * K
    # bmm_f32 on meta takes the card's branch: the bfloat16 operands are
    # read once, the float32 product written once, nothing widened.
    assert count_work(moe.bmm_f32, a, b) == (flops, 2 * (a.numel() + b.numel()) + 4 * E * M * N)
    cpu = count_work(moe.bmm_f32, torch.zeros((E, M, K), dtype=torch.bfloat16),
                     torch.zeros((E, K, N), dtype=torch.bfloat16))
    assert cpu[0] == flops and cpu[1] > nbytes  # the CPU widens its operands first
    # The MoE smoke config's prefill counts on meta, its expert products included.
    arch = get("mixtral-8x7b", smoke=True)
    fn, args, _ = dryrun_target(arch, ShapeSpec("p", "prefill", 16, 2), None)
    assert count_work(fn, *args)[0] > 0


def test_slstm_count_follows_its_per_position_loop():
    arch = get("xlstm-350m", smoke=True)
    cfg = arch.cfg
    d, B = cfg.d_model, 2
    params = arch.init(device="meta")
    cell = next(blk["cell"] for blk in params["blocks"] if "r_h" in blk["cell"])
    for S in (8, 16):
        x = torch.empty((B, S, d), dtype=getattr(torch, cfg.dtype), device="meta")
        flops, _ = count_work(ssm.slstm_block, cell, cfg, x)
        # x-projection, one h @ r_h a position, the down projection.
        assert flops == 2 * B * S * d * 4 * d + S * 2 * B * d * 4 * d + 2 * B * S * d * d

    def fwd_bwd(x):
        with torch.enable_grad():
            live = {k: v.detach().requires_grad_() for k, v in cell.items()}
            y, _ = ssm.slstm_block(live, cfg, x.requires_grad_())
            torch.autograd.grad(y.float().sum(), [x, *live.values()])

    # Each product's backward is two products of its size, but for the first
    # position's h @ r_h: its h is the zero state, which needs no gradient.
    assert count_work(fwd_bwd, x)[0] == 3 * flops - 2 * B * d * 4 * d
    # The model's train step: 16 more positions add at least their sLSTM
    # layers' recurrent products, forward and backward.
    counts = {}
    for S in (16, 32):
        fn, args, _ = dryrun_target(arch, ShapeSpec("t", "train", S, B), None)
        counts[S] = count_work(fn, *args)[0]
    n_slstm = sum("r_h" in blk["cell"] for blk in params["blocks"])
    assert n_slstm == 1
    assert counts[32] - counts[16] >= n_slstm * 3 * 16 * 2 * B * d * 4 * d
    assert counts[32] > 2 * counts[16] - counts[16] // 10  # otherwise linear in S


def test_slstm_prefill_count_extends_to_the_direct_count():
    """The planner counts an sLSTM prefill at 2, 3 and 4 chunks and reads
    the parabola through them at S; at S = 8 chunks that equals the direct
    count exactly. Train and decode cells are counted whole."""
    arch = get("xlstm-350m", smoke=True)
    c = arch.cfg.ssm_chunk
    shape = ShapeSpec("s", "prefill", 8 * c, 2)
    assert dryrun.position_loop_base(arch.cfg, shape) == c
    assert dryrun.global_work(arch, shape) == dryrun._count(arch, shape)
    for other in (ShapeSpec("t", "train", 8 * c, 2), ShapeSpec("d", "decode", 8 * c, 2)):
        assert dryrun.position_loop_base(arch.cfg, other) is None
    assert dryrun.position_loop_base(get("zamba2-2.7b").cfg, shape) is None


def _ring(n):
    return (n - 1) / n


@pytest.mark.parametrize("kind", ["train", "prefill", "pure_dp"])
def test_collective_bytes_equal_the_ring_formulas(kind):
    """qwen1.5-0.5b's smoke config on (data 2, model 4), written out: every
    matrix is cut over data (FSDP, gathered in halves) and model (a
    quarter each); biases over model only; norms whole."""
    arch = get("qwen1.5-0.5b", smoke=True)
    if kind == "pure_dp":
        arch = Arch(cfg=dataclasses.replace(arch.cfg, sharding_profile="pure_dp"),
                    module=arch.module)
    cfg = arch.cfg
    B, S = 8, 64
    shape = ShapeSpec("s", "prefill" if kind == "prefill" else "train", S, B)
    rules = cell_rules(MESH, cfg)
    _, args, in_specs = dryrun_target(arch, shape, MESH)
    got = collective_bytes(collective_plan(arch, shape, MESH, rules, args, in_specs))
    leaves = tree_flatten(args[0])
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    norms = nbytes(t for path, t in leaves if path[-1] == "scale")
    biases = nbytes(t for path, t in leaves if path[-1] in ("bq", "bk", "bv"))
    mats = nbytes(t for path, t in leaves if path[-1] not in ("scale", "bq", "bk", "bv"))
    assert biases > 0 and norms > 0
    leaves = [t for _, t in leaves]
    if kind == "pure_dp":
        assert got["all-reduce"] == 2 * _ring(8) * nbytes(leaves)
        assert got["all-gather"] == got["reduce-scatter"] == got["in_loop"] == 0
        return
    residual = B // 2 * S * cfg.d_model * 2  # bf16 rows of one data shard
    tp = 2 * cfg.n_layers * _ring(4) * residual  # attention + MLP a layer
    fsdp = _ring(2) * mats / 4
    if kind == "prefill":
        assert got["all-gather"] == pytest.approx(fsdp + tp, rel=1e-12)
        assert got["reduce-scatter"] == pytest.approx(tp, rel=1e-12)
        assert got["all-reduce"] == 0
    else:
        assert got["all-gather"] == pytest.approx(2 * fsdp + 2 * tp, rel=1e-12)
        assert got["reduce-scatter"] == pytest.approx(fsdp + 2 * tp, rel=1e-12)
        assert got["all-reduce"] == pytest.approx(2 * _ring(2) * (biases / 4 + norms), rel=1e-12)
    assert got["nvlink"] == pytest.approx(got["in_loop"] + got["in_entry"], rel=1e-12)
    assert got["ib"] == 0


def test_run_cell_writes_the_reference_record_and_report_renders_it(tmp_path):
    ref_roof_keys = set(RefRoofline(1.0, 1.0, 1.0, 1, {}).as_dict())
    for name in ("qwen1.5-0.5b", "mixtral-8x7b", "xlstm-350m", "whisper-base"):
        arch = get(name, smoke=True)
        for shape in SHAPES.values():
            rec = run_cell(arch, shape, mesh=MESH, out_dir=str(tmp_path))
            assert rec["mesh"] == "2x4" and rec["chips"] == 8
            if rec["status"] == "skipped":
                assert name in ("qwen1.5-0.5b", "whisper-base") and shape.name == "long_500k"
                assert "quadratic" in rec["reason"]
                continue
            assert rec["status"] == "ok", rec
            assert REF_RECORD_KEYS <= set(rec)
            assert set(rec["roofline"]) == ref_roof_keys
            assert set(rec["memory"]) == {"argument_size_b", "output_size_b", "temp_size_b",
                                          "peak_b"}
            assert rec["memory"]["temp_size_b"] is None and rec["memory"]["peak_b"] is None
            r = rec["roofline"]
            assert r["flops"] > 0 and r["hbm_bytes"] > 0 and rec["fits"] is True
            assert all(r[k] >= 0 for k in ("t_compute_s", "t_memory_s", "t_collective_s"))
    recs = report.load(str(tmp_path))
    assert len(recs) == 16
    assert json.loads((tmp_path / "qwen1.5-0.5b__train_4k__2_4.json").read_text())["kind"] \
        == "train"
    table = report.roofline_table(recs, "2x4")
    assert "| qwen1.5-0.5b | train_4k |" in table and "| whisper-base | long_500k |" in table
    assert "SKIP" in table and "| — | yes |" in table  # temp/dev is not known on meta
    text = report.render(recs)
    assert "989.4 TFLOP/s" in text and "450 GB/s NVLink" in text and "v5e" not in text
