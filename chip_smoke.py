#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card, and hold each of its
CUDA kernels against its plain PyTorch version there.

Usage, from the repository root, on a machine with one CUDA card (H100):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device — torch version and the card's name and power limit;
2. build  — builds K1 (``gf2_rs_bytes.cu``) and K2 (``gf2_matmul.cu``) from
   the sources, one nvcc for each, started together;
3. kernels — K1 against its plain version, byte for byte, at the main
   path's decode and encode shapes (batch 32), the write path's encode of
   128 objects (checked in slices of 32), a k=256 case, a ragged case, the
   checkpoint's (8, 4) encode over a 2^24-byte strip bucket, each k in
   1-5, 7-9 and m = 17; times it at the decode, encode and batch-128
   encode shapes, per call (CUDA events around one call, median of 20) and
   back to back (events around 10 calls, divided by 10, median of 20), each
   as a multiple of its bound, and the plain version at the decode shape;
   the ``[build] K1 ptxas`` lines give its registers and spills. K2 against its
   plain version, byte for byte, at the (12, 6) code's bit-matrix encode of
   one 3 MiB object, a (256, 128) code over 64 KiB strips, a ragged shape in
   int8 and float32, a transposed view, a deep K (64, 4096) @ (4096, 4096)
   and B at a pointer that is not 16-byte aligned; times kernel, plain
   version and the library yardstick (``torch._int_mm``, or a bfloat16
   product where cuBLASLt refuses ``_int_mm``'s shape, plus a mask) at the
   first two, and prints the kernel's time as a multiple of its bound and
   of the yardstick; the ``[build] K2 ptxas`` lines give its registers and
   shared memory. The Mamba2 decode step's kernel (``mamba2_step.cu``,
   built at its first call) against the plain step, S' and n' bit for bit,
   at a Nemotron-3-Nano and a zamba2-2.7b layer's decode shape, timed per
   call and replayed from a CUDA graph (as the decode step runs it) beside
   its bound and the plain step. The decode attention kernel
   (``decode_attention.cu``, built at its first call) against its plain
   version at the decode cells' shapes (zamba2-2.7b's batch and chat sites,
   a Nemotron-3-Nano GQA layer), timed the same way beside its bound, the
   plain version and ``scaled_dot_product_attention``;
4. main path — the paper's §V-A deployment through the port's entry points:
   128 seeded 3 MiB objects written through the proxy (L = 16, (12, 6) strip
   code, feedback write policy), then 4 rounds of 32 raw reads decoded by
   the fused serving step, every byte checked and every controller pick
   held against the host TOFEC policy, then one fused encode round checked
   against the numpy codec, and one more fused decode under torch.profiler
   (device time by operation, the device's idle share); K1's launch counter
   must show the codec work went through the kernel;
5. K2 path — ``gf2_matmul``'s documented use through its entry point: the
   (12, 6) code's parity bit-matrix times the LSB-first bitplanes of one
   3 MiB object, repacked and checked against the numpy codec; K2's launch
   counter must show it ran;
6. serve — the closed loop (the paper's §III loop end to end) through
   ``ClosedLoopServer`` at the main path's deployment feeding qwen1.5-0.5b
   at full width (24 layers, d_model 1024, vocab 151,936, bfloat16, seeded
   random weights): 128 objects whose first 1,024 int32 words are seeded
   token ids, 4 rounds of 32 — raw reads, admission, K1 decode at the main
   path's shape, bytes→tokens, prefill, 32 greedy tokens; every round's
   tokens held against ``ServingEngine.generate`` on the stored prompts,
   every pick against the host TOFEC policy and the write policy, one shape
   bucket, K1 launched in each round, then a write coded under the fed-back
   pick and read back; one more round under torch.profiler;
7. fleet — the paper's Fig. 7 grid at full width through ``FleetSweep``:
   8 rates × (TOFEC, fixed-k(6), the 27 static codes), 3,500 arrivals per
   case, in 4 chunks of one bucket; each TOFEC row is held against the
   numpy oracle on the same draws, the paper's orderings are asserted, and a
   streamed run must equal the materialized one bit for bit; then one chunk
   once more under torch.profiler (wall, device busy, idle share, device
   kernels per scan step);
8. taskq — Fig. 7's Greedy row and Fig. 9 in one ``TaskqSweep`` on the
   exact task engine: 8 Greedy rates plus TOFEC and Greedy at 6 rates, 3,500
   arrivals each, one chunk, over the figures' shared-key trace pools
   (6 × 8,192 × 12); every row is held against the host event oracle on the
   same draws over the reference test's first 1,200 arrivals (the whole
   run's agreement is printed), Greedy is printed beside the fleet's TOFEC
   row, Fig. 9's median std ratio must exceed 1.2, and a 500-arrival chunk
   is profiled;
9. mpc — Fig. 7's MPC row: the host event oracle with ``MPCPolicy`` at the
   same 8 rates (host seconds, mean and p99 per rate);
10. sched — the multiclass-disciplines figure through ``SchedSweep``: 2
   classes × 6 rates × (FIFO, priority, WFQ), 3,000 arrivals, one chunk,
   with the Poisson-split fleet baseline; the interference headline is
   held, a one-class mix must equal the fluid scan bit for bit and a
   streamed run the materialized one, and a 500-arrival chunk is profiled;
11. obs — the telemetry planes (``REPRO_OBS``) on the same paths: 4 more
   closed-loop rounds (run inside phase 6, before its proxy closes) with
   collection on, their tokens equal to ``ServingEngine.generate`` and to
   the uncollected rounds', exact counters, every delay row summing to 32,
   K1 launched in each, the SLO report and the ASCII dashboard printed; the
   fleet, taskq and sched sweeps again with collection on, their outputs
   equal to the uncollected runs' bit for bit, pick histograms and delay
   histograms equal to host recounts, the buckets' disagreements with
   float64 arithmetic printed; the worst taskq row replayed with the flight
   recorder; ``profile_launch`` of K1 and of one fluid-scan case, every
   ``frac_peak`` at or under 1.05; each path's wall with collection on and
   off. Artifacts go to ``chiprun_out/obs/``.
12. train — run right after phase 6: qwen1.5-0.5b at full width trained
   through ``Trainer`` at seq 4,096 × batch 2 (``remat_policy="nothing"``,
   AdamW defaults, seeded weights and ``SyntheticTokens(seed=0)``), with
   erasure-coded checkpoints through ``AsyncCheckpointer`` at (8, 4) (K1
   encode, one launch per strip-bucket group): 6 steps straight; 3 steps,
   strips 0 and 2 of every leaf lost, a trainer rebuilt from the store
   alone (K1 decode, every crc checked) resuming at step 3 for 3 more,
   whose final loss must equal the straight run's to rel = 1e-4; each
   step's stream time, tokens/s, loss and grad norm, peak device memory,
   the checkpoint's save and restore splits, one step under
   torch.profiler, and one ``CodedShardReader`` shard of 2 × 4,097 tokens
   written and read back through the proxy; K1's launches on the path
   must cover every encode and decode group.
13. families — run right after phase 12: the moe, vlm, encdec, ssm and
   hybrid families at their published widths through the same entry points.
   mixtral-8x7b cut to 8 layers (11.87 B seeded parameters, 23.74 GB; 32 do
   not fit the card) and pixtral-12b cut to 20 of its 40 layers (the
   reference's zero 1,024-patch prefix in front of every prompt) each served
   through the closed loop, 3 rounds of 8 keys with 1,024-token prompts and
   16 generated tokens; whisper-base whole, 3 rounds of 32 with 432-token
   prompts (its decoder's 448-token context); xlstm-350m whole (24 layers,
   18 mLSTM and 6 sLSTM) and zamba2-2.7b whole (54 Mamba2 layers, the
   shared attention block at 9 sites), each 3 rounds of 32 with 1,024-token
   prompts; each checked as phase 6 checks its rounds and profiled as it
   is; mixtral's, xlstm's and zamba2's decode-vs-prefill continuation at
   the reference's 0.08;
   mixtral cut to 2 layers trained 3 AdamW steps at seq 4,096 × batch 1
   with capacity routing (losses and aux loss finite, the aux loss near 1 a
   layer at init; no checkpoint); xlstm-350m cut to 4 layers (3 mLSTM and 1
   sLSTM) at seq 1,024 × batch 8, zamba2-2.7b cut to 6 layers (one
   attention period) at seq 4,096 × batch 2 and whisper-base at seq 448 ×
   batch 16, each trained through phase 12's protocol (checkpoints at
   (8, 4), a restart from 6 of 8 strips per leaf, the final loss equal to
   the straight run's to rel = 1e-4). K1's launches on the path must cover
   every round and every xlstm, zamba2 and whisper encode and decode group.
14. shard — grid sharding on the card: the fleet, taskq and sched grids of
   phases 7, 8 and 10 again on a mesh that repeats the card
   (``["cuda:0", "cuda:0"]``: each launch's rows cut in two halves run one
   after the other), every output array bit-equal to the phase's own
   unsharded result and ``stats.by_mesh == {(2,): 1}``; a streamed +
   sharded fleet run's frontier equal to the unsharded one; a ``chunk=6``
   run on a 4-entry mesh padded to 8 rows with the real rows untouched;
   each run's wall beside the unsharded one (no speedup expected).
15. launch — the launch plan: qwen1.5-0.5b's four cells on the 16 x 16 H100
   mesh through ``repro_torch.launch.dryrun.run_cell`` (spec count,
   per-device argument bytes, the three roofline terms, the dominant one),
   and the one-card roofline of the runs phases 6, 12 and 13 measured
   (qwen's prefill at 32 x 1,024 and decode step, its train step at 4,096 x
   2, zamba2's prefill at 32 x 1,024), each counted on ``meta`` at its real
   shape beside its measured device busy time, which must not beat the
   counted FLOPs at the bfloat16 peak.

The last lines are the card's ``nvidia-smi`` line, one JSON object with the
kernels' numbers, and ``{"ok": true, "device": {...}}``. Without a card it
exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

#: NVIDIA H100 SXM data-sheet peak (dense) int8 ops/s; the HBM rate and the
#: bfloat16 peak are ``repro_torch.obs.profile.HBM_BW`` and ``PEAK_FLOPS``.
INT8_OPS_PER_S = 1.979e15

#: The paper's §V-A deployment (tests/test_fused_serve.py, coding/layout.py).
FILE_BYTES = 3 * 2**20
K_MAX, R_MAX, L_THREADS = 6, 2, 16

#: The Fig. 7 sweep (benchmarks/paper_figures.py, fig7_adaptive_tradeoff).
FLEET_COUNT, FLEET_SEED, FLEET_CHUNK = 3500, 1, 64
#: Reference values of the figures, from the reference's JAX CPU runs at
#: fewer arrivals: printed beside the card's for the reader, never asserted.
BASELINES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "baselines")

#: Fig. 7's Greedy row and Fig. 9 on the exact task engine, and the trace
#: pools both read (benchmarks/paper_figures.py, benchmarks/common.py).
TASKQ_COUNT, TASKQ_CHUNK = 3500, 64
POOL_SAMPLES, POOL_CORRELATION, POOL_SEED = 8192, 0.14, 5
#: The multiclass-disciplines figure (paper_figures.py, fig_multiclass_disciplines).
SCHED_COUNT, SCHED_CHUNK = 3000, 32
#: Arrivals of the profiled taskq and sched chunks (a short, small trace).
PROFILE_COUNT = 500


def request_class():
    from repro_torch.core import PAPER_READ_3MB, RequestClass

    return RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=K_MAX, r_max=float(R_MAX),
                        n_max=K_MAX * R_MAX)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()


def k1_bound_parts(batch: int, m8: int, k8: int, B: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of one K1 call: its counts
    (``gf2mm.k1_counts``: each input byte read once and each output byte
    written once, the equivalent 0/1 int8 product's operations) over the
    HBM rate and the int8 peak."""
    from repro_torch.kernels.gf2mm.gf2mm import k1_counts
    from repro_torch.obs.profile import HBM_BW

    ops, nbytes = k1_counts(batch, m8, k8, B)
    return nbytes / HBM_BW * 1e3, ops / INT8_OPS_PER_S * 1e3


def k1_bound(batch: int, m8: int, k8: int, B: int) -> tuple[float, str]:
    """Least time (ms) the card needs for one K1 call and what bounds it:
    the larger of :func:`k1_bound_parts`."""
    t_bytes, t_ops = k1_bound_parts(batch, m8, k8, B)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound(M: int, K: int, N: int) -> tuple[float, str]:
    """Least time (ms) the card needs for one K2 call and what bounds it:
    its counts (``gf2mm.k2_counts``: each operand byte read once and each
    output byte written once, the 0/1 int8 product's 2·M·K·N operations)
    over the HBM rate and the int8 peak."""
    from repro_torch.kernels.gf2mm.gf2mm import k2_counts
    from repro_torch.obs.profile import HBM_BW

    ops, nbytes = k2_counts(M, K, N)
    t_bytes, t_ops = nbytes / HBM_BW, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(fn, calls: int = 10, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` with calls queued back to back:
    CUDA events around ``calls`` consecutive calls, divided by ``calls``,
    median of ``reps``. The wrapper's host work overlaps the queued device
    work, so it stays out of the window unless it is longer."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def graph_ms(fn, calls: int = 10, reps: int = 20) -> float:
    """Device time of one call of ``fn`` as a captured decode step runs it:
    ``calls`` calls captured in one CUDA graph (after a warm-up call), the
    replay timed with CUDA events, divided by ``calls``, median of ``reps``.
    No host work is in the window."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay, reps=reps, warmup=2) / calls


#: K1 cases timed as well as checked: the main path's decode and encode at
#: batch 32, and the write path's batched encode of 128 objects.
K1_TIMED = ("decode", "encode", "encode128")
#: Data rows of the k cases: every step plan of the kernel's register path
#: (k ≤ 8) and the shared-tile path (k = 9).
K1_KS = (1, 2, 3, 4, 5, 7, 8, 9)


def k1_cases(device, rng) -> list[tuple[str, "object", "object"]]:
    """(label, bitmats, data) at the main path's shapes (decode and encode at
    batch 32, encode at batch 128), k = 256, a ragged B, the checkpoint's
    (8, 4) encode over a 2^24-byte bucket, each k of ``K1_KS`` and m = 17
    (B = 4,176: a masked last warp step)."""
    import torch

    from repro_torch.coding import gf256, rs
    from repro_torch.coding.codec import Codec

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def pad_m(mats, m_b):
        out = np.zeros((mats.shape[0], m_b, mats.shape[2]), np.uint8)
        out[:, : mats.shape[1]] = mats
        return out

    n, k, batch, B = K_MAX * R_MAX, K_MAX, 32, FILE_BYTES // K_MAX
    present = np.stack([np.sort(rng.permutation(n)[:k]) for _ in range(batch)])
    dec = pad_m(Codec("numpy").decode_mats(present, n, k), 8)
    enc = pad_m(np.broadcast_to(rs.cauchy_parity_matrix(n, k), (batch, n - k, k)), 8)
    data = up(rng.integers(0, 256, (batch, k, B), dtype=np.uint8))
    wide = rng.integers(0, 256, (2, 128, 256), dtype=np.uint8)
    ragged = rng.integers(0, 256, (3, 6, 6), dtype=np.uint8)
    cases = [
        ("decode", up(gf256.expand_bitmatrix_batched(dec)), data),
        ("encode", up(gf256.expand_bitmatrix_batched(enc)), data),
        ("encode128", up(gf256.expand_bitmatrix_batched(np.repeat(enc, 4, axis=0))),
         up(rng.integers(0, 256, (4 * batch, k, B), dtype=np.uint8))),
        ("wide_k256", up(gf256.expand_bitmatrix_batched(wide)),
         up(rng.integers(0, 256, (2, 256, 4096), dtype=np.uint8))),
        ("ragged", up(gf256.expand_bitmatrix_batched(ragged)),
         up(rng.integers(0, 256, (3, 6, 1001), dtype=np.uint8))),
        # The checkpoint's encode: (8, 4) parity, a 2^24-byte strip bucket.
        ("ckpt_k4", up(gf256.expand_bitmatrix_batched(
            np.broadcast_to(rs.cauchy_parity_matrix(8, 4), (2, 4, 4)))),
         up(rng.integers(0, 256, (2, 4, 2**24), dtype=np.uint8))),
    ]
    for kk, m in [(kk, 8) for kk in K1_KS] + [(K_MAX, 17)]:
        mats = rng.integers(0, 256, (2, m, kk), dtype=np.uint8)
        cases.append((f"k{kk}_m{m}", up(gf256.expand_bitmatrix_batched(mats)),
                      up(rng.integers(0, 256, (2, kk, 4176), dtype=np.uint8))))
    return cases


def check_k1(device, rng) -> dict:
    """K1 vs its plain version on every case (batches above 32 in slices of
    32: the plain version's float32 planes would need tens of GB); times at
    the decode and encode shapes, per call and back to back."""
    import torch

    from repro_torch.kernels.gf2mm.gf2mm import gf2_rs_matmul_bytes
    from repro_torch.kernels.gf2mm.ref import gf2_rs_matmul_bytes_ref

    rec = {"cases": {}, "max_abs_err": 0, "byte_equal": True}
    for label, bitmats, data in k1_cases(device, rng):
        got = gf2_rs_matmul_bytes(bitmats, data)
        equal, err = True, 0
        for i in range(0, bitmats.shape[0], 32):
            want = gf2_rs_matmul_bytes_ref(bitmats[i:i + 32], data[i:i + 32])
            part = got[i:i + 32]
            equal &= bool(torch.equal(part, want))
            err = max(err, int((part.to(torch.int16) - want.to(torch.int16)).abs().max()))
            del want
        case = {"shape": [list(bitmats.shape), list(data.shape)], "byte_equal": equal,
                "max_abs_err": err}
        rec["cases"][label] = case
        rec["byte_equal"] &= equal
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"[kernels] K1 {label}: bitmats {tuple(bitmats.shape)} data "
              f"{tuple(data.shape)} byte_equal={equal} max_abs_err={err}", flush=True)
        del got
        torch.cuda.empty_cache()
        if label not in K1_TIMED:
            continue
        batch, m8, k8 = bitmats.shape
        B = data.shape[2]
        case["ms"] = median_ms(lambda: gf2_rs_matmul_bytes(bitmats, data))
        case["b2b_ms"] = back_to_back_ms(lambda: gf2_rs_matmul_bytes(bitmats, data))
        case["bound_ms"], case["bound_by"] = k1_bound(batch, m8, k8, B)
        case["bytes_bound_ms"], case["ops_bound_ms"] = k1_bound_parts(batch, m8, k8, B)
        if label == "decode":
            case["plain_ms"] = median_ms(lambda: gf2_rs_matmul_bytes_ref(bitmats, data))
            # Yardstick only: the float32 bmm at the heart of the plain
            # version, on planes unpacked beforehand (no unpack, mod 2 or
            # repack) — not the same function, so it is not library_ms.
            shifts = torch.arange(8, dtype=torch.uint8, device=device)
            planes = ((data[:, :, None, :] >> shifts[None, None, :, None]) & 1)
            planes = planes.reshape(batch, k8, B).to(torch.float32)
            bm32 = bitmats.to(torch.float32)
            case["bmm_ms"] = median_ms(lambda: torch.bmm(bm32, planes))
            del planes, bm32
            torch.cuda.empty_cache()
            print(f"[kernels] K1 decode: {case['plain_ms']:.4f} ms plain, "
                  f"{case['bmm_ms']:.4f} ms float32 bmm (yardstick)", flush=True)
        print(f"[kernels] K1 {label}: {case['ms']:.4f} ms per call "
              f"({case['ms'] / case['bound_ms']:.2f}x bound), {case['b2b_ms']:.4f} ms back to "
              f"back ({case['b2b_ms'] / case['bound_ms']:.2f}x bound); bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']}; bytes "
              f"{case['bytes_bound_ms']:.4f}, operations {case['ops_bound_ms']:.4f})", flush=True)
    if not rec["byte_equal"]:
        raise AssertionError(f"K1 disagrees with its plain version: {rec['cases']}")
    for key in ("ms", "b2b_ms", "plain_ms", "bmm_ms", "bound_ms", "bound_by", "bytes_bound_ms",
                "ops_bound_ms"):
        rec[key] = rec["cases"]["decode"][key]
    return rec


def k2_cases(device) -> list[tuple[str, "object", "object"]]:
    """(label, A, B): K2's documented use — the (12, 6) code's parity
    bit-matrix over the bitplanes of one 3 MiB object at the §V-A layout —,
    a (256, 128) code over 64 KiB strips, a shape ragged on every dimension
    in int8 and in float32, a transposed (non-contiguous) B, a deep K over
    32 k-tiles, and B as a contiguous view one byte into a flat buffer (not
    16-byte aligned: the byte-wise path)."""
    import torch

    from repro_torch.coding import gf256, rs

    g = torch.Generator(device=device).manual_seed(2)

    def bits(shape, dtype=torch.uint8):
        return torch.randint(0, 2, shape, generator=g, device=device).to(dtype)

    g2 = torch.from_numpy(gf256.expand_bitmatrix(rs.cauchy_parity_matrix(K_MAX * R_MAX, K_MAX)))
    buf = torch.empty(48 * 4096 + 1, dtype=torch.uint8, device=device)
    misaligned = buf[1:].view(48, 4096)
    misaligned.copy_(bits((48, 4096)))
    return [
        ("encode", g2.to(device), bits((8 * K_MAX, FILE_BYTES // K_MAX))),
        ("max_field", bits((1024, 1024)), bits((1024, 65_536))),
        ("ragged_int8", bits((130, 200), torch.int8), bits((200, 513), torch.int8)),
        ("ragged_float32", bits((130, 200), torch.float32), bits((200, 513), torch.float32)),
        ("view", bits((96, 320)), bits((640, 320)).T),
        ("deep_k", bits((64, 4096)), bits((4096, 4096))),
        ("misaligned", g2.to(device), misaligned),
    ]


def library_ms(a, b, want) -> tuple[float, str]:
    """Time of one library product that computes K2's function, and its
    name: ``torch._int_mm(a, b) & 1`` on int8 operands, or, where cuBLASLt
    refuses ``_int_mm``'s shape, a bfloat16 product cast to uint8 and masked
    (exact while K <= 256: every sum is an integer bfloat16 holds). The
    operands are cast beforehand. It must agree with ``want``; it is timed
    here and used nowhere else."""
    import torch

    a8, b8 = a.to(torch.int8).contiguous(), b.to(torch.int8).contiguous()
    try:
        torch._int_mm(a8, b8)
        name, fn = "_int_mm & 1", lambda: torch._int_mm(a8, b8) & 1
    except RuntimeError as exc:
        print(f"[kernels] K2 library yardstick _int_mm refused {tuple(a.shape)} @ "
              f"{tuple(b.shape)}: {str(exc).splitlines()[0]}", flush=True)
        if a.shape[1] > 256:
            raise AssertionError("no exact library product for K2 at this shape") from exc
        a16, b16 = a.to(torch.bfloat16).contiguous(), b.to(torch.bfloat16).contiguous()
        name, fn = "bf16 matmul & 1", lambda: (a16 @ b16).to(torch.uint8) & 1
    if not torch.equal(fn().to(torch.uint8), want):
        raise AssertionError(f"the library yardstick {name} disagrees with K2's plain version")
    return median_ms(fn), name


def check_k2(device) -> dict:
    """K2 vs its plain version on every case; times at the encode and
    max_field shapes (kernel, plain version, library yardstick)."""
    import torch

    from repro_torch.kernels.gf2mm.gf2mm import gf2_matmul
    from repro_torch.kernels.gf2mm.ref import gf2_matmul_ref

    rec = {"cases": {}, "max_abs_err": 0, "byte_equal": True}
    for label, a, b in k2_cases(device):
        got = gf2_matmul(a, b)
        want = gf2_matmul_ref(a, b).to(torch.uint8)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        case = {"shape": [list(a.shape), list(b.shape)], "dtype": str(a.dtype).split(".")[-1],
                "b_contiguous": b.is_contiguous(), "byte_equal": equal, "max_abs_err": err}
        print(f"[kernels] K2 {label}: {tuple(a.shape)} @ {tuple(b.shape)} {case['dtype']}"
              f"{'' if b.is_contiguous() else ' (B a transposed view)'} byte_equal={equal} "
              f"max_abs_err={err}", flush=True)
        if label in ("encode", "max_field"):
            case["ms"] = median_ms(lambda: gf2_matmul(a, b))
            case["plain_ms"] = median_ms(lambda: gf2_matmul_ref(a, b), reps=5, warmup=1)
            case["library_ms"], case["library_call"] = library_ms(a, b, want)
            case["bound_ms"], case["bound_by"] = k2_bound(a.shape[0], a.shape[1], b.shape[1])
            print(f"[kernels] K2 {label}: {case['ms']:.4f} ms kernel, {case['plain_ms']:.4f} ms "
                  f"plain, library ({case['library_call']}) {case['library_ms']:.4f} ms, bound "
                  f"{case['bound_ms']:.4f} ms ({case['bound_by']}); kernel = "
                  f"{case['ms'] / case['bound_ms']:.2f}x bound, "
                  f"{case['ms'] / case['library_ms']:.3f}x library", flush=True)
        rec["cases"][label] = case
        rec["byte_equal"] &= equal
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del got, want
        torch.cuda.empty_cache()
    if not rec["byte_equal"]:
        raise AssertionError(f"K2 disagrees with its plain version: {rec['cases']}")
    for key in ("ms", "plain_ms", "library_ms", "library_call", "bound_ms", "bound_by"):
        rec[key] = rec["cases"]["encode"][key]
    return rec


#: The Mamba2 step kernel's timed shapes, (B, H, G, N, P) of one layer's
#: decode step in the nemotron3-decode-batch and zamba2-decode-batch cells.
MAMBA2_STEP_SHAPES = {"nemotron": (64, 64, 8, 128, 64), "zamba2": (32, 32, 32, 64, 160)}


def y_err_over_bound(y, q, s_new) -> float:
    """The largest |y − Σₙ q[n]·S'[n, p]| (the sum in float64, of the same
    float32 S') over its bound N · 2⁻²⁴ · Σₙ |q[n]·S'[n, p]|, which any
    order of a float32 sum of N terms keeps: at most 1 for a sound y.
    q is by group, (B, G, N)."""
    qh = q.repeat_interleave(s_new.shape[1] // q.shape[1], dim=1).double()
    terms = qh[..., None] * s_new.double()  # (B, H, N, P)
    bound = s_new.shape[2] * 2.0 ** -24 * terms.abs().sum(dim=2)
    err = (y.double() - terms.sum(dim=2)).abs()
    return float((err / bound.clamp(min=1e-30)).max())


def check_mamba2_step(device) -> dict:
    """The Mamba2 step kernel against its plain version at both decode
    cells' shapes (bfloat16 q, k, v): S' and n' bit-equal, y = qᵀS' (the
    kernel's own reduction) and the plain step's y each within
    :func:`y_err_over_bound`'s bound of the float64 sum; its time per call
    and replayed from a graph (:func:`graph_ms`), in place as the graph
    path runs it, as a multiple of its bound (bytes at 3.35 TB/s); and the
    plain step it replaced: B and C repeated per head,
    ``linear_recurrence_step``, and the copy of S' and n' into the cache's
    slot."""
    import torch

    from repro_torch.kernels.ssm.mamba2_step import mamba2_step, step_counts
    from repro_torch.models import ssm
    from repro_torch.obs.profile import HBM_BW

    rec = {"cases": {}, "bit_equal": True, "y_err_over_bound": 0.0}
    for label, (B, H, G, N, P) in MAMBA2_STEP_SHAPES.items():
        g = torch.Generator(device=device).manual_seed(0)
        proj = torch.randn((B, H * P + 2 * G * N), generator=g, device=device).bfloat16()
        v, k, q = torch.split(proj, [H * P, G * N, G * N], dim=-1)
        v, k, q = v.unflatten(-1, (H, P)), k.unflatten(-1, (G, N)), q.unflatten(-1, (G, N))
        dt_ = torch.rand((B, H), generator=g, device=device) + 0.01
        log_a = -dt_ * torch.rand((H,), generator=g, device=device)
        state = torch.randn((B, H, N, P), generator=g, device=device)
        n_state = torch.randn((B, H, N), generator=g, device=device)

        slot_s, slot_n = torch.empty_like(state), torch.empty_like(n_state)

        def plain():
            qh, kh = (t.repeat_interleave(H // G, dim=1) for t in (q, k))
            y, s, n = ssm.linear_recurrence_step(qh, kh, v, log_a, dt_, state, n_state)
            slot_s.copy_(s)
            slot_n.copy_(n)
            return y, slot_s, slot_n

        def kernel():
            return mamba2_step(q, k, v, log_a, dt_, state, n_state, out=(state, n_state))

        y, s_new, n_new = mamba2_step(q, k, v, log_a, dt_, state, n_state)
        y0, s0, n0 = plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(s_new, s0) and torch.equal(n_new, n0))
        y_err, y0_err = y_err_over_bound(y, q, s_new), y_err_over_bound(y0, q, s0)
        del y, s_new, n_new, y0, s0, n0
        bound_ms = step_counts(B, H, G, N, P, 2)[1] / HBM_BW * 1e3
        case = {"shape": [B, H, G, N, P], "bit_equal": equal, "y_err_over_bound": y_err,
                "plain_y_err_over_bound": y0_err, "bound_ms": bound_ms,
                "ms": median_ms(kernel), "graph_ms": graph_ms(kernel),
                "plain_ms": median_ms(plain, reps=10), "plain_graph_ms": graph_ms(plain)}
        print(f"[kernels] mamba2_step {label} (B, H, G, N, P) = {(B, H, G, N, P)}: "
              f"bit_equal={equal}; y off the float64 sum by {y_err:.4f} of its bound (the "
              f"plain step's {y0_err:.4f}); {case['ms']:.4f} ms per call, "
              f"{case['graph_ms']:.4f} ms replayed from a graph; plain {case['plain_ms']:.4f} ms per call, "
              f"{case['plain_graph_ms']:.4f} ms replayed; bound {bound_ms:.4f} ms (bytes); "
              f"kernel = {case['ms'] / bound_ms:.2f}x bound per call, "
              f"{case['graph_ms'] / bound_ms:.2f}x replayed", flush=True)
        rec["cases"][label] = case
        rec["bit_equal"] &= equal
        rec["y_err_over_bound"] = max(rec["y_err_over_bound"], y_err)
        del state, n_state, proj, slot_s, slot_n
        torch.cuda.empty_cache()
    if not rec["bit_equal"]:
        raise AssertionError(f"mamba2_step's state disagrees with the plain step: {rec['cases']}")
    if not rec["y_err_over_bound"] <= 1.0:
        raise AssertionError(f"mamba2_step's y is off the float64 sum by more than its bound: "
                             f"{rec['cases']}")
    return rec


#: (B, Smax, Hkv, G, hd, window) of the decode cells' attention: a zamba2-2.7b
#: shared-attention site in the batch cell (32 rows, 128 + 64 slots) and in the
#: chat cell (1,024 + 32), and a Nemotron-3-Nano GQA layer (64 rows, 512 + 128)
DECODE_ATTENTION_SHAPES = {"zamba2_batch": (32, 192, 32, 1, 80, 4096),
                           "zamba2_chat": (32, 1056, 32, 1, 80, 4096),
                           "nemotron": (64, 640, 2, 16, 128, None)}


def check_decode_attention(device) -> dict:
    """The decode attention kernel against its plain version at the decode
    cells' shapes (bfloat16, a full ring): both held to the float64 P·V of
    the plain version's rounded p, the kernel within twice the plain
    version's largest distance plus the float32 order bound Smax · 2⁻²⁴ ·
    Σ|p v| (``err_over_bound`` at most 1), and the share of outputs equal to
    the plain version's; its time per call and replayed from a graph
    (:func:`graph_ms`), as a multiple of its bound (K and V read once, at
    3.35 TB/s); the plain version's, and ``scaled_dot_product_attention``'s
    over the same cache (the library yardstick: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention.decode_attention import (
        MASKED, attention_counts, decode_attention, decode_attention_plain)
    from repro_torch.obs.profile import HBM_BW

    rec = {"cases": {}, "err_over_bound": 0.0}
    for label, (B, Smax, Hkv, G, hd, window) in DECODE_ATTENTION_SHAPES.items():
        g = torch.Generator(device=device).manual_seed(0)
        q = torch.randn((B, Hkv * G, hd), generator=g, device=device).bfloat16()
        ck, cv = (torch.randn((B, Smax, Hkv, hd), generator=g, device=device).bfloat16()
                  for _ in range(2))
        sp = torch.arange(Smax, dtype=torch.int32, device=device)
        pos = torch.tensor(Smax - 1, dtype=torch.int32, device=device)
        out = torch.empty_like(q)

        def kernel():
            return decode_attention(q, ck, cv, sp, pos, window=window, out=out)

        def plain():
            return decode_attention_plain(q, ck, cv, sp, pos, window=window)

        q4 = q.reshape(B, Hkv * G, 1, hd)
        mask = (sp >= 0) & (sp <= pos)

        def library():
            return F.scaled_dot_product_attention(q4, ck.transpose(1, 2), cv.transpose(1, 2),
                                                  attn_mask=mask[None, None, None],
                                                  enable_gqa=True)

        got, want = kernel().clone(), plain()
        s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, G, hd).float(), ck.float())
        p = torch.softmax(torch.where(mask, s / math.sqrt(hd), MASKED), dim=-1).bfloat16()
        terms = p.double()[..., None] * cv.double().permute(0, 2, 1, 3)[:, :, None]
        o64 = terms.sum(dim=3).reshape(q.shape)
        order = Smax * 2.0 ** -24 * terms.abs().sum(dim=3).reshape(q.shape)
        del terms, s, p
        plain_err = float((want.double() - o64).abs().max())
        ratio = float(((got.double() - o64).abs() / (2 * plain_err + order)).max())
        equal = float((got == want).float().mean())
        del o64, order
        bound_ms = attention_counts(B, Hkv * G, Hkv, Smax, hd, 2)[1] / HBM_BW * 1e3
        case = {"shape": [B, Smax, Hkv, G, hd], "err_over_bound": ratio,
                "plain_err": plain_err, "equal_share": equal, "bound_ms": bound_ms,
                "ms": median_ms(kernel), "graph_ms": graph_ms(kernel),
                "plain_ms": median_ms(plain, reps=10), "plain_graph_ms": graph_ms(plain),
                "library_ms": median_ms(library, reps=10), "library_graph_ms": graph_ms(library)}
        print(f"[kernels] decode_attention {label} (B, Smax, Hkv, G, hd) = "
              f"{(B, Smax, Hkv, G, hd)}: off the float64 P.V by {ratio:.4f} of its bound, "
              f"{equal:.2%} of outputs equal to the plain version's; {case['ms']:.4f} ms per "
              f"call, {case['graph_ms']:.4f} ms replayed from a graph; plain "
              f"{case['plain_ms']:.4f} / {case['plain_graph_ms']:.4f} ms; "
              f"scaled_dot_product_attention {case['library_ms']:.4f} / "
              f"{case['library_graph_ms']:.4f} ms; bound {bound_ms:.4f} ms (bytes); kernel = "
              f"{case['graph_ms'] / bound_ms:.2f}x bound replayed", flush=True)
        rec["cases"][label] = case
        rec["err_over_bound"] = max(rec["err_over_bound"], ratio)
        del q, ck, cv, out, got, want
        torch.cuda.empty_cache()
    if not rec["err_over_bound"] <= 1.0:
        raise AssertionError(f"decode_attention is off the float64 P.V by more than its "
                             f"bound: {rec['cases']}")
    return rec


#: (B, H, Smax, positions) of the latent attention checks: DeepSeek-V3's
#: decode cell (32 rows, 4,096 + 256 slots, 128 heads; pos 0 is one slot, 63
#: two tiles, 4,096 the round's first step, 4,351 its last) and a ragged shape
#: (80 heads: a block with 16; 1,000 slots: a partial last tile)
LATENT_ATTENTION_SHAPES = {"deepseek_v3": (32, 128, 4352, (0, 63, 4096, 4351)),
                           "ragged": (5, 80, 1000, (0, 517, 999))}


def latent_err_over_bound(got, o64, bound) -> float:
    """The largest |got − o64| / bound (0 where both are 0)."""
    import torch

    err = (got.double() - o64).abs()
    return float(torch.where(err == 0, 0.0, err / bound).max())


def check_latent_attention(device) -> dict:
    """The latent attention kernel (K5) against the float64 P·c_kv of the
    plain version's rounded p at :data:`LATENT_ATTENTION_SHAPES`
    (``err_over_bound`` at most 1, the bound of
    :func:`~repro_torch.kernels.attention.latent_attention.float64_reference`); at the
    cell's shape and last position its time per call and replayed from a
    graph, as a multiple of its bound (max of the latent up to pos at
    3.35 TB/s and its operations at 989.4 TFLOP/s), the plain version's,
    and ``scaled_dot_product_attention``'s over the same latent (one KV
    head, v = the latent's first 512 channels: the library yardstick; the
    port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention.latent_attention import (
        VALUE_WIDTH, WIDTH, float64_reference, latent_attention, latent_attention_plain,
        latent_counts)
    from repro_torch.models import get, mla
    from repro_torch.obs.profile import HBM_BW, PEAK_FLOPS

    scale = mla.softmax_scale(get("deepseek-v3").cfg)
    rec = {"cases": {}, "err_over_bound": 0.0}
    for label, (B, H, Smax, positions) in LATENT_ATTENTION_SHAPES.items():
        g = torch.Generator(device=device).manual_seed(0)
        q = torch.randn((B, H, WIDTH), generator=g, device=device).bfloat16()
        latent = torch.randn((B, Smax, WIDTH), generator=g, device=device).bfloat16()
        out = torch.empty((B, H, VALUE_WIDTH), dtype=torch.bfloat16, device=device)
        for pos in positions:
            pos_t = torch.tensor(pos, dtype=torch.int32, device=device)
            got = latent_attention(q, latent, pos_t, scale, out=out).clone()
            o64, plain, bound, plain_err = float64_reference(q, latent, pos, scale)
            ratio = latent_err_over_bound(got, o64, bound)
            case = {"shape": [B, H, Smax], "pos": pos, "err_over_bound": ratio,
                    "plain_err": plain_err, "equal_share": float((got == plain).float().mean())}
            del o64, plain, bound
            if label == "deepseek_v3" and pos == positions[-1]:
                def kernel():
                    return latent_attention(q, latent, pos_t, scale, out=out)

                def plain_fn():
                    return latent_attention_plain(q, latent, pos_t, scale)

                # one KV head: the 128 heads as 128 queries of it, which is what
                # enable_gqa computes without its copy of K and V for every head
                q4 = q[:, None]
                k4 = latent[:, None]
                v4 = latent[:, None, :, :VALUE_WIDTH]
                mask = (torch.arange(Smax, device=device) <= pos_t)[None, None, None]

                def library():
                    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                          scale=scale)

                ops, nbytes = latent_counts(B, H, pos + 1)
                t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / PEAK_FLOPS * 1e3
                case.update(bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops else "operations",
                            ms=median_ms(kernel), graph_ms=graph_ms(kernel),
                            plain_ms=median_ms(plain_fn, reps=10),
                            plain_graph_ms=graph_ms(plain_fn),
                            library_ms=median_ms(library, reps=10),
                            library_graph_ms=graph_ms(library))
                print(f"[kernels] latent_attention (B, H, Smax) = {(B, H, Smax)}, pos {pos}: "
                      f"{case['ms']:.4f} ms per call, {case['graph_ms']:.4f} ms replayed from "
                      f"a graph; plain {case['plain_ms']:.4f} / {case['plain_graph_ms']:.4f} ms; "
                      f"scaled_dot_product_attention {case['library_ms']:.4f} / "
                      f"{case['library_graph_ms']:.4f} ms; bound {case['bound_ms']:.4f} ms "
                      f"({case['bound_by']}); kernel = "
                      f"{case['graph_ms'] / case['bound_ms']:.2f}x bound replayed", flush=True)
            print(f"[kernels] latent_attention {label} (B, H, Smax) = {(B, H, Smax)}, pos {pos}: "
                  f"off the float64 P.c_kv by {ratio:.4f} of its bound (plain's largest "
                  f"distance {plain_err:.3g}), {case['equal_share']:.2%} of outputs equal to "
                  f"the plain version's", flush=True)
            rec["cases"][f"{label}@{pos}"] = case
            rec["err_over_bound"] = max(rec["err_over_bound"], ratio)
        del q, latent, out
        torch.cuda.empty_cache()
    rec["microbenchmark_launches"] = latent_attention.launches
    if not rec["err_over_bound"] <= 1.0:
        raise AssertionError(f"latent_attention is off the float64 P.c_kv by more than its "
                             f"bound: {rec['cases']}")
    return rec


#: DeepSeek-V3's decode cell's stage at published widths: 16 layers (the 3
#: dense, 13 with one EP32 GPU's 8 of 256 experts), 32 rows, the cell's
#: 4,352 KV slots, 16-token prompts, 3 eager steps and as many replays
DEEPSEEK_DECODE = {"layers": 16, "rows": 32, "max_seq": 4352, "prompt": 16, "steps": 3}


def run_deepseek_decode(device) -> dict:
    """The latent attention kernel (K5) on the path it serves: DeepSeek-V3's
    decode at :data:`DEEPSEEK_DECODE`. Its launch counter is zeroed after
    the prefill and counted by path (``rec["launches_by_path"]``): eager
    steps, a :class:`DecodeBucket`'s capture (its warm-up steps and the
    captured one), and replays of the captured step. Each eager or captured
    step must launch K5 once a layer and a replay not at all (the graph
    launches it, not the host); each replay's logits must equal the eager
    step's at the same position bit for bit."""
    import dataclasses

    import torch

    from repro_torch.kernels.attention.latent_attention import latent_attention
    from repro_torch.models import get
    from repro_torch.models.registry import Arch
    from repro_torch.serve.engine import DecodeBucket
    from repro_torch.tree import tree_map

    layers, rows, steps = (DEEPSEEK_DECODE[k] for k in ("layers", "rows", "steps"))
    base = get("deepseek-v3")
    arch = Arch(dataclasses.replace(base.cfg, n_layers=layers, n_experts=8,
                                    router_experts=256), base.module)
    t0 = time.monotonic()
    params = arch.init(torch.Generator(device=device).manual_seed(0))
    toks = torch.randint(0, arch.cfg.vocab, (rows, DEEPSEEK_DECODE["prompt"]), device=device,
                         dtype=torch.int32, generator=torch.Generator(device=device).manual_seed(1))
    logits, cache = arch.prefill_tokens(params, toks, max_seq=DEEPSEEK_DECODE["max_seq"])
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    pristine = tree_map(torch.clone, cache)

    latent_attention.launches = 0
    by_path = {}
    eager, t, c = [], tok, cache
    for _ in range(steps):
        lg, c = arch.decode_step(params, t, c)
        eager.append(lg.clone())
        t = torch.argmax(lg, dim=-1).to(torch.int32)
    by_path["[deepseek] eager"] = latent_attention.launches
    bucket = DecodeBucket(arch, params, tok, pristine)
    before = latent_attention.launches
    bucket.capture(torch.cuda.graph_pool_handle())
    by_path["[deepseek] capture"] = latent_attention.launches - before
    bucket.load(tok, pristine)
    before = latent_attention.launches
    replayed = [bucket.step().clone() for _ in range(steps)]
    torch.cuda.synchronize(device)
    by_path["[deepseek] replay"] = latent_attention.launches - before
    equal = [bool(torch.equal(a, b)) for a, b in zip(eager, replayed)]
    need = {"[deepseek] eager": layers * steps,
            "[deepseek] capture": layers * (DecodeBucket.WARMUP + 1),
            "[deepseek] replay": 0}
    rec = {"launches": latent_attention.launches, "launches_by_path": by_path,
           "replay_equals_eager": equal, "wall_s": time.monotonic() - t0}
    print(f"[deepseek] decode at {layers} layers, {rows} rows, {DEEPSEEK_DECODE['max_seq']} "
          f"slots: latent attention launches by path {by_path} (need {layers} a step: "
          f"{need}); replayed logits equal to the eager steps' {equal}; "
          f"{rec['wall_s']:.1f} s wall", flush=True)
    del arch, params, logits, cache, pristine, c, eager, replayed, bucket
    _empty_cache(device)
    if by_path != need:
        raise AssertionError(f"latent_attention launched {by_path} times on DeepSeek-V3's "
                             f"decode, want {need}: a step lacks a layer's launch")
    if not all(equal):
        raise AssertionError(f"DeepSeek-V3's replayed decode steps differ from the eager "
                             f"steps: {equal}")
    return rec


def run_k2_path(device, *, strip_bytes: int = FILE_BYTES // K_MAX, seed: int = 0) -> dict:
    """K2's documented use through its entry point: the parity bitplanes of
    one object, C2 = G2 @ D2 mod 2, for the (12, 6) code over LSB-first
    bitplanes of 6 strips, repacked to bytes and checked against the numpy
    codec's parity rows. Raises on any wrong byte."""
    import torch

    from repro_torch.coding import gf256, rs
    from repro_torch.kernels.gf2mm.gf2mm import gf2_matmul
    from repro_torch.kernels.gf2mm.ref import bitplanes_to_bytes_ref, bytes_to_bitplanes_ref

    n, k = K_MAX * R_MAX, K_MAX
    data = np.random.default_rng(seed).integers(0, 256, (k, strip_bytes), dtype=np.uint8)
    g2 = torch.from_numpy(gf256.expand_bitmatrix(rs.cauchy_parity_matrix(n, k))).to(device)
    t0 = time.monotonic()
    planes = bytes_to_bitplanes_ref(torch.from_numpy(data).to(device))  # (8k, B) 0/1
    parity = bitplanes_to_bytes_ref(gf2_matmul(g2, planes)).cpu().numpy()
    wall_ms = (time.monotonic() - t0) * 1e3
    if not np.array_equal(parity, rs.encode(data, n, k)[k:]):
        raise AssertionError("K2 bit-matrix encode disagrees with the numpy codec")
    print(f"[k2path] ({n}, {k}) parity of {k} x {strip_bytes} B through gf2_matmul: "
          f"{wall_ms:.3f} ms wall (upload, unpack, K2, repack, download), matches the numpy "
          "codec", flush=True)
    return {"wall_ms": wall_ms, "shape": [list(g2.shape), list(planes.shape)]}


def rate_grid(n: int, lo_frac: float, hi_frac: float) -> np.ndarray:
    """``n`` arrival rates from ``lo_frac`` to ``hi_frac`` of the basic (1, 1)
    code's capacity (benchmarks/common.py's ``rate_grid``)."""
    from repro_torch.core import PAPER_READ_3MB, queueing

    cap = queueing.capacity(PAPER_READ_3MB, request_class().file_mb, 1, 1.0, L_THREADS)
    return np.linspace(lo_frac * cap, hi_frac * cap, n)


def fleet_grid():
    """The Fig. 7 grid: 8 rates from 0.1 to 0.92 of the basic (1, 1) code's
    capacity × (TOFEC, fixed-k(6), every static (n, k) with k ≤ 6 and
    k ≤ n ≤ min(2k, 12)) × seed 1, as benchmarks/common.py builds it."""
    from repro_torch.fleet import PolicySpec, grid_cases

    cls_ = request_class()
    rates = rate_grid(8, 0.1, 0.92)
    statics = [(n, k) for k in range(1, K_MAX + 1)
               for n in range(k, min(int(R_MAX * k), cls_.n_max) + 1)]
    policies = [PolicySpec.tofec(), PolicySpec.fixedk(6)] + [
        PolicySpec.static(n, k) for n, k in statics]
    return grid_cases(rates, policies, [FLEET_SEED], cls_, L_THREADS)


def check_tofec_rows(res, cases, count: int) -> dict:
    """Every TOFEC row of a materialized sweep against the numpy oracle on
    the same draws: picks equal on ≥ 0.999 of arrivals, delays within rtol
    1e-4 / atol 1e-6 (the reference's scan regression tolerances)."""
    import types

    from repro_torch.core.fluid_scan import FluidScanParams, simulate_tofec_reference
    from repro_torch.fleet import policy_tables

    out = res.to_numpy()
    worst = {"pick_agreement": 1.0, "max_rel_err": 0.0}
    for i, case in enumerate(cases):
        if case.policy.kind != "tofec":
            continue
        inter, exps = case.resolved_workload().device_arrays(
            np.random.default_rng(case.seed), count, case.cls.n_max)
        h_k, h_n, r_max = policy_tables(case.policy, case.cls, case.L)
        ref = simulate_tofec_reference(
            FluidScanParams.from_class(case.cls, case.L, case.policy.alpha),
            types.SimpleNamespace(h_k=h_k, h_n=h_n, r_max=r_max), inter, exps)
        agree = min(float((out[f][i] == ref[f]).mean()) for f in ("n", "k"))
        if agree < 0.999:
            raise AssertionError(f"fleet row {i} (λ={case.lam:.3f}): picks agree on {agree}")
        for f in ("total", "queueing", "service"):
            np.testing.assert_allclose(out[f][i], ref[f], rtol=1e-4, atol=1e-6,
                                       err_msg=f"fleet row {i} (λ={case.lam:.3f}) {f}")
            rel = np.abs(out[f][i] - ref[f]) / np.maximum(np.abs(ref[f]), 1e-6)
            worst["max_rel_err"] = max(worst["max_rel_err"], float(rel.max()))
        worst["pick_agreement"] = min(worst["pick_agreement"], agree)
    return worst


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fleet(device, *, count: int = FLEET_COUNT) -> dict:
    """The Fig. 7 sweep on the card: materialized, reduced, held against the
    oracle and the paper's orderings, then streamed and compared, and one
    chunk profiled (on a CUDA device)."""
    from repro_torch.fleet import (FleetSweep, capacity_estimates, convergence_stats,
                                   frontier_points, headline_ratios)

    cases = fleet_grid()
    sweep = FleetSweep(chunk=FLEET_CHUNK, device=device)
    n_max, hk_len = cases[0].cls.n_max, cases[0].cls.k_max + 1
    key = sweep.bucket_key(len(cases), count, n_max, hk_len, n_max + 1)
    t0 = time.monotonic()
    res = sweep.run(cases, count)
    _sync(device)
    wall_s = time.monotonic() - t0
    want_chunks = -(-len(cases) // FLEET_CHUNK)
    rec = {"cases": len(cases), "count": count, "bucket_key": list(key), "wall_s": wall_s,
           "chunks": res.launches, "bucket_uses": res.compiles, "grid": cases, "res": res}
    print(f"[fleet] Fig. 7 grid: {len(cases)} cases x {count} arrivals, {res.launches} "
          f"chunks (one scan loop of {count} steps each; its device kernels are in the "
          f"[profile] line), {res.compiles} bucket use(s), key {key}, {wall_s:.3f} s wall "
          f"({wall_s / res.launches:.3f} s per chunk)", flush=True)
    if res.launches != want_chunks or res.compiles != 1:
        raise AssertionError(f"expected {want_chunks} chunks in one bucket, got "
                             f"{res.launches} chunks and {res.compiles} bucket uses")
    t0 = time.monotonic()
    pts = frontier_points(res)
    rec["reduce_s"] = time.monotonic() - t0
    caps, head = capacity_estimates(pts), headline_ratios(pts)
    rec["headline"], rec["capacity_req_s"] = head, caps
    base = baseline_metrics("BENCH_fleet.json")
    print(f"[fleet] frontier reduced in {rec['reduce_s']:.3f} s", flush=True)
    for name in ("delay_gain_vs_basic", "capacity_gain_vs_latency_optimal",
                 "tofec_light_mean", "basic_light_mean"):
        print(f"[fleet] headline {name}: {head[name]!r} (JAX CPU baseline at 1,200 "
              f"arrivals: {base.get('headline/' + name)!r})", flush=True)
    print(f"[fleet] latency-optimal static: {head['latency_optimal_static']}", flush=True)
    for name in sorted(caps):
        print(f"[fleet] capacity {name}: {caps[name]!r} req/s (baseline "
              f"{base.get('capacity_req_s/' + name)!r})", flush=True)

    rec["oracle"] = check_tofec_rows(res, cases, count)
    print(f"[fleet] TOFEC rows vs the numpy oracle: picks agree on >= "
          f"{rec['oracle']['pick_agreement']:.6f}, max relative delay error "
          f"{rec['oracle']['max_rel_err']:.3g}", flush=True)
    if not (head["delay_gain_vs_basic"] > 1.5 and head["capacity_gain_vs_latency_optimal"] > 1.5
            and caps["tofec"] > caps["static(12,6)"]):
        raise AssertionError(f"the paper's ordering does not hold: {head}, {caps}")

    t0 = time.monotonic()
    streamed = sweep.run(cases, count, stream=True)
    _sync(device)
    rec["stream_wall_s"] = time.monotonic() - t0
    same = ([p.to_dict() for p in frontier_points(streamed)] == [p.to_dict() for p in pts]
            and convergence_stats(streamed) == convergence_stats(res))
    print(f"[fleet] streamed run: {streamed.launches} chunks, {streamed.compiles} new bucket "
          f"uses, {rec['stream_wall_s']:.3f} s wall, equal to the materialized run bit for bit: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("the streamed sweep differs from the materialized one")
    rec["tofec_points"] = [p for p in pts if p.policy == "tofec"]
    if device.type == "cuda":  # the profiler reads the card's timeline
        rec["profile"] = profile_chunk("fleet", lambda: sweep.run(cases[:FLEET_CHUNK], count),
                                       FLEET_CHUNK, count)
    return rec


class DeviceEvent(NamedTuple):
    """One kernel or copy of a profile: its name and interval (µs)."""
    name: str
    start_us: float
    end_us: float


def device_spans(prof):
    """(busy ms, device events) of a profile: the union of the intervals of
    its device-side events (kernels and copies), read from the profiler's
    raw results. (``prof.events()`` would first build a Python object for
    every host and device event and link them: host time that grows with
    the event count, ~10^5 kernels in an xlstm prefill.)"""
    from torch.autograd import DeviceType

    events = [DeviceEvent(ev.name(), ev.start_ns() / 1e3, ev.end_ns() / 1e3)
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((ev.start_us, ev.end_us) for ev in events):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us / 1e3, events


def profile_chunk(label: str, run, rows: int, count: int) -> dict:
    """One chunk of a sweep (``run()``, ``rows`` cases × ``count`` scan
    steps) under torch.profiler: its host wall time, the device's busy time
    and idle share, and the device kernels it issues per scan step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    busy_ms, events = device_spans(prof)
    if busy_ms <= 0:
        raise AssertionError(f"the profiler recorded no device time for the {label} chunk")
    kernels = [ev for ev in events if not ev.name.startswith(("Memcpy", "Memset"))]
    rec = {"cases": rows, "count": count, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "device_kernels": len(kernels),
           "kernels_per_step": len(kernels) / count, "ms_per_step": wall_ms / count,
           "copies": len(events) - len(kernels),
           "top": _device_top(kernels, 8)}
    print(f"[profile] one {label} chunk ({rows} cases x {count} steps) under the profiler: "
          f"{wall_ms:.3f} ms wall ({rec['ms_per_step']:.4f} ms per scan step), {busy_ms:.3f} ms "
          f"device busy, idle share {rec['device_idle_share']:.4f}, {len(kernels)} device "
          f"kernels in the chunk = {rec['kernels_per_step']:.2f} per scan step, "
          f"{rec['copies']} copies", flush=True)
    for name, n, ms in rec["top"]:
        print(f"[profile]   {ms:10.4f} ms  x{n:<6d} {name[:100]}", flush=True)
    return rec


def baseline_metrics(name: str) -> dict:
    """The ``metrics`` of a reference baseline artifact, by name."""
    with open(os.path.join(BASELINES, name)) as f:
        return {k: v["value"] for k, v in json.load(f)["metrics"].items()}


def taskq_pools(device):
    """The figures' shared-key trace pools (benchmarks/common.py's
    ``taskq_sweep``): the six chunk sizes of the §V-A class, 8,192 jointly
    sampled thread batches, correlation 0.14, seed 5, as (6, 8192, 12)
    float32 on ``device``."""
    from repro_torch.core import PAPER_READ_3MB
    from repro_torch.core.traces import TraceStore

    cls_ = request_class()
    store = TraceStore.generate(PAPER_READ_3MB, [cls_.file_mb / k for k in range(1, K_MAX + 1)],
                                threads=cls_.n_max, samples=POOL_SAMPLES,
                                correlation=POOL_CORRELATION, seed=POOL_SEED)
    return store.device_pools(n_max=cls_.n_max, device=device)


def taskq_grid():
    """Fig. 7's Greedy row (8 rates of ``rate_grid(8, 0.1, 0.92)``) then
    Fig. 9's TOFEC and Greedy at the 6 rates of ``rate_grid(6, 0.15, 0.9)``,
    seed 1: 20 cases, and the count of Fig. 7's."""
    from repro_torch.fleet import PolicySpec, grid_cases

    cls_ = request_class()
    fig7 = grid_cases(rate_grid(8, 0.1, 0.92), [PolicySpec.greedy()], [FLEET_SEED], cls_,
                      L_THREADS)
    fig9 = grid_cases(rate_grid(6, 0.15, 0.9), [PolicySpec.tofec(), PolicySpec.greedy()],
                      [FLEET_SEED], cls_, L_THREADS)
    return fig7 + fig9, len(fig7)


#: Arrivals of the reference's engine-vs-oracle test (tests/test_taskq.py),
#: the horizon its bars were set on.
ORACLE_PICK_HORIZON = 1200


def check_taskq_rows(res, cases, pools, count: int) -> dict:
    """Every row of an exact sweep against the port's host event oracle on
    the same draws (``taskq_streams``, the same pool rows), with the bars of
    the reference's tests/test_taskq.py over that test's horizon (its first
    1,200 arrivals): per-request (n, k) equal on ≥ 0.99 of arrivals and
    mean delay within rtol 1e-2.

    The engine keeps simulated time in float32 (as the reference's does,
    bit for bit) and the oracle in float64; the engine's arrival clock, a
    float32 running sum, drifts ~1e-5 s from the oracle's over a thousand
    arrivals. Where an arrival and a task start lie that close, the backlog
    or idle count the two observe differs by one, the policy picks another
    code, and the two sample paths part for a while. So over the whole run
    the agreement and the mean's error are printed, not held."""
    from repro_torch.core import GreedyPolicy, TOFECPolicy, build_class_plan
    from repro_torch.core.simulator import simulate
    from repro_torch.taskq import taskq_streams

    out = res.to_numpy()
    h = min(ORACLE_PICK_HORIZON, count)
    worst = {"pick_agreement": 1.0, "full_run_pick_agreement": 1.0, "max_mean_rel_err": 0.0}
    for i, case in enumerate(cases):
        cls_ = case.cls
        policy = (GreedyPolicy(cls_.k_max, cls_.r_max) if case.policy.kind == "greedy"
                  else TOFECPolicy([build_class_plan(cls_, case.L)], alpha=case.policy.alpha))
        inter, idx = taskq_streams(case, count, pools.n_rows)
        host = simulate(policy, np.cumsum(inter.astype(np.float64)),
                        pools.host_sampler(cls_.file_mb, idx), L=case.L, warmup_frac=0.0)
        same = (out["n"][i] == host.ns()) & (out["k"][i] == host.ks())
        got, want = out["total"][i].astype(np.float64), host.totals()
        agree, full = float(same[:h].mean()), float(same.mean())
        rel = abs(got[:h].mean() - want[:h].mean()) / want[:h].mean()
        rel_full = abs(got.mean() - want.mean()) / want.mean()
        print(f"[taskq]   row {i:2d} {case.policy.name:6s} λ={case.lam:6.2f}: first {h} "
              f"arrivals: picks agree on {agree:.4f}, mean delay off by {rel:.3g} relative; all "
              f"{count}: {full:.4f} and {rel_full:.3g} (mean {got.mean():.5f} vs oracle "
              f"{want.mean():.5f} s)", flush=True)
        if agree < 0.99 or rel > 1e-2:
            raise AssertionError(f"taskq row {i} ({case.policy.name}, λ={case.lam:.3f}): picks "
                                 f"agree on {agree}, mean delay off by {rel:.3g} relative")
        worst["pick_agreement"] = min(worst["pick_agreement"], agree)
        worst["max_mean_rel_err"] = max(worst["max_mean_rel_err"], rel)
        worst["full_run_pick_agreement"] = min(worst["full_run_pick_agreement"], full)
        worst["full_run_max_mean_rel_err"] = max(worst.get("full_run_max_mean_rel_err", 0.0),
                                                 rel_full)
    return worst


def run_taskq(device, *, count: int = TASKQ_COUNT, fleet_tofec=None) -> dict:
    """Fig. 7's Greedy row and Fig. 9 in one exact task-engine sweep on the
    card: every row held against the host event oracle, Greedy beside the
    fleet's TOFEC row, Fig. 9's std ratio asserted, one chunk profiled."""
    from repro_torch.fleet import capacity_estimates, frontier_points
    from repro_torch.taskq import TaskqSweep

    cases, n7 = taskq_grid()
    pools = taskq_pools(device)
    sweep = TaskqSweep(chunk=TASKQ_CHUNK, device=device)
    cls_ = request_class()
    key = sweep.bucket_key(len(cases), count, L_THREADS, cls_.k_max + 1, cls_.n_max + 1,
                           pools.pools.shape)
    t0 = time.monotonic()
    res = sweep.run(cases, count, pools)
    _sync(device)
    wall_s = time.monotonic() - t0
    rec = {"cases": len(cases), "count": count, "bucket_key": list(key), "wall_s": wall_s,
           "chunks": res.launches, "bucket_uses": res.compiles, "grid": cases, "res": res,
           "pools": pools}
    print(f"[taskq] Fig. 7 Greedy + Fig. 9: {len(cases)} cases x {count} arrivals, pools "
          f"{tuple(pools.pools.shape)}, {res.launches} chunk(s), {res.compiles} bucket use(s), "
          f"key {key}, {wall_s:.3f} s wall ({wall_s / count * 1e3:.4f} ms per scan step)",
          flush=True)
    if res.launches != 1 or res.compiles != 1:
        raise AssertionError(f"expected one chunk in one bucket, got {res.launches} chunks "
                             f"and {res.compiles} bucket uses")
    pts = frontier_points(res)
    tofec = {round(p.lam, 6): p for p in fleet_tofec or []}
    for g in pts[:n7]:
        t = tofec.get(round(g.lam, 6))
        beside = (f"; fleet TOFEC mean {t.mean:.4f} p50 {t.p50:.4f} p90 {t.p90:.4f} "
                  f"p99 {t.p99:.4f}" if t else "")
        print(f"[taskq] Fig. 7 λ={g.lam:.2f}: greedy mean {g.mean:.4f} p50 {g.p50:.4f} p90 "
              f"{g.p90:.4f} p99 {g.p99:.4f} s, mean k {g.mean_k:.2f}{beside}", flush=True)
    ratios = []
    for t, g in zip(pts[n7::2], pts[n7 + 1::2]):
        ratios.append(g.std / t.std)
        print(f"[taskq] Fig. 9 λ={t.lam:.2f}: std tofec {t.std:.4f} greedy {g.std:.4f} s, "
              f"ratio {ratios[-1]:.3f}", flush=True)
    rec["fig9_std_ratio_median"] = float(np.median(ratios))
    print(f"[taskq] Fig. 9 median greedy/TOFEC std ratio {rec['fig9_std_ratio_median']:.3f} "
          "(paper: 2-3x; held > 1.2)", flush=True)
    if not rec["fig9_std_ratio_median"] > 1.2:
        raise AssertionError(f"Fig. 9: greedy/TOFEC std ratio {rec['fig9_std_ratio_median']}")
    caps, base = capacity_estimates(pts), baseline_metrics("BENCH_taskq.json")
    for name in ("greedy", "tofec"):
        print(f"[taskq] capacity {name}: {caps[name]!r} req/s (JAX CPU baseline, 20 cases x "
              f"1,000 arrivals: {base.get('capacity_req_s/' + name)!r})", flush=True)
    t0 = time.monotonic()
    rec["oracle"] = check_taskq_rows(res, cases, pools, count)
    rec["oracle_s"] = time.monotonic() - t0
    o = rec["oracle"]
    print(f"[taskq] all {len(cases)} rows vs the host event oracle, first "
          f"{ORACLE_PICK_HORIZON} arrivals: picks agree on >= {o['pick_agreement']:.6f}, mean "
          f"delay within {o['max_mean_rel_err']:.3g} relative; all {count} arrivals (printed, "
          f"not held): >= {o['full_run_pick_agreement']:.6f} and "
          f"{o['full_run_max_mean_rel_err']:.3g} ({rec['oracle_s']:.3f} s of host time)",
          flush=True)
    if device.type == "cuda":
        rec["profile"] = profile_chunk("taskq", lambda: sweep.run(cases, PROFILE_COUNT, pools),
                                       len(cases), PROFILE_COUNT)
    return rec


def run_mpc(*, count: int = TASKQ_COUNT) -> dict:
    """Fig. 7's MPC row: the host event oracle with ``MPCPolicy`` at the
    figure's 8 rates (benchmarks/common.py's ``run_policy``: Poisson
    arrivals from seed 1, the shared-key sampler, simulator seed 18)."""
    from repro_torch.core import PAPER_READ_3MB
    from repro_torch.core.controller import MPCPolicy
    from repro_torch.core.simulator import poisson_arrivals, simulate
    from repro_torch.core.traces import TraceSampler

    cls_ = request_class()
    sampler = TraceSampler(PAPER_READ_3MB, cls_.file_mb, correlation=POOL_CORRELATION)
    rec = {"rows": []}
    for lam in rate_grid(8, 0.1, 0.92):
        t0 = time.monotonic()
        arr = poisson_arrivals(np.random.default_rng(FLEET_SEED), lam, count)
        s = simulate(MPCPolicy(cls_, L_THREADS), arr, sampler, L=L_THREADS,
                     seed=FLEET_SEED + 17).summary()
        host_s = time.monotonic() - t0
        if not (np.isfinite(s["mean"]) and np.isfinite(s["p99"]) and 1 <= s["mean_k"] <= K_MAX):
            raise AssertionError(f"MPC at λ={lam:.3f}: {s}")
        rec["rows"].append({"lam": float(lam), "host_s": host_s, **s})
        print(f"[mpc] Fig. 7 λ={lam:.2f}: mean {s['mean']:.4f} p99 {s['p99']:.4f} s, mean k "
              f"{s['mean_k']:.2f}, {host_s:.3f} s of host time", flush=True)
    return rec


def sched_grid():
    """The multiclass figure's grid: two classes at 0.5/0.5 (the §V-A read
    class and read1mb with k_max 4, r_max 2, n_max 8), the 6 rates of
    ``rate_grid(6, 0.25, 0.85)``, FIFO, priority(0, 1), WFQ(1, 1), seed 1."""
    from repro_torch.core import PAPER_READ_3MB, RequestClass
    from repro_torch.fleet import TenantMix
    from repro_torch.sched import DisciplineSpec, sched_cases

    lo = RequestClass("read1mb", 1.0, PAPER_READ_3MB, k_max=4, r_max=2.0, n_max=8)
    mixes = [TenantMix(float(lam), (request_class(), lo), (0.5, 0.5))
             for lam in rate_grid(6, 0.25, 0.85)]
    discs = [DisciplineSpec.fifo(), DisciplineSpec.priority(0, 1), DisciplineSpec.wfq(1.0, 1.0)]
    return mixes, sched_cases(mixes, discs, [FLEET_SEED], L=L_THREADS)


def run_sched(device, *, count: int = SCHED_COUNT) -> dict:
    """The multiclass-disciplines figure on the card: the joint sweep, the
    Poisson-split baseline through the fleet, the interference headline
    held, a one-class mix against the fluid scan and a streamed run against
    the materialized one bit for bit, one chunk profiled."""
    from repro_torch.fleet import (FleetSweep, PolicySpec, TenantMix, frontier_points,
                                   grid_cases, tenant_cases)
    from repro_torch.sched import (DisciplineSpec, SchedCase, SchedSweep, interference_summary,
                                   multiclass_points)

    mixes, cases = sched_grid()
    sweep = SchedSweep(chunk=SCHED_CHUNK, device=device)
    t0 = time.monotonic()
    res = sweep.run(cases, count)
    _sync(device)
    wall_s = time.monotonic() - t0
    rec = {"cases": len(cases), "count": count, "wall_s": wall_s, "chunks": res.launches,
           "bucket_uses": res.compiles, "grid": cases, "res": res}
    print(f"[sched] multiclass figure: {len(cases)} cases x {count} arrivals, {res.launches} "
          f"chunk(s), {res.compiles} bucket use(s), {wall_s:.3f} s wall "
          f"({wall_s / count * 1e3:.4f} ms per scan step)", flush=True)
    if res.launches != 1 or res.compiles != 1:
        raise AssertionError(f"expected one chunk in one bucket, got {res.launches} chunks "
                             f"and {res.compiles} bucket uses")
    pts = multiclass_points(res)

    split_cases = [c for mix in mixes
                   for c in tenant_cases(mix, [PolicySpec.tofec()], [FLEET_SEED], L_THREADS,
                                         quiet=True)]
    t0 = time.monotonic()
    split_res = FleetSweep(chunk=FLEET_CHUNK, device=device).run(split_cases, count)
    _sync(device)
    rec["split_wall_s"] = time.monotonic() - t0
    # Split cases carry the per-class rate w·λ (w = 0.5): key them by λ.
    split = {(round(c.lam / 0.5, 6), c.cls.name): p
             for c, p in zip(split_cases, frontier_points(split_res))}
    print(f"[sched] Poisson-split baseline: {len(split_cases)} fleet cases in "
          f"{rec['split_wall_s']:.3f} s wall", flush=True)
    for pt in pts:
        for cl in pt.classes:
            sp = split[(round(pt.lam, 6), cl["name"])]
            print(f"[sched] {pt.discipline:13s} λ={pt.lam:6.2f} {cl['name']:8s} mean "
                  f"{cl['mean']:.4f} p99 {cl['p99']:.4f} s (split {sp.mean:.4f} / {sp.p99:.4f}), "
                  f"mean k {cl['mean_k']:.2f}, jain {pt.jain_delay:.4f}", flush=True)
    lam_max = round(max(p.lam for p in pts), 6)
    split_p99 = {cl["name"]: split[(lam_max, cl["name"])].p99 for cl in pts[-1].classes}
    head = interference_summary(pts, split_p99)
    rec["interference"] = head
    base = baseline_metrics("BENCH_multiclass.json")
    for name, e in head.items():
        print(f"[sched] interference {name}: p99 vs split {e['p99_vs_split']}, jain "
              f"{e['jain_delay']:.4f} (JAX CPU baseline at 1,200 arrivals: "
              f"{base.get(f'interference/{name}/jain_delay')!r}), p99 spread "
              f"{e['p99_spread']:.3f} (baseline {base.get(f'interference/{name}/p99_spread')!r})",
              flush=True)
    # The headline, with the bars of the reference's tests/test_sched.py: the
    # low class's joint p99 far above its split prediction, the high class's
    # near it, the starved class backing off to cheaper codes, priority
    # collapsing the fairness index; FIFO and WFQ putting both classes above
    # their split prediction, and FIFO keeping Jain above 0.95. The test's
    # WFQ Jain bar (> 0.95) was set for two identical classes; here a 3 MB
    # and a 1 MB class share the pool, so WFQ's Jain is printed, not held.
    pr = head["priority(0,1)"]["p99_vs_split"]
    prio = next(p for p in pts if p.discipline == "priority(0,1)" and round(p.lam, 6) == lam_max)
    shared = all(r > 1.0 for name in ("fifo", "wfq(1:1)")
                 for r in head[name]["p99_vs_split"].values())
    if not (pr["read1mb"] > 2.0 and pr["read3mb"] < 1.3
            and prio.cls("read1mb")["mean_k"] < prio.cls("read3mb")["mean_k"]
            and head["priority(0,1)"]["jain_delay"] < 0.8
            and shared and head["fifo"]["jain_delay"] > 0.95):
        raise AssertionError(f"the interference headline does not hold: {head}")
    print(f"[sched] headline at λ={lam_max:.2f}: priority's low class p99 {pr['read1mb']:.3f}x "
          f"its split prediction, high class {pr['read3mb']:.4f}x (held > 2, < 1.3)",
          flush=True)

    one_cases = [SchedCase(mix=TenantMix(float(lam_max), (request_class(),), (1.0,)),
                           discipline=d, seed=FLEET_SEED, L=L_THREADS)
                 for d in (DisciplineSpec.fifo(), DisciplineSpec.priority(0),
                           DisciplineSpec.wfq(1.0))]
    one = SchedSweep(chunk=4, device=device).run(one_cases, count).to_numpy()
    fl = FleetSweep(chunk=4, device=device).run(
        grid_cases([lam_max], [PolicySpec.tofec()], [FLEET_SEED], request_class(), L_THREADS),
        count).to_numpy()
    same = all(np.array_equal(one[f][g], fl[f][0]) for g in range(len(one_cases))
               for f in ("total", "queueing", "service", "n", "k"))
    print(f"[sched] one-class mix (fifo, priority, wfq) equals the fluid scan bit for bit: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("a one-class mix differs from the fluid scan")

    t0 = time.monotonic()
    streamed = sweep.run(cases, count, stream=True)
    _sync(device)
    rec["stream_wall_s"] = time.monotonic() - t0
    same = [p.to_dict() for p in multiclass_points(streamed)] == [p.to_dict() for p in pts]
    print(f"[sched] streamed run: {streamed.launches} chunk(s), {streamed.compiles} new bucket "
          f"uses, {rec['stream_wall_s']:.3f} s wall, equal to the materialized run bit for bit: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("the streamed sched sweep differs from the materialized one")
    if device.type == "cuda":
        rec["profile"] = profile_chunk("sched", lambda: sweep.run(cases, PROFILE_COUNT),
                                       len(cases), PROFILE_COUNT)
    return rec


def run_main_path(device, *, n_objects: int = 128, rounds: int = 4, per_round: int = 32,
                  file_bytes: int = FILE_BYTES, seed: int = 0) -> dict:
    """The proxy request path, end to end, at the paper's deployment.

    Writes ``n_objects`` seeded payloads through the proxy, serves
    ``rounds`` rounds of ``per_round`` raw reads through the fused serving
    step, and one fused encode round. Raises on any wrong byte or pick.
    """
    from repro_torch.coding.codec import Codec
    from repro_torch.coding.layout import layout_for_file
    from repro_torch.core import PAPER_READ_3MB, PAPER_WRITE_3MB, FeedbackPolicy, TOFECPolicy
    from repro_torch.serve.engine import FusedServingStep
    from repro_torch.storage import LatencyStore, MemoryStore, Proxy

    cls_ = request_class()
    layout = layout_for_file(file_bytes, K_MAX, R_MAX)
    codec = Codec("kernel", device=device)
    store = LatencyStore(MemoryStore(), PAPER_READ_3MB, PAPER_WRITE_3MB, time_scale=1e-3,
                         seed=seed)
    write_policy = FeedbackPolicy(layout.N, layout.K)
    proxy = Proxy(store, TOFECPolicy.for_classes([cls_], L_THREADS), L=L_THREADS, codec=codec,
                  write_policy=write_policy)
    rec: dict = {"rounds": []}
    try:
        rng = np.random.default_rng(seed)
        payloads = [rng.bytes(file_bytes) for _ in range(n_objects)]
        t0 = time.monotonic()
        reqs = [proxy.write_async(f"obj/{i}", layout, p) for i, p in enumerate(payloads)]
        results = [proxy.wait(r, timeout=600) for r in reqs]
        del reqs
        proxy.flush_writes(timeout=600)
        rec["write_s"] = time.monotonic() - t0
        if not all(r.ok for r in results):
            raise AssertionError("a proxy write failed")
        print(f"[main] wrote {n_objects} x {file_bytes} B through the proxy in "
              f"{rec['write_s']:.3f} s ({codec.stats.calls} batched encodes)", flush=True)

        step = FusedServingStep.for_class(cls_, L_THREADS, codec=codec)
        host = TOFECPolicy.for_classes([cls_], L_THREADS)
        for r in range(rounds):
            ids = list(range(r * per_round, (r + 1) * per_round))
            keys = [f"obj/{i}" for i in ids]
            t0 = time.monotonic()
            res = proxy.read_many(keys, layout, file_bytes, raw=True, timeout=600)
            t_fetch = time.monotonic() - t0
            if not all(x.ok for x in res):
                raise AssertionError(f"round {r}: a raw read failed")
            rows, present = layout.gather_rows_batch([(x.k, x.chunks) for x in res])
            t1 = time.monotonic()
            data, pick = step.decode_batch(rows, present, n=layout.N, k=layout.K, q=len(keys))
            t_step = time.monotonic() - t1
            t_round = time.monotonic() - t0
            flat = data.reshape(len(keys), -1)
            for j, i in enumerate(ids):
                if flat[j, :file_bytes].tobytes() != payloads[i]:
                    raise AssertionError(f"round {r}: object {i} decoded wrong")
            want = host.select(q=len(keys), idle=0)
            if pick != want:
                raise AssertionError(f"round {r}: device pick {pick} != host pick {want}")
            write_policy.push(*pick)
            codes = sorted({(x.n, x.k) for x in res})
            rnd = {"round": r, "round_ms": t_round * 1e3, "fetch_ms": t_fetch * 1e3,
                   "fused_step_ms": t_step * 1e3, "objects_per_s": len(keys) / t_round,
                   "payload_MB_per_s": len(keys) * file_bytes / t_round / 1e6,
                   "read_codes": codes, "next_pick": list(pick)}
            rec["rounds"].append(rnd)
            print(f"[main] round {r}: {rnd['round_ms']:.3f} ms (fetch {rnd['fetch_ms']:.3f}, "
                  f"fused step {rnd['fused_step_ms']:.3f}), {rnd['objects_per_s']:.2f} obj/s, "
                  f"{rnd['payload_MB_per_s']:.2f} MB/s payload, read codes {codes}, "
                  f"next pick {pick}", flush=True)

        data = rng.integers(0, 256, (per_round, layout.K, layout.strip_bytes), dtype=np.uint8)
        t0 = time.monotonic()
        coded, pick = step.encode_batch(data, n=layout.N, k=layout.K, q=per_round)
        rec["encode_step_ms"] = (time.monotonic() - t0) * 1e3
        if not np.array_equal(coded, Codec("numpy").encode(data, layout.N, layout.K)):
            raise AssertionError("fused encode disagrees with the numpy codec")
        want = host.select(q=per_round, idle=0)
        if pick != want:
            raise AssertionError(f"encode round: device pick {pick} != host pick {want}")
        rec["encode_pick"] = list(pick)
        print(f"[main] fused encode of {per_round} objects: {rec['encode_step_ms']:.3f} ms, "
              f"matches the numpy codec, next pick {pick}", flush=True)

        if device.type == "cuda":  # the profiler reads the card's timeline
            rec["profile"] = profile_decode(step, rows, present, layout.N, layout.K, per_round)
            want = host.select(q=per_round, idle=0)
            if tuple(rec["profile"]["pick"]) != want:
                raise AssertionError(f"profiled round: device pick {rec['profile']['pick']} "
                                     f"!= host pick {want}")
        rec["codec_calls"] = codec.stats.calls
        rec["step_launches"] = step.stats.launches
    finally:
        proxy.close()
    return rec


def profile_decode(step, rows, present, n: int, k: int, q: float) -> dict:
    """One more fused decode of the last round's rows under torch.profiler:
    its host wall time, the device time by operation (uploads, controller
    ops, K1, downloads) and the device's idle share of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, pick = step.decode_batch(rows, present, n=n, k=k, q=q)
        wall_ms = (time.monotonic() - t0) * 1e3
    # Device-side events only (kernels and copies): a CPU op's device time
    # repeats its kernels' time. Busy time is the union of their intervals.
    busy_ms, events = device_spans(prof)
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time for the fused step")
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "top": _device_top(events, 8),
           "pick": list(pick)}
    print(f"[profile] fused decode of {rows.shape[0]} objects: {wall_ms:.3f} ms wall, "
          f"{busy_ms:.3f} ms device busy, idle share {rec['device_idle_share']:.4f}", flush=True)
    for name, count, ms in rec["top"]:
        print(f"[profile]   {ms:10.4f} ms  x{count:<4d} {name}", flush=True)
    return rec


#: The closed loop (the paper's §III loop end to end): the proxy path's
#: deployment feeding qwen1.5-0.5b at full width (src/repro/configs/
#: qwen1_5_0_5b.py), 4 rounds of 32 prompts of 1,024 tokens, 32 generated.
SERVE_MODEL, SERVE_OBJECTS, SERVE_ROUNDS, SERVE_BATCH = "qwen1.5-0.5b", 128, 4, 32
SERVE_PROMPT, SERVE_STEPS = 1024, 32


def cut(arch, layers: int | None):
    """``arch`` with its depth cut to ``layers`` (as it is for None)."""
    if layers is None:
        return arch
    import dataclasses

    from repro_torch.models.registry import Arch

    return Arch(cfg=dataclasses.replace(arch.cfg, n_layers=layers), module=arch.module)


def run_serve(device, *, smoke: bool = False, model: str = SERVE_MODEL,
              layers: int | None = None, n_objects: int = SERVE_OBJECTS,
              rounds: int = SERVE_ROUNDS, per_round: int = SERVE_BATCH,
              prompt_len: int = SERVE_PROMPT, steps: int = SERVE_STEPS,
              max_seq: int | None = None, file_bytes: int = FILE_BYTES, seed: int = 0,
              obs_rounds: int = 0, tag: str = "[serve]") -> dict:
    """The closed loop through ``ClosedLoopServer`` at the proxy path's
    deployment, with ``model`` (its smoke config with ``smoke``; its depth
    cut to ``layers`` if given) on seeded random weights, the KV cache sized
    for ``max_seq`` positions (default ``prompt_len + steps``), every line
    printed under ``tag``.

    Each object's first ``prompt_len`` int32 words are seeded token ids, the
    rest seeded bytes; objects are written through the proxy, then each
    round serves ``per_round`` of them: raw reads, admission + K1 decode +
    bytes→tokens + prefill, greedy decode. Raises if a round's tokens differ
    from ``ServingEngine.generate`` over the stored prompts, a pick from the
    host TOFEC policy's, the write policy from the pick, the rounds take more
    than one shape bucket, K1 is not launched in a round, or a write after
    the loop is not coded under the fed-back code and read back byte for
    byte. On a card one more round runs under torch.profiler. K1's launches
    over all that are ``rec["k1_launches"]``.

    ``obs_rounds`` more rounds then serve the first rounds' keys again with
    telemetry collection on, through a server of their own (see
    :func:`serve_collected`), under ``rec["obs"]``."""
    import torch

    from repro_torch.coding.codec import Codec
    from repro_torch.coding.layout import layout_for_file
    from repro_torch.core import PAPER_READ_3MB, PAPER_WRITE_3MB, FeedbackPolicy, TOFECPolicy
    from repro_torch.kernels.attention.decode_attention import decode_attention
    from repro_torch.kernels.gf2mm.gf2mm import gf2_rs_matmul_bytes
    from repro_torch.kernels.ssm.mamba2_step import mamba2_step
    from repro_torch.models import get
    from repro_torch.serve import ClosedLoopServer, FusedServingStep, ServePolicy, ServingEngine
    from repro_torch.storage import LatencyStore, MemoryStore, Proxy
    from repro_torch.tree import tree_leaves

    arch = cut(get(model, smoke=smoke), layers)
    cfg = arch.cfg
    t0 = time.monotonic()
    params = arch.init(torch.Generator(device=device).manual_seed(seed))
    _sync(device)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    max_seq = max_seq or prompt_len + steps
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in tree_leaves(arch.init_cache(per_round, max_seq, device="meta")))
    rec: dict = {"model": cfg.name, "n_params": n_params, "param_bytes": param_bytes,
                 "kv_cache_bytes": kv_bytes, "init_s": time.monotonic() - t0, "rounds": []}
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; {n_params:,} parameters "
          f"({param_bytes / 1e9:.3f} GB) from seed {seed} in {rec['init_s']:.3f} s; cache "
          f"{per_round} x {max_seq} = {kv_bytes / 1e9:.3f} GB", flush=True)

    cls_ = request_class()
    layout = layout_for_file(file_bytes, K_MAX, R_MAX)
    codec = Codec("kernel", device=device)
    store = LatencyStore(MemoryStore(), PAPER_READ_3MB, PAPER_WRITE_3MB, time_scale=1e-3,
                         seed=seed)
    write_policy = FeedbackPolicy(layout.N, layout.K)
    proxy = Proxy(store, TOFECPolicy.for_classes([cls_], L_THREADS), L=L_THREADS, codec=codec,
                  write_policy=write_policy)
    try:
        rng = np.random.default_rng(seed)
        prompts = rng.integers(0, cfg.vocab, (n_objects, prompt_len), dtype=np.int32)
        t0 = time.monotonic()
        reqs = [proxy.write_async(f"lm/{i}", layout,
                                  prompts[i].tobytes() + rng.bytes(file_bytes - 4 * prompt_len))
                for i in range(n_objects)]
        if not all(proxy.wait(r, timeout=600).ok for r in reqs):
            raise AssertionError("a proxy write failed")
        proxy.flush_writes(timeout=600)
        rec["write_s"] = time.monotonic() - t0
        print(f"{tag} wrote {n_objects} x {file_bytes} B (prompts of {prompt_len} tokens) "
              f"through the proxy in {rec['write_s']:.3f} s", flush=True)

        engine = ServingEngine(arch, params, max_seq=max_seq)
        step = FusedServingStep.for_policy(ServePolicy.tofec(), cls_, L_THREADS, codec=codec)
        server = ClosedLoopServer(engine, proxy, layout, step, prompt_len=prompt_len)
        host = TOFECPolicy.for_classes([cls_], L_THREADS)

        def serve(r: int, ids: list[int], around=contextlib.nullcontext(), srv=server,
                  tag: str = tag) -> dict:
            """Round ``r`` of ``srv`` over objects ``ids`` (the round alone
            inside ``around``), checked."""
            keys = [f"lm/{i}" for i in ids]
            k1_before = gf2_rs_matmul_bytes.launches
            decode_before = (mamba2_step.launches, engine.captures, engine.eager_steps,
                             decode_attention.launches)
            with around:
                t0 = time.monotonic()
                res = srv.serve_round(keys, steps=steps)
                wall_ms = (time.monotonic() - t0) * 1e3
            k1 = gf2_rs_matmul_bytes.launches - k1_before
            if res.ok != [True] * len(keys) or res.served_keys != keys:
                raise AssertionError(f"round {r}: a prompt read failed: {res.ok}")
            want = host.select(q=len(keys), idle=0)
            if res.next_code != want:
                raise AssertionError(f"round {r}: device pick {res.next_code} != host {want}")
            if write_policy.code != res.next_code:
                raise AssertionError(f"round {r}: write policy {write_policy.code} != pick "
                                     f"{res.next_code}")
            if k1 < 1 and device.type == "cuda":  # the plain version's calls do not count
                raise AssertionError(f"round {r}: K1 was not launched")
            t0 = time.monotonic()
            direct = engine.generate(prompts[ids], steps)
            ref_ms = (time.monotonic() - t0) * 1e3
            if not np.array_equal(res.tokens, direct):
                differ = int((res.tokens != direct).sum())
                raise AssertionError(f"round {r}: closed-loop tokens differ from "
                                     f"ServingEngine.generate on {differ} of {direct.size} "
                                     "positions")
            ph = res.phase_ms
            rnd = {"round": r, "wall_ms": wall_ms, **{f"{k}_ms": v for k, v in ph.items()},
                   "generate_direct_ms": ref_ms, "k1_launches": k1,
                   "mamba2_step_launches": mamba2_step.launches - decode_before[0],
                   "decode_attention_launches": decode_attention.launches - decode_before[3],
                   "captures": engine.captures - decode_before[1],
                   "eager_steps": engine.eager_steps - decode_before[2], "tokens": res.tokens,
                   "storage_total_s": res.storage_total_s,
                   "prompt_tok_per_s": len(keys) * prompt_len / (ph["launch"] / 1e3),
                   "gen_tok_per_s": len(keys) * steps / (ph["generate"] / 1e3),
                   "read_codes": sorted({tuple(c) for c in res.codes}),
                   "next_pick": list(res.next_code)}
            print(f"{tag} round {r}: {wall_ms:.3f} ms wall; fetch {ph['fetch']:.3f} ms, fused "
                  f"launch (upload + admission + K1 + prefill) {ph['launch']:.3f} ms, generate "
                  f"{ph['generate']:.3f} ms; {rnd['prompt_tok_per_s']:.0f} prompt tok/s, "
                  f"{rnd['gen_tok_per_s']:.1f} generated tok/s; K1 launches {k1}; read codes "
                  f"{rnd['read_codes']}, pick {res.next_code} = host, = write policy; tokens "
                  f"= ServingEngine.generate ({ref_ms:.3f} ms)", flush=True)
            return rnd

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        for r in range(rounds):
            rec["rounds"].append(serve(r, list(range(r * per_round, (r + 1) * per_round))))
        if device.type == "cuda":
            rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
            print(f"{tag} peak device memory over the rounds: "
                  f"{rec['peak_mem_bytes'] / 1e9:.3f} GB", flush=True)
        # one shape bucket, and its decode step's capture where the engine replays graphs
        want_traces = 1 + engine.uses_graphs
        if server.traces != want_traces:
            raise AssertionError(f"{server.traces} shape buckets and captures for {rounds} "
                                 f"rounds, want {want_traces}")

        payload = rng.bytes(file_bytes)
        t0 = time.monotonic()
        if not proxy.wait(server.put("lm/put", payload), timeout=600).ok:
            raise AssertionError("the write after the loop failed")
        proxy.flush_writes(timeout=600)
        wres = [x for x in proxy.results if x.op == "write" and x.key == "lm/put"]
        back = proxy.read("lm/put", layout, payload_len=file_bytes, timeout=600)
        rec["put_ms"] = (time.monotonic() - t0) * 1e3
        if (wres[-1].n, wres[-1].k) != write_policy.code:
            raise AssertionError(f"the write was coded {(wres[-1].n, wres[-1].k)}, the fed-back "
                                 f"code is {write_policy.code}")
        if not (back.ok and back.data == payload):
            raise AssertionError("the write after the loop did not read back byte for byte")
        rec["put_code"] = list(write_policy.code)
        print(f"{tag} write after the loop coded {write_policy.code} (the fed-back pick), "
              f"read back byte for byte, {rec['put_ms']:.3f} ms; {server.traces} shape bucket "
              f"and decode captures for {rounds} rounds; decode steps replayed from a CUDA "
              f"graph {engine.graph_replays}, eager {engine.eager_steps}", flush=True)
        if device.type == "cuda":
            rec["profile"] = profile_serve_round(serve, engine, prompts, list(range(per_round)),
                                                 rec["rounds"][1:], steps, tag=tag)
        rec["k1_launches"] = gf2_rs_matmul_bytes.launches
        # the engine's decode steps, and the Mamba2 step kernel's launches in each round
        # that captured a decode bucket (its warm-up steps and the captured one)
        rec["decode"] = {"captures": engine.captures, "graph_replays": engine.graph_replays,
                         "eager_steps": engine.eager_steps,
                         "capture_launches": [rnd["mamba2_step_launches"]
                                              for rnd in rec["rounds"] if rnd["captures"]]}
        if obs_rounds:
            rec["obs"] = serve_collected(
                serve, ClosedLoopServer(engine, proxy, layout, step, prompt_len=prompt_len),
                rec["rounds"], obs_rounds, per_round)
    finally:
        proxy.close()
    return rec


#: Where the ``[obs]`` phase writes its artifacts (gitignored).
OBS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "obs")
#: The closed loop's delay objective for the ``[obs]`` SLO report: p99 of the
#: proxy's read delays under 1 s, judged over 2 rounds.
SERVE_SLO_S = 1.0


def _f64_buckets(delays) -> np.ndarray:
    """The delay buckets of float64 arithmetic: floor(log2(max(v, 2**-6)) · 8)
    + 48, clipped to [0, 95] (the float32 buckets' exact-math reference)."""
    from repro_torch import obs

    v = np.maximum(np.asarray(delays, np.float64), 2.0 ** -6)
    return np.clip(np.floor(np.log2(v) * 8).astype(np.int64) + 48, 0, obs.DELAY_BINS - 1)


def serve_collected(serve, server, uncollected: list[dict], rounds: int, per_round: int) -> dict:
    """``rounds`` more closed-loop rounds over the keys of the first
    uncollected ones, with telemetry on, through ``server`` (a fresh one: its
    bucket key carries the collect flag). Each round is checked as the
    others (tokens = ``ServingEngine.generate``, pick = host, K1 launched)
    and its tokens must equal the uncollected round's; then the counters
    must be exact (rounds, requested = served, no errors), every timeline
    delay row must sum to the round's batch and equal a host recount of the
    round's delays, and the server must count one bucket. Prints the SLO
    report and the ASCII dashboard; writes the metrics, SLO events,
    dashboard, flight ring and spans under :data:`OBS_DIR`."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels.gf2mm.gf2mm import gf2_rs_matmul_bytes

    obs.reset_trace()
    gf2_rs_matmul_bytes.launches = 0
    obs.set_enabled(True)
    try:
        got = [serve(r, list(range(r * per_round, (r + 1) * per_round)), srv=server,
                     tag="[obs] serve") for r in range(rounds)]
    finally:
        obs.set_enabled(None)
    rec = {"k1_launches": gf2_rs_matmul_bytes.launches, "rounds": got}
    for r, (a, b) in enumerate(zip(got, uncollected)):
        if not np.array_equal(a["tokens"], b["tokens"]):
            raise AssertionError(f"collected round {r}: tokens differ from the uncollected "
                                 "round's")
    snap = server.metrics.snapshot()
    want = {"serve_rounds": rounds, "serve_requested": rounds * per_round,
            "serve_served": rounds * per_round, "serve_decode_errors": 0}
    tl = server.timeline.snapshot()
    rows = tl["hists"]["delay"]
    recount = np.stack([np.bincount(obs.delay_bucket(torch.tensor(g["storage_total_s"])).numpy(),
                                    minlength=obs.DELAY_BINS) for g in got])
    delays = np.concatenate([g["storage_total_s"] for g in got])
    flips = int((obs.delay_bucket(torch.tensor(delays, dtype=torch.float32)).numpy()
                 != _f64_buckets(np.float32(delays))).sum())
    rec.update(counters=snap["counters"], hists=snap["hists"], highs=snap["highs"],
               bucket_flips_vs_f64=flips, buckets=server.traces)
    picks = [(i, c) for i, c in enumerate(snap["hists"]["serve_pick_n"]) if c]
    print(f"[obs] serve counters {snap['counters']}, q_hi {snap['highs']['serve_q_hi']}; "
          f"pick_n histogram nonzero {picks}; "
          f"delay rows sum {rows.sum(axis=1).tolist()}; {server.traces} bucket; K1 launches "
          f"{rec['k1_launches']} ({[g['k1_launches'] for g in got]} a round); {flips} of "
          f"{delays.size} delays in another bucket than a float64 recount gives", flush=True)
    if (snap["counters"] != want or (rows.sum(axis=1) != per_round).any()
            or not np.array_equal(rows, recount) or server.traces != 1
            or sum(snap["hists"]["serve_pick_n"]) != rounds):
        raise AssertionError(f"collected closed loop: counters {snap['counters']} (want "
                             f"{want}), delay rows {rows.sum(axis=1)}, buckets {server.traces}")
    report = obs.slo_report(tl, obs.SLOSpec(target_s=SERVE_SLO_S, percentile=0.99, window=2),
                            label="serve")
    rec["slo"] = {k: report[k] for k in ("max_burn_rate", "breach_slots", "percentile_last_s",
                                         "convergence")}
    print(f"[obs] serve SLO p99 < {SERVE_SLO_S} s over 2 rounds: max burn "
          f"{report['max_burn_rate']}, breach slots {report['breach_slots']}, last p99 "
          f"{report['percentile_last_s']} s, convergence {report['convergence']}, events "
          f"{[e['kind'] for e in report['events'].events]}", flush=True)
    for line in obs.ascii_dashboard({"serve": tl}, slo=report).splitlines():
        print(f"[obs] {line}", flush=True)
    os.makedirs(OBS_DIR, exist_ok=True)
    with open(os.path.join(OBS_DIR, "serve_metrics.prom"), "w") as f:
        f.write(obs.to_prometheus(snap, labels={"engine": "serve"}))
    report["events"].write(os.path.join(OBS_DIR, "serve_slo_events.ndjson"))
    obs.html_report(os.path.join(OBS_DIR, "serve_dashboard.html"), {"serve": tl}, slo=report,
                    meta={"device": torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu"})
    server.flight.write_trace(os.path.join(OBS_DIR, "serve_flight_trace.json"))
    obs.write_trace(os.path.join(OBS_DIR, "serve_spans.json"))
    return rec


def _device_top(events, n: int) -> list:
    """[name, count, ms] of the ``n`` device event names with the most time."""
    by_name: dict[str, list] = {}
    for ev in events:
        row = by_name.setdefault(ev.name, [ev.name, 0, 0.0])
        row[1] += 1
        row[2] += (ev.end_us - ev.start_us) / 1e3
    return sorted(by_name.values(), key=lambda r: -r[2])[:n]


def _stream_and_device_ms(fn) -> tuple[float, float, list]:
    """``fn()`` once unprofiled, timed by CUDA events (the stream clock: the
    device's work and its idle gaps), then once under torch.profiler: (stream
    ms, device busy ms under the profiler, device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_ms, events = device_spans(prof)
    return start.elapsed_time(end), busy_ms, events


def profile_serve_round(serve, engine, prompts, ids: list[int], warm: list[dict],
                        steps: int, *, tag: str = "[serve]") -> dict:
    """One more closed-loop round (``serve(r, ids, around)``, checked as the
    others) with ``serve_round`` alone under torch.profiler: its device busy
    time, its idle share against the unprofiled warm rounds' mean wall
    (``warm``; the profiler's host overhead stretches its own round's wall,
    so that share is printed beside it but not kept as the round's) and the
    largest device events. Then the round's two device phases alone on the
    same prompts, each unprofiled on the stream clock and profiled for its
    device time: the prefill, and the ``steps - 1`` decode steps a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.tree import tree_map

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rnd = serve(-1, ids, prof)
    busy_ms, events = device_spans(prof)
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time for the serve round")
    warm_ms = float(np.mean([w["wall_ms"] for w in warm]))
    copies = {n: (c, ms) for n, c, ms in _device_top(events, len(events))
              if n.startswith("Memcpy")}
    rec = {"wall_ms": rnd["wall_ms"], "warm_wall_ms": warm_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / warm_ms,
           "device_idle_share_profiled": 1.0 - busy_ms / rnd["wall_ms"],
           "device_events": len(events), "copies": copies, "top": _device_top(events, 10),
           "round": rnd}
    print(f"{tag} profiled round ({len(ids)} prompts, serve_round alone): {busy_ms:.3f} ms "
          f"device busy, {len(events)} device events; idle share "
          f"{rec['device_idle_share']:.4f} of the unprofiled warm rounds' mean wall "
          f"{warm_ms:.3f} ms ({rec['device_idle_share_profiled']:.4f} of this round's "
          f"{rnd['wall_ms']:.3f} ms, stretched by the profiler)", flush=True)
    for name, (count, ms) in sorted(copies.items()):
        print(f"{tag}   copy {ms:10.4f} ms  x{count:<5d} {name}", flush=True)
    for name, count, ms in rec["top"]:
        print(f"{tag}   {ms:10.4f} ms  x{count:<6d} {name[:140]}", flush=True)

    arch, params = engine.arch, engine.params
    toks = torch.from_numpy(prompts[ids]).to(params["embedding"]["embed"].device)
    logits, cache = arch.prefill_tokens(params, toks, max_seq=engine.max_seq)
    pre_ms, pre_busy, _ = _stream_and_device_ms(
        lambda: arch.prefill_tokens(params, toks, max_seq=engine.max_seq))

    def decode():  # on a fresh copy of the primed cache: decode_step may write in place
        engine.continue_greedy(logits, tree_map(torch.clone, cache), steps)

    dec_ms, dec_busy, dec_events = _stream_and_device_ms(decode)
    n_dec = steps - 1
    rec["prefill"] = {"stream_ms": pre_ms, "device_busy_ms": pre_busy}
    rec["decode_step"] = {"stream_ms": dec_ms / n_dec, "device_busy_ms": dec_busy / n_dec,
                          "device_share": dec_busy / dec_ms,
                          "device_events": len(dec_events) / n_dec,
                          "top": _device_top(dec_events, 6)}
    d = rec["decode_step"]
    print(f"{tag} prefill alone: {pre_ms:.3f} ms on the stream clock, {pre_busy:.3f} ms "
          f"device busy (profiled)", flush=True)
    print(f"{tag} decode alone, {n_dec} steps: {d['stream_ms']:.3f} ms a step on the stream "
          f"clock, {d['device_busy_ms']:.3f} ms device busy a step (profiled; the step's cache "
          f"clone included once in the {n_dec}), device share {d['device_share']:.4f}, "
          f"{d['device_events']:.1f} device events a step", flush=True)
    for name, count, ms in d["top"]:
        print(f"{tag}   decode {ms / n_dec:9.4f} ms a step  x{count / n_dec:<6.1f} "
              f"{name[:140]}", flush=True)
    return rec


def check_collected(tag: str, prefix: str, run, base, count: int, *, backlog: bool) -> dict:
    """One sweep again with telemetry on (``run()``), held against its
    uncollected result ``base``: outputs bit for bit, requests = G × count,
    tasks and pick histograms = a host recount of the outputs, every
    timeline row's served = count, its delay histogram = a host recount by
    the port's buckets (the card's buckets must equal the CPU's), and the
    backlog series present or absent. Then the uncollected run once more
    (wall noise). Prints the buckets where float64 arithmetic disagrees."""
    import torch

    from repro_torch import obs

    obs.set_enabled(True)
    try:
        t0 = time.monotonic()
        res = run()
        _sync(res.out["total"].device)
        wall_on = time.monotonic() - t0
    finally:
        obs.set_enabled(None)
    a, b = base.to_numpy(), res.to_numpy()
    same = all(np.array_equal(a[k], b[k]) for k in a)
    G = b["n"].shape[0]
    snap, tl = res.metrics.snapshot(), res.timeline.snapshot()
    c = snap["counters"]
    dev_buckets = obs.delay_bucket(res.out["total"]).cpu().numpy()
    cpu_buckets = obs.delay_bucket(torch.from_numpy(b["total"])).numpy()
    window, S = tl["window"], tl["capacity"]
    slot = np.arange(count) // window
    recount = np.zeros((G, S, obs.DELAY_BINS), np.int64)
    np.add.at(recount, (np.arange(G)[:, None], slot[None, :], cpu_buckets), 1)
    flips = int((cpu_buckets != _f64_buckets(b["total"])).sum())
    checks = {
        "outputs_bit_identical": same,
        "requests": c[f"{prefix}_requests"] == G * count,
        "tasks": c[f"{prefix}_tasks"] == int(b["n"].astype(np.int64).sum()),
        "pick_n": snap["hists"][f"{prefix}_pick_n"] == np.bincount(
            b["n"].ravel(), minlength=obs.PICK_BINS).tolist(),
        "pick_k": snap["hists"][f"{prefix}_pick_k"] == np.bincount(
            b["k"].ravel(), minlength=obs.PICK_BINS).tolist(),
        "served": bool((tl["series"]["served"].sum(axis=1) == count).all()),
        "delay_hist": np.array_equal(tl["hists"]["delay"], recount),
        "card_buckets_eq_cpu": np.array_equal(dev_buckets, cpu_buckets),
        "backlog_series": ("backlog" in tl["series"]) == backlog,
    }
    t0 = time.monotonic()
    run()
    _sync(res.out["total"].device)
    wall_off2 = time.monotonic() - t0
    rec = {"wall_on_s": wall_on, "wall_off2_s": wall_off2, "counters": c, "checks": checks,
           "bucket_flips_vs_f64": flips, "slots": [window, S], "result": res}
    print(f"[obs] {tag}: collected {wall_on:.3f} s wall, uncollected again {wall_off2:.3f} s; "
          f"counters {c}; timeline {G} x {S} slots of {window}; {flips} of {b['total'].size} "
          f"delays in another bucket than a float64 recount gives; checks {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag} collection: {checks}")
    return rec


def run_obs_sweeps(device, fleet: dict, taskq: dict, sched: dict) -> dict:
    """The ``[obs]`` phase's sweeps: Fig. 7's fleet grid, the taskq grid and
    the multiclass grid again with telemetry on (:func:`check_collected`),
    the exact engine's cancellation split and idle histogram held (and on a
    card a collected 500-arrival taskq chunk profiled), and the
    taskq row with the worst mean delay replayed with the flight recorder
    (its delays equal to the sweep cell's); writes the flight records,
    trace and the taskq artifact with its flight block under
    :data:`OBS_DIR`."""
    from repro_torch import obs
    from repro_torch.fleet import FleetSweep
    from repro_torch.sched import SchedSweep
    from repro_torch.taskq import TaskqSweep, write_taskq_artifact

    rec = {"fleet": check_collected(
        "fleet Fig. 7", "fleet",
        lambda: FleetSweep(chunk=FLEET_CHUNK, device=device).run(fleet["grid"], fleet["count"]),
        fleet["res"], fleet["count"], backlog=True)}
    pools = taskq["pools"]
    tq = TaskqSweep(chunk=TASKQ_CHUNK, device=device)
    rec["taskq"] = check_collected(
        "taskq Fig. 7 Greedy + Fig. 9", "taskq",
        lambda: tq.run(taskq["grid"], taskq["count"], pools), taskq["res"], taskq["count"],
        backlog=True)
    c = rec["taskq"]["counters"]
    idle = rec["taskq"]["result"].metrics.snapshot()["hists"]["taskq_idle"]
    G, count = taskq["cases"], taskq["count"]
    print(f"[obs] taskq cancellations {c['taskq_cancelled']} = queued "
          f"{c['taskq_cancel_queue']} + in service {c['taskq_cancel_service']}; idle histogram "
          f"({len(idle)} bins) sums to {sum(idle)} = {G} x {count}", flush=True)
    if (c["taskq_cancelled"] != c["taskq_cancel_queue"] + c["taskq_cancel_service"]
            or sum(idle) != G * count or len(idle) != L_THREADS + 1):
        raise AssertionError(f"taskq cancellation split or idle histogram: {c}, {sum(idle)}")
    if device.type == "cuda":  # device kernels a step with collection on (off: [profile])
        obs.set_enabled(True)
        try:
            rec["taskq"]["profile"] = profile_chunk(
                "taskq collected", lambda: tq.run(taskq["grid"], PROFILE_COUNT, pools),
                G, PROFILE_COUNT)
        finally:
            obs.set_enabled(None)
    rec["sched"] = check_collected(
        "sched multiclass", "sched",
        lambda: SchedSweep(chunk=SCHED_CHUNK, device=device).run(sched["grid"], sched["count"]),
        sched["res"], sched["count"], backlog=False)

    out = taskq["res"].to_numpy()
    worst = int(np.argmax(out["total"].mean(axis=1)))
    t0 = time.monotonic()
    log = tq.replay_flight(taskq["res"], pools, worst)
    replay_s = time.monotonic() - t0
    np.testing.assert_allclose(log.total, out["total"][worst], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(log.n, out["n"][worst])
    ex = log.exemplars(3)
    os.makedirs(OBS_DIR, exist_ok=True)
    log.write_ndjson(os.path.join(OBS_DIR, "taskq_flight.ndjson"))
    log.write_trace(os.path.join(OBS_DIR, "taskq_flight_trace.json"))
    art = write_taskq_artifact(os.path.join(OBS_DIR, "BENCH_taskq.json"), taskq["res"],
                               flight=log)
    rec["flight"] = {"row": worst, "replay_s": replay_s, **art["flight"]}
    print(f"[obs] flight replay of taskq row {worst} ({log.label}, the worst mean delay): "
          f"{replay_s:.3f} s, {len(log)} requests, {art['flight']['records']} task records, "
          f"delays equal to the sweep cell's; slowest requests {art['flight']['exemplar_reqs']}",
          flush=True)
    for line in obs.exemplar_panel(ex, width=60).splitlines():
        print(f"[obs]   {line}", flush=True)
    return rec


def run_obs_profile(device, fleet: dict, *, strip_bytes: int = FILE_BYTES // K_MAX) -> dict:
    """``profile_launch`` of K1 at the decode shape (its operations against
    the int8 peak) and of one fluid-scan case (the Fig. 7 grid's TOFEC row
    at its highest rate, 3,500 arrivals); prints ``format_profile`` and
    holds every ``frac_peak`` at or under 1.05."""
    import torch

    from repro_torch import obs
    from repro_torch.core.fluid_scan import FluidScanParams, tofec_scan_core
    from repro_torch.fleet import policy_tables
    from repro_torch.kernels.gf2mm.gf2mm import gf2_rs_matmul_bytes

    obs.reset_profiles()
    gen = torch.Generator(device=device).manual_seed(3)
    bitmats = torch.randint(0, 2, (32, 64, 8 * K_MAX), dtype=torch.uint8, device=device,
                            generator=gen)
    data = torch.randint(0, 256, (32, K_MAX, strip_bytes), dtype=torch.uint8, device=device,
                         generator=gen)
    obs.profile_launch("k1.decode", gf2_rs_matmul_bytes, bitmats, data, warmup=2, iters=10,
                       peak_flops=INT8_OPS_PER_S)
    case = max((c for c in fleet["grid"] if c.policy.kind == "tofec"), key=lambda c: c.lam)
    inter, exps = case.resolved_workload().device_arrays(np.random.default_rng(case.seed),
                                                         fleet["count"], case.cls.n_max)
    p = FluidScanParams.from_class(case.cls, case.L, case.policy.alpha).rows(1, device)
    h_k, h_n, r_max = policy_tables(case.policy, case.cls, case.L)

    def up(a):
        return torch.as_tensor(np.asarray(a, np.float32))[None].to(device)

    obs.profile_launch("fluid_scan.case", tofec_scan_core, p, up(h_k), up(h_n),
                       up(np.float32(r_max)), up(inter), up(exps), n_max=case.cls.n_max,
                       warmup=0, iters=2)
    snap = obs.profile_snapshot()
    print(f"[obs] profile (K1 at (32, 64, 48) x (32, 6, {strip_bytes:,}), operations against the "
          f"int8 peak; fluid scan: the TOFEC row at λ={case.lam:.2f}, {fleet['count']} "
          "arrivals)", flush=True)
    for line in obs.format_profile(snap).splitlines():
        print(f"[obs]   {line}", flush=True)
    bad = {k: r["frac_peak"] for k, r in snap.items() if not r["frac_peak"] <= 1.05}
    if bad:
        raise AssertionError(f"frac_peak above 1.05: {bad}")
    return snap


#: The ``[shard]`` phase's mesh: the card twice, so every launch's grid rows
#: are cut in two halves that run one after the other (no speedup claimed).
SHARD_DEVICES = 2


def run_shard(device, fleet: dict, taskq: dict, sched: dict) -> dict:
    """Grid sharding on the card: the fleet, taskq and sched grids of the
    ``[fleet]``, ``[taskq]`` and ``[sched]`` phases again on a mesh that
    repeats the card, each output array bit-equal to the phase's own
    unsharded result and ``stats.by_mesh == {(2,): 1}``; a streamed +
    sharded fleet run's frontier equal to the unsharded one; a ``chunk=6``
    fleet run on a 4-entry mesh padded to 8 rows, its real rows equal to
    the unsharded run's. Each run's wall time is printed beside the
    unsharded one's."""
    from repro_torch.fleet import FleetSweep, convergence_stats, frontier_points
    from repro_torch.sched import SchedSweep
    from repro_torch.taskq import TaskqSweep

    mesh = [device] * SHARD_DEVICES
    runs = (("fleet", fleet, FleetSweep(chunk=FLEET_CHUNK, mesh=mesh), ()),
            ("taskq", taskq, TaskqSweep(chunk=TASKQ_CHUNK, mesh=mesh), (taskq.get("pools"),)),
            ("sched", sched, SchedSweep(chunk=SCHED_CHUNK, mesh=mesh), ()))
    rec = {}
    for name, base, sweep, extra in runs:
        t0 = time.monotonic()
        res = sweep.run(base["grid"], base["count"], *extra)
        _sync(device)
        wall_s = time.monotonic() - t0
        want = base["res"].out
        equal = set(res.out) == set(want) and all(torch_equal(res.out[k], want[k]) for k in want)
        rec[name] = {"wall_s": wall_s, "unsharded_wall_s": base["wall_s"], "equal": equal,
                     "launches": res.launches, "by_mesh": dict(sweep.stats.by_mesh)}
        print(f"[shard] {name}: {len(base['grid'])} cases x {base['count']} arrivals on the "
              f"mesh {[str(d) for d in sweep.mesh.devices]}: {res.launches} launches of "
              f"{SHARD_DEVICES} slices, {wall_s:.3f} s wall against the unsharded "
              f"{base['wall_s']:.3f} s (one card runs the slices one after the other); every "
              f"output array bit-equal to the unsharded run's: {equal}; by_mesh "
              f"{sweep.stats.by_mesh}", flush=True)
        if not equal or sweep.stats.by_mesh != {(SHARD_DEVICES,): 1}:
            raise AssertionError(f"[shard] {name}: equal {equal}, by_mesh "
                                 f"{sweep.stats.by_mesh}")
        if name == "fleet":
            t0 = time.monotonic()
            st = sweep.run(base["grid"], base["count"], stream=True)
            _sync(device)
            same = ([p.to_dict() for p in frontier_points(st)]
                    == [p.to_dict() for p in frontier_points(base["res"])]
                    and convergence_stats(st) == convergence_stats(base["res"]))
            rec["fleet"]["stream_wall_s"] = time.monotonic() - t0
            print(f"[shard] fleet streamed + sharded: {rec['fleet']['stream_wall_s']:.3f} s wall "
                  f"(unsharded streamed {base['stream_wall_s']:.3f} s); frontier points and "
                  f"convergence equal to the unsharded run's: {same}", flush=True)
            if not same:
                raise AssertionError("[shard] the streamed + sharded fleet run differs")

    cases = fleet["grid"][:5]
    sweep = FleetSweep(chunk=6, mesh=[device] * 4)
    cls_ = cases[0].cls
    key = sweep.bucket_key(len(cases), fleet["count"], cls_.n_max, cls_.k_max + 1,
                           cls_.n_max + 1)
    res = sweep.run(cases, fleet["count"])
    want = fleet["res"].out
    same = all(torch_equal(res.out[k], want[k][:5]) for k in want)
    print(f"[shard] chunk=6 on a 4-entry mesh: chunk {key[0]}, {res.launches} launch; the 5 "
          f"real rows equal to the unsharded run's: {same}", flush=True)
    if key[0] != 8 or res.launches != 1 or not same:
        raise AssertionError(f"[shard] chunk=6 on 4 devices: chunk {key[0]}, {res.launches} "
                             f"launches, real rows equal {same}")
    rec["chunk6"] = {"chunk": key[0], "equal": same}
    return rec


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


#: ``[launch]``: the four production cells of ``SERVE_MODEL`` planned on the
#: 16 x 16 H100 mesh.
LAUNCH_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def run_launch(serve: dict, train: dict, families: dict) -> dict:
    """The launch plan: (a) ``SERVE_MODEL``'s four cells planned on the
    16 x 16 H100 mesh with ``run_cell`` (spec count, per-device argument
    bytes, the three roofline terms, the dominant one); (b) the one-card
    roofline of the runs this smoke measured — the ``[serve]`` prefill at 32
    x 1,024 and its decode step, the ``[train]`` step at 4,096 x 2 and the
    zamba2 prefill of ``[families]`` at 32 x 1,024 — each counted on
    ``meta`` at its real shape and chunks, beside its measured device busy
    time. Every count must be positive and every term finite, and no busy
    time may beat the counted FLOPs at the bfloat16 peak. The memory term's
    fraction is printed, not held: the L2 can serve small re-reads."""
    import math

    import torch

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.specs import dryrun_target
    from repro_torch.models import ShapeSpec, get
    from repro_torch.obs.profile import HBM_BW, PEAK_FLOPS, count_work

    rec = {"cells": {}, "one_card": {}}
    for shape in LAUNCH_SHAPES:
        t0 = time.monotonic()
        r = run_cell(SERVE_MODEL, shape, save=False)
        rec["cells"][shape] = r
        if r["status"] == "skipped":
            print(f"[launch] {SERVE_MODEL} x {shape} on 16x16 H100s: skipped ({r['reason']})",
                  flush=True)
            continue
        ro = r["roofline"]
        terms = (ro["t_compute_s"], ro["t_memory_s"], ro["t_collective_s"])
        print(f"[launch] {SERVE_MODEL} x {shape} on 16x16 H100s: {r['n_specs']} specs, "
              f"{r['memory']['argument_size_b'] / 1e9:.4f} GB of arguments a device (fits "
              f"80 GiB: {r['fits']}), {ro['flops']:.4e} FLOPs, {ro['hbm_bytes']:.4e} bytes, "
              f"t_compute {terms[0] * 1e3:.4f} ms, t_memory {terms[1] * 1e3:.4f} ms, "
              f"t_collective {terms[2] * 1e3:.4f} ms (modelled), dominant {ro['dominant']} "
              f"({time.monotonic() - t0:.1f} s to plan and count)", flush=True)
        if r["status"] != "ok" or not (ro["flops"] > 0 and ro["hbm_bytes"] > 0) \
                or not all(math.isfinite(t) for t in terms):
            raise AssertionError(f"[launch] {SERVE_MODEL} x {shape}: {r}")

    def prefill(model: str, rows: int, prompt: int, max_seq: int):
        arch = get(model)
        params = arch.init(device="meta")
        toks = torch.empty((rows, prompt), dtype=torch.int32, device="meta")
        return lambda: arch.prefill_tokens(params, toks, max_seq=max_seq)

    def decode(model: str, max_seq: int):
        arch = get(model)
        params = arch.init(device="meta")
        cache = arch.init_cache(SERVE_BATCH, max_seq, device="meta")
        token = torch.empty((SERVE_BATCH, 1), dtype=torch.int32, device="meta")
        return lambda: arch.decode_step(params, token, cache)

    def train_step():
        fn, args, _ = dryrun_target(SERVE_MODEL, ShapeSpec("train", "train", TRAIN_SEQ,
                                                           TRAIN_BATCH), None)
        return lambda: fn(*args)

    _, _, z_rows, z_prompt, z_max_seq = next(f for f in FAMILY_SERVES if f[0] == "zamba2-2.7b")
    cases = (
        (f"{SERVE_MODEL} prefill {SERVE_BATCH}x{SERVE_PROMPT}",
         prefill(SERVE_MODEL, SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT + SERVE_STEPS),
         serve["profile"]["prefill"]["device_busy_ms"]),
        (f"{SERVE_MODEL} decode step, {SERVE_BATCH} rows",
         decode(SERVE_MODEL, SERVE_PROMPT + SERVE_STEPS),
         serve["profile"]["decode_step"]["device_busy_ms"]),
        (f"{SERVE_MODEL} train step {TRAIN_SEQ}x{TRAIN_BATCH}", train_step(),
         train["profile"]["busy_ms"]),
        (f"zamba2-2.7b prefill {z_rows}x{z_prompt}",
         prefill("zamba2-2.7b", z_rows, z_prompt, z_max_seq),
         families["serve"]["zamba2-2.7b"]["profile"]["prefill"]["device_busy_ms"]),
    )
    for label, fn, busy_ms in cases:
        flops, nbytes = count_work(fn)
        t_c, t_m = flops / PEAK_FLOPS * 1e3, nbytes / HBM_BW * 1e3
        frac = busy_ms / max(t_c, t_m)
        rec["one_card"][label] = {"flops": flops, "bytes": nbytes, "t_compute_ms": t_c,
                                  "t_memory_ms": t_m, "busy_ms": busy_ms,
                                  "busy_over_bound": frac}
        print(f"[launch] one card, {label}: {flops:.4e} FLOPs, {nbytes:.4e} bytes counted on "
              f"meta; t_compute {t_c:.4f} ms, t_memory {t_m:.4f} ms, measured busy "
              f"{busy_ms:.4f} ms = {frac:.3f}x max(t_compute, t_memory); busy / t_memory "
              f"{busy_ms / t_m:.3f} (printed, not held)", flush=True)
        if not (flops > 0 and nbytes > 0 and math.isfinite(t_c) and math.isfinite(t_m)):
            raise AssertionError(f"[launch] {label}: a count is not positive and finite")
        if busy_ms < t_c:
            raise AssertionError(f"[launch] {label}: {busy_ms} ms busy beats the counted "
                                 f"FLOPs at the bfloat16 peak ({t_c} ms): the count is wrong")
    return rec


#: The ``[train]`` phase: ``SERVE_MODEL`` at full width trained at the repo's
#: ``train_4k`` sequence length, batch cut from the pod cell's 256 to 2 for
#: one card; 6 straight steps, 3 + restart + 3 with strips lost.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY = 4096, 2, 6, 3
#: Strips lost from every leaf before the restart (n − k = 4 may go).
TRAIN_LOST = ("strip0", "strip2")


def _timer(device):
    """A stopwatch on the stream clock (CUDA events) on a card, on the host
    clock otherwise: ``start()`` returns ``stop``; ``stop()`` ends the
    interval and returns a function that reads its ms (after the device
    has got there)."""
    import torch

    def start():
        if device.type != "cuda":
            t0 = time.monotonic()

            def stop_host():
                ms = (time.monotonic() - t0) * 1e3
                return lambda: ms
            return stop_host
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()

        def stop():
            end.record()

            def read():
                end.synchronize()
                return begin.elapsed_time(end)
            return read
        return stop
    return start


class _Tally:
    """Wall seconds, calls and bytes of the methods ``wrap``ped on objects,
    by name (the checkpoint's store puts and gets, the codec's encode and
    decode), plus K1's time on the stream clock. The wrappers are instance
    attributes; ``unwrap`` removes them."""

    def __init__(self):
        self.wrapped: list = []
        self._reset()

    def _reset(self) -> None:
        self.s: dict[str, float] = {}
        self.n: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.k1_events: list = []

    def unwrap(self) -> None:
        for obj, name in self.wrapped:
            delattr(obj, name)
        self.wrapped = []

    def wrap(self, obj, name: str, nbytes=None):
        fn = getattr(obj, name)
        self.wrapped.append((obj, name))

        def timed(*args, **kwargs):
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            self.s[name] = self.s.get(name, 0.0) + time.monotonic() - t0
            self.n[name] = self.n.get(name, 0) + 1
            if nbytes is not None:
                self.bytes[name] = self.bytes.get(name, 0) + nbytes(args, out)
            return out

        setattr(obj, name, timed)

    def wrap_k1(self, backend):
        """K1 inside the codec's kernel backend, between CUDA events (read
        after the work has finished)."""
        import torch

        fn = backend.matmul_prepped
        self.wrapped.append((backend, "matmul_prepped"))

        def timed(bitmats, data):
            if data.device.type != "cuda":
                return fn(bitmats, data)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            out = fn(bitmats, data)
            end.record()
            self.k1_events.append((begin, end))
            return out

        backend.matmul_prepped = timed

    def take(self) -> dict:
        """The totals since the last ``take``, then reset."""
        out = {"s": dict(self.s), "n": dict(self.n), "bytes": dict(self.bytes),
               "k1_ms": sum(b.elapsed_time(e) for b, e in self.k1_events),
               "k1_calls": len(self.k1_events)}
        self._reset()
        return out


def _rss_peak_gb() -> float:
    """This process's peak resident set, GB (``ru_maxrss`` is in KiB on
    Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _mem_total_gb() -> float:
    """The host's ``MemTotal``, GB."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemTotal in /proc/meminfo")


def run_train(device, *, smoke: bool = False, model: str = SERVE_MODEL,
              layers: int | None = None, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
              seed: int = 0, tag: str = "[train]") -> dict:
    """The training path through ``Trainer`` with ``model`` (its smoke
    config with ``smoke``; its depth cut to ``layers`` if given) on seeded
    random weights, every line printed under ``tag``, erasure-coded
    checkpoints through ``AsyncCheckpointer`` (K1 encode on a card) and a
    restart from 6 of 8 strips (K1 decode).

    A: 6 steps straight, checkpoints at 3 and 6. B: 3 steps, checkpoint at
    3; strips 0 and 2 of every leaf lost; a trainer rebuilt from the store
    alone resumes at step 3 and runs 3 more. Raises if a loss is not finite,
    a crc fails, the restart starts elsewhere, B's final loss is not A's to
    rel = 1e-4, or a shard written through ``store_coded_object`` does not
    read back through the proxy byte for byte. Prints each step's stream
    time, tokens/s, loss and grad norm, peak device memory, each
    checkpoint's save split (host snapshot, encode with K1's stream time
    and launches, store puts; crc timed apart on the same bytes), the
    restore's split (fetch, decode, crc) and the bytes written; on a card
    one more step runs under torch.profiler."""
    import zlib

    import torch

    from repro_torch.ckpt import latest_step
    from repro_torch.coding.codec import get_codec, pow2_bucket
    from repro_torch.coding.layout import layout_for_file
    from repro_torch.core import StaticPolicy
    from repro_torch.data import CodedShardReader
    from repro_torch.kernels.gf2mm.gf2mm import gf2_rs_matmul_bytes
    from repro_torch.models import get
    from repro_torch.models.config import ShapeSpec
    from repro_torch.storage import FaultyStore, MemoryStore, Proxy
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten

    arch = cut(get(model, smoke=smoke), layers)
    cfg = arch.cfg
    shape = ShapeSpec("train_4k_cut", "train", seq=seq, batch=batch)
    tc = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, log_every=1,
                       seed=seed)
    clock = _timer(device)
    clock_name = "stream" if device.type == "cuda" else "host"
    tally = _Tally()
    codec = get_codec(device=device)  # the instance save/restore_checkpoint use
    tally.wrap(codec, "encode_blobs")
    tally.wrap(codec, "decode")
    tally.wrap_k1(codec.backend)
    k1_start = gf2_rs_matmul_bytes.launches

    def store():
        s = MemoryStore()
        tally.wrap(s, "put", lambda args, out: len(args[1]))
        tally.wrap(s, "get", lambda args, out: len(out))
        return s

    def instrument(t, run_tag: str, steps: list) -> None:
        """Step times on the stream clock and the snapshot's host time."""
        step_fn, submit = t.step_fn, t.ckpt.submit

        def step(*args):
            stop = clock()
            out = step_fn(*args)
            steps.append(stop())
            return out

        def snap(step_no, tree):
            t0 = time.monotonic()
            submit(step_no, tree)
            snaps.append((run_tag, step_no, time.monotonic() - t0))

        t.step_fn, t.ckpt.submit = step, snap

    snaps: list = []
    rec: dict = {"model": cfg.name, "seq": seq, "batch": batch, "runs": {}}

    def train(run_tag: str, t, steps: int | None) -> list[dict]:
        stops: list = []
        instrument(t, run_tag, stops)
        tally.take()
        k1_before = gf2_rs_matmul_bytes.launches
        t0 = time.monotonic()
        log = t.run(steps)
        wall = time.monotonic() - t0
        ms = [s() for s in stops]
        save = tally.take()
        for r, step_ms in zip(log, ms):
            r["ms"] = step_ms
            r["tok_per_s"] = batch * seq / (step_ms / 1e3)
            if not np.isfinite(r["loss"]) or not np.isfinite(r["grad_norm"]):
                raise AssertionError(f"{tag} {run_tag}: step {r['step']} loss {r['loss']}")
            print(f"{tag} {run_tag} step {r['step']}: {step_ms:.3f} ms ({clock_name} clock), "
                  f"{r['tok_per_s']:.0f} tokens/s, loss {r['loss']:.6f}, grad norm "
                  f"{r['grad_norm']:.6f}", flush=True)
        ck = [s for s in snaps if s[0] == run_tag]
        run = {"log": log, "wall_s": wall, "save": save, "snapshot_s": [s[2] for s in ck],
               "k1_launches": gf2_rs_matmul_bytes.launches - k1_before}
        print(f"{tag} {run_tag}: {len(log)} steps in {wall:.3f} s wall; {len(ck)} checkpoint(s) "
              f"at steps {[s[1] for s in ck]}: host snapshot {sum(run['snapshot_s']):.3f} s, "
              f"encode {save['s'].get('encode_blobs', 0):.3f} s ({save['n'].get('encode_blobs', 0)} "
              f"calls; K1 {save['k1_ms']:.3f} ms stream, {run['k1_launches']} launches), store "
              f"puts {save['s'].get('put', 0):.3f} s for {save['bytes'].get('put', 0) / 1e9:.3f} GB "
              f"in {save['n'].get('put', 0)} objects", flush=True)
        rec["runs"][run_tag] = run
        return log

    def manifest(s, prefix: str, step: int) -> dict:
        return json.loads(s.get(f"{prefix}/step{step}/MANIFEST").decode())

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    store_a = store()
    t_a = Trainer(arch, shape, store_a, cfg=tc, ckpt_prefix="a", device=device)
    n_params = sum(t.numel() for _, t in tree_flatten(t_a.params))
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params:,} "
          f"parameters ({cfg.dtype}) from seed {seed}; seq {seq} x batch {batch} = "
          f"{seq * batch} tokens a step; remat {cfg.remat_policy}, AdamW defaults; host "
          f"MemTotal {_mem_total_gb():.1f} GB", flush=True)
    log_a = train("A", t_a, None)
    if device.type == "cuda":
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
        print(f"{tag} peak device memory over run A: {rec['peak_mem_bytes'] / 1e9:.3f} GB",
              flush=True)
    man = manifest(store_a, "a", TRAIN_STEPS)
    leaves = man["leaves"]
    payload = sum(m["bytes"] for m in leaves.values())
    groups = {(m["n"], m["k"], pow2_bucket(m["strip_bytes"], 128)) for m in leaves.values()}
    rec.update(n_params=n_params, leaves=len(leaves), payload_bytes=payload,
               encode_groups=len(groups))
    print(f"{tag} one checkpoint: {len(leaves)} leaves, {payload / 1e9:.3f} GB of payload, "
          f"{sum(m['n'] * m['strip_bytes'] for m in leaves.values()) / 1e9:.3f} GB of strips at "
          f"(n, k) {sorted({(m['n'], m['k']) for m in leaves.values()})}, {len(groups)} encode "
          f"groups (one K1 launch each)", flush=True)
    # crc32 timed apart over the bytes the checkpoint hashes (the final state).
    crc_s = 0.0
    for _, leaf in tree_flatten({"params": t_a.params, "opt": t_a.opt_state}):
        host = leaf.detach().cpu().reshape(-1).view(torch.uint8).numpy()
        t0 = time.monotonic()
        zlib.crc32(host)
        crc_s += time.monotonic() - t0
        del host
    rec["crc_s"] = crc_s
    print(f"{tag} crc32 of one checkpoint's {payload / 1e9:.3f} GB, timed apart on the same "
          f"bytes: {crc_s:.3f} s (host)", flush=True)
    t_a.ckpt.close()
    final_a = log_a[-1]["loss"]
    del t_a, store_a  # A's 2 checkpoints leave host memory before B writes its own

    store_b = store()
    t_b = Trainer(arch, shape, store_b, cfg=tc, ckpt_prefix="b", device=device)
    train("B", t_b, TRAIN_CKPT_EVERY)
    t_b.ckpt.close()
    del t_b
    if latest_step(store_b, "b") != TRAIN_CKPT_EVERY:
        raise AssertionError(f"{tag} B's latest checkpoint is {latest_step(store_b, 'b')}")
    faulty = FaultyStore(store_b)
    lost = [key for key in store_b.keys() if key.endswith(TRAIN_LOST)]
    for key in lost:
        faulty.lose_object(key)
    dec_groups = {(m["n"], m["k"], m["strip_bytes"])
                  for m in manifest(store_b, "b", TRAIN_CKPT_EVERY)["leaves"].values()}
    tally.take()
    k1_before = gf2_rs_matmul_bytes.launches
    t0 = time.monotonic()
    t_b2 = Trainer(arch, shape, faulty, cfg=tc, ckpt_prefix="b", device=device)
    _sync(device)
    restore_s = time.monotonic() - t0
    res = tally.take()
    if t_b2.start_step != TRAIN_CKPT_EVERY:
        raise AssertionError(f"{tag} the restart starts at {t_b2.start_step}")
    rec["restore"] = {"wall_s": restore_s, "fetch_s": res["s"].get("get", 0.0),
                      "fetched_bytes": res["bytes"].get("get", 0),
                      "decode_s": res["s"].get("decode", 0.0), "k1_ms": res["k1_ms"],
                      "k1_launches": gf2_rs_matmul_bytes.launches - k1_before,
                      "decode_groups": len(dec_groups), "lost_objects": len(lost)}
    r = rec["restore"]
    print(f"{tag} restart from store B with {len(lost)} strips lost (strips 0 and 2 of "
          f"every leaf): start_step {t_b2.start_step}, every crc held; restore {restore_s:.3f} "
          f"s wall: fetch {r['fetch_s']:.3f} s ({r['fetched_bytes'] / 1e9:.3f} GB), decode "
          f"{r['decode_s']:.3f} s (K1 {r['k1_ms']:.3f} ms stream, {r['k1_launches']} launches "
          f"for {len(dec_groups)} groups), the rest (crc, upload) "
          f"{restore_s - r['fetch_s'] - r['decode_s']:.3f} s", flush=True)
    log_b = train("B2", t_b2, TRAIN_STEPS - TRAIN_CKPT_EVERY)
    final_b = log_b[-1]["loss"]
    rel = abs(final_b - final_a) / abs(final_a)
    rec.update(final_a=final_a, final_b=final_b, rel_diff=rel)
    print(f"{tag} final loss: straight {final_a!r}, restarted {final_b!r}, relative "
          f"difference {rel:.3e} (bar 1e-4)", flush=True)
    if log_b[-1]["step"] != TRAIN_STEPS or not rel <= 1e-4:
        raise AssertionError(f"{tag} the restarted run ends at step {log_b[-1]['step']} with "
                             f"loss {final_b}, the straight run's is {final_a}")

    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile as torch_profile

        batch_t = {k: torch.from_numpy(v).to(device)
                   for k, v in t_b2.data.batch_at(TRAIN_STEPS).items()}
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            t_b2.step_fn(t_b2.params, t_b2.opt_state, batch_t)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        busy_ms, events = device_spans(prof)
        top = _device_top(events, 5)
        # Idle share against the unprofiled steps' stream time (the profiler
        # stretches its own step's wall), as the [serve] phase reports it.
        warm = [r["ms"] for tag in ("B", "B2") for r in rec["runs"][tag]["log"]]
        step_ms = float(np.median(warm))
        rec["profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "step_ms": step_ms,
                          "idle_share": 1.0 - busy_ms / step_ms,
                          "idle_share_profiled": 1.0 - busy_ms / wall_ms, "top": top,
                          "events": len(events)}
        print(f"{tag} one step under torch.profiler: {busy_ms:.3f} ms device busy against "
              f"the unprofiled steps' median {step_ms:.3f} ms (stream clock): idle share "
              f"{rec['profile']['idle_share']:.4f}; the profiled step's own wall {wall_ms:.3f} "
              f"ms (idle {rec['profile']['idle_share_profiled']:.4f}), {len(events)} device "
              f"events; the five with the most device time:", flush=True)
        for name, n, ms in top:
            print(f"{tag}   {ms:10.3f} ms  x{n:<5d} {name[:100]}", flush=True)
    t_b2.ckpt.close()
    del t_b2, faulty, store_b

    # One CodedShardReader shard of 2 x 4,097 tokens through the proxy.
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    layout = layout_for_file(tokens.size * 4, K_MAX, R_MAX)
    shard_store = MemoryStore()
    proxy = Proxy(shard_store, StaticPolicy(layout.N, layout.K), L=L_THREADS, codec=codec)
    try:
        keys = CodedShardReader.write_shards(shard_store, layout, [tokens], "data", codec=codec)
        reader = CodedShardReader(proxy, layout, keys, tokens_per_shard=tokens.size, prefetch=1)
        key, got = reader.next_shard(timeout=120)
        reader.close()
        reader._thread.join(timeout=120)
        if key != keys[0] or got.tobytes() != tokens.tobytes():
            raise AssertionError(f"{tag} the coded shard did not read back byte for byte")
    finally:
        proxy.close()
    print(f"{tag} one CodedShardReader shard of {batch} x {seq + 1} tokens "
          f"({tokens.size * 4:,} B) written through store_coded_object at "
          f"({layout.N}, {layout.K}) and read back through the proxy byte for byte", flush=True)

    rec["k1_launches"] = gf2_rs_matmul_bytes.launches - k1_start
    tally.unwrap()  # the codec is the process-wide instance
    rec["rss_peak_gb"] = _rss_peak_gb()
    print(f"{tag} host: MemTotal {_mem_total_gb():.1f} GB, this process's peak RSS "
          f"{rec['rss_peak_gb']:.1f} GB", flush=True)
    return rec


#: The ``[families]`` phase: the moe, vlm, encdec, ssm and hybrid families
#: at their published widths, only depth and traffic cut (PERF.md §4).
#: Serving runs, each (model, layers (None: all), rows a round, prompt
#: tokens, max_seq): mixtral-8x7b cut from 32 layers to 8 (93 GB in bfloat16
#: does not fit the card), pixtral-12b cut from 40 layers to 20 (the smoke's
#: time limit) with 1,024 prompt tokens behind its 1,024-patch zero prefix,
#: whisper-base whole at its decoder's 448-token context, xlstm-350m and
#: zamba2-2.7b whole at the ``[serve]`` deployment's 32 rows x 1,024 tokens.
FAMILY_SERVES = (("mixtral-8x7b", 8, 8, 1024, 1024 + 16),
                 ("pixtral-12b", 20, 8, 1024, 1024 + 1024 + 16),
                 ("whisper-base", None, 32, 432, 432 + 16),
                 ("xlstm-350m", None, 32, 1024, 1024 + 16),
                 ("zamba2-2.7b", None, 32, 1024, 1024 + 16))
FAMILY_ROUNDS, FAMILY_STEPS = 3, 16
#: mixtral-8x7b trained at 2 layers, seq 4,096 x batch 1 (``train_4k``'s
#: length), capacity routing at its cf 1.25, no checkpoint (its state would
#: be 31.6 GB of payload); whisper-base through ``run_train`` whole, at its
#: 448-token context x batch 16.
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2, 4096, 3
WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH = 448, 16
#: xlstm-350m trained through ``run_train`` at full width cut to 4 layers (3
#: mLSTM + 1 sLSTM; the sLSTM dispatches ~22 kernels a position forward and
#: twice that backward, and the smoke has a time limit), seq 1,024 x batch 8.
XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_BATCH = 4, 1024, 8
#: zamba2-2.7b trained through ``run_train`` at full width cut to 6 layers
#: (one attention period: the shared block runs once; the whole model's
#: state would be ~30 GB of checkpoint payload a save), at ``[train]``'s seq
#: 4,096 x batch 2.
ZAMBA2_TRAIN_LAYERS, ZAMBA2_TRAIN_SEQ, ZAMBA2_TRAIN_BATCH = 6, 4096, 2


def _empty_cache(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()


def check_continuation(device, model: str, layers: int | None) -> float:
    """The reference's teacher-forcing check on the card: decoding token S
    after a prefill of 2 x S = 64 tokens (seeded weights and tokens, seed
    0) gives the prefill of S + 1 tokens' last logits to the reference's
    0.08 (atol and rtol). Returns the largest difference."""
    import torch

    from repro_torch.models import get

    B, S, tol = 2, 64, 0.08
    tag = f"[families] {model.split('-')[0]} serve"
    arch = cut(get(model), layers)
    params = arch.init(torch.Generator(device=device).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, arch.cfg.vocab, (B, S + 1)).astype(np.int32)).to(device)
    _, cache = arch.prefill_tokens(params, toks[:, :S], max_seq=S + 4)
    step, _ = arch.decode_step(params, toks[:, S:S + 1], cache)
    full, _ = arch.prefill_tokens(params, toks, max_seq=S + 4)
    err = (step - full).abs()
    worst = float(err.max())
    print(f"{tag} decode after a prefill of {B} x {S} against the prefill of {S + 1}: max "
          f"|diff| {worst:.5f}, logits up to {float(full.abs().max()):.3f} (bar {tol} + "
          f"{tol} x |logit|)", flush=True)
    if not bool(torch.isfinite(step).all()) or bool((err > tol + tol * full.abs()).any()):
        raise AssertionError(f"{tag} decode-vs-prefill continuation off by {worst}")
    return worst


def run_moe_train(device, *, smoke: bool = False, seq: int = MOE_TRAIN_SEQ) -> dict:
    """mixtral-8x7b (its smoke config with ``smoke``) cut to
    :data:`MOE_TRAIN_LAYERS`, trained :data:`MOE_TRAIN_STEPS` AdamW steps at
    seq × batch 1 with capacity routing (``make_train_step``, weights and
    ``SyntheticTokens`` from seed 0), no
    checkpoint. The aux loss of the first batch is computed before the
    first step, a layer's near 1 at init. Raises if a loss, a grad norm or
    the aux loss is not finite, or the aux loss is not within [0.8, 1.5] a
    layer. Prints each step's stream ms and tokens/s, peak device memory
    and, on a card, one more step under torch.profiler with its top
    kernels."""
    import torch

    from repro_torch.data import SyntheticTokens
    from repro_torch.models import get, lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import init_opt_state, make_train_step
    from repro_torch.tree import tree_leaves

    tag, steps = "[families] mixtral train", MOE_TRAIN_STEPS
    arch = cut(get("mixtral-8x7b", smoke=smoke), MOE_TRAIN_LAYERS)
    cfg = arch.cfg
    data = SyntheticTokens(cfg, ShapeSpec("train_4k_cut", "train", seq=seq, batch=1), seed=0)
    clock = _timer(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = arch.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = init_opt_state(params)
    step_fn = make_train_step(arch)

    def batch_at(step):
        return {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(step).items()}

    with torch.no_grad():
        b0 = batch_at(0)
        _, aux = lm.backbone(params, cfg, lm._inputs_to_embeddings(params, cfg, b0))
    aux_layer = float(aux) / cfg.n_layers
    print(f"{tag} {cfg.name} cut to {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}: {n_params:,} parameters "
          f"({cfg.dtype}, router float32); seq {seq} x batch 1, capacity factor "
          f"{cfg.capacity_factor} (C = {int(np.ceil(cfg.capacity_factor * seq * cfg.top_k / cfg.n_experts))}); "
          f"aux loss at init {float(aux):.5f} ({aux_layer:.5f} a layer)", flush=True)
    if not np.isfinite(aux_layer) or not 0.8 <= aux_layer <= 1.5:
        raise AssertionError(f"{tag} aux loss {float(aux)} at init")
    log = []
    for step in range(steps):
        batch = b0 if step == 0 else batch_at(step)
        stop = clock()
        params, opt, m = step_fn(params, opt, batch)
        ms = stop()()
        r = {"step": step + 1, "ms": ms, "tok_per_s": seq / (ms / 1e3), "loss": float(m["loss"]),
             "grad_norm": float(m["grad_norm"])}
        log.append(r)
        print(f"{tag} step {r['step']}: {ms:.3f} ms (stream clock), {r['tok_per_s']:.0f} "
              f"tokens/s, loss {r['loss']:.6f}, grad norm {r['grad_norm']:.6f}", flush=True)
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise AssertionError(f"{tag} step {r['step']}: loss {r['loss']}")
    rec = {"model": cfg.name, "layers": cfg.n_layers, "seq": seq, "n_params": n_params,
           "aux_at_init": float(aux), "log": log}
    if device.type == "cuda":
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
        print(f"{tag} peak device memory: {rec['peak_mem_bytes'] / 1e9:.3f} GB", flush=True)
        from torch.profiler import ProfilerActivity, profile as torch_profile

        batch = batch_at(steps)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_fn(params, opt, batch)
            torch.cuda.synchronize()
        busy_ms, events = device_spans(prof)
        step_ms = float(np.median([r["ms"] for r in log[1:]]))
        rec["profile"] = {"busy_ms": busy_ms, "step_ms": step_ms,
                          "idle_share": 1.0 - busy_ms / step_ms, "events": len(events),
                          "top": _device_top(events, 5)}
        print(f"{tag} one more step under torch.profiler: {busy_ms:.3f} ms device busy "
              f"against the unprofiled warm steps' median {step_ms:.3f} ms (idle share "
              f"{rec['profile']['idle_share']:.4f}), {len(events)} device events; the five "
              "with the most device time:", flush=True)
        for name, n, ms in rec["profile"]["top"]:
            print(f"{tag}   {ms:10.3f} ms  x{n:<5d} {name[:100]}", flush=True)
    return rec


def check_decode_launches(rec: dict, n_mamba: int, n_sites: int) -> None:
    """zamba2's ``[families]`` serve (``rec["serve"]["zamba2-2.7b"]``) on
    the Mamba2 step kernel (``mamba2_step.launches``) and the decode
    attention kernel (``decode_attention.launches``), each counted around
    each round: some round captured a decode bucket, and each round launched
    them ``n_mamba`` and ``n_sites`` times for each decode step it ran
    eagerly and for each step of each capture (the warm-up steps and the
    captured one), so every captured step holds one launch a Mamba2 layer
    and one an attention site. The replays launch them from their graphs,
    not from the host."""
    from repro_torch.serve.engine import DecodeBucket

    serve = rec["serve"]["zamba2-2.7b"]
    dec = serve["decode"]
    if not dec["capture_launches"]:
        raise AssertionError("zamba2's serve captured no decode bucket")
    steps = [r["eager_steps"] + r["captures"] * (DecodeBucket.WARMUP + 1)
             for r in serve["rounds"]]
    for kernel, per_step in (("mamba2_step", n_mamba), ("decode_attention", n_sites)):
        got = [r[f"{kernel}_launches"] for r in serve["rounds"]]
        need = [per_step * n for n in steps]
        print(f"[families] zamba2 serve: {kernel} launches by round {got} (need {per_step} a "
              f"step x (eager steps + captures x {DecodeBucket.WARMUP + 1} steps) = {need}); "
              f"{dec['captures']} captures, {dec['graph_replays']} replays", flush=True)
        if got != need:
            raise AssertionError(f"{kernel} launched {got} times by round on zamba2's serve, "
                                 f"want {need}: a captured step lacks its launches")


def run_families(device) -> dict:
    """The moe, vlm, encdec, ssm and hybrid families through the port's
    entry points at their published widths (see :data:`FAMILY_SERVES`):
    each model served through the closed loop (``run_serve``: every round's
    tokens equal to ``ServingEngine.generate``'s, picks equal to the host
    policy's, one bucket, K1 launched in every round; one profiled round,
    the prefill and a decode step alone), mixtral's, xlstm's and zamba2's
    decode-vs-prefill continuation, mixtral trained at 2 layers
    (:func:`run_moe_train`), and xlstm (4 layers), zamba2 (6 layers) and
    whisper trained through the ``[train]`` protocol (``run_train``:
    checkpoints at (8, 4), a restart from 6 of 8 strips per leaf, the
    restarted final loss equal to the straight run's to rel 1e-4). Each
    model is dropped and the allocator's cache emptied before the next.

    The Mamba2 step kernel's and the decode attention kernel's launches are
    counted by path (``rec["mamba2_step_launches"]``,
    ``rec["decode_attention_launches"]``, keyed by each path's tag).
    zamba2's serve must launch them once a Mamba2 layer and once an
    attention site in each decode step it ran eagerly and in each step of
    each capture (its warm-up steps and the captured one), round by round
    (:func:`check_decode_launches`), and its continuation must launch the
    Mamba2 step kernel once a layer."""
    from repro_torch.kernels.attention.decode_attention import decode_attention
    from repro_torch.kernels.ssm.mamba2_step import mamba2_step
    from repro_torch.models import get, hybrid

    rec: dict = {"serve": {}, "wall_s": {}, "mamba2_step_launches": {},
                 "decode_attention_launches": {}}

    def timed(key: str, tag: str, fn):
        t0, launches = time.monotonic(), (mamba2_step.launches, decode_attention.launches)
        rec[key] = out = fn()
        rec["wall_s"][tag] = time.monotonic() - t0
        rec["mamba2_step_launches"][tag] = mamba2_step.launches - launches[0]
        rec["decode_attention_launches"][tag] = decode_attention.launches - launches[1]
        _empty_cache(device)
        print(f"{tag}: {rec['wall_s'][tag]:.1f} s wall, Mamba2 step kernel launched "
              f"{rec['mamba2_step_launches'][tag]} times, decode attention kernel "
              f"{rec['decode_attention_launches'][tag]} times", flush=True)
        return out

    for model, layers, rows, prompt_len, max_seq in FAMILY_SERVES:
        name = model.split("-")[0]
        rec["serve"][model] = timed(f"serve_{name}", f"[families] {name} serve", lambda: run_serve(
            device, model=model, layers=layers, n_objects=FAMILY_ROUNDS * rows,
            rounds=FAMILY_ROUNDS, per_round=rows, prompt_len=prompt_len, steps=FAMILY_STEPS,
            max_seq=max_seq, tag=f"[families] {name} serve"))
        if model == "mixtral-8x7b":
            timed("continuation", "[families] mixtral continuation", lambda: check_continuation(
                device, model, layers))
            timed("moe_train", "[families] mixtral train", lambda: run_moe_train(device))
        if model == "xlstm-350m":
            timed("xlstm_continuation", "[families] xlstm continuation",
                  lambda: check_continuation(device, model, layers))
            timed("xlstm_train", "[families] xlstm train", lambda: run_train(
                device, model=model, layers=XLSTM_TRAIN_LAYERS, seq=XLSTM_TRAIN_SEQ,
                batch=XLSTM_TRAIN_BATCH, tag="[families] xlstm train"))
        if model == "zamba2-2.7b":
            cfg = cut(get(model), layers).cfg
            n_mamba = cfg.n_layers  # a Mamba2 block every layer
            check_decode_launches(rec, n_mamba, hybrid._attn_flags(cfg)[2])
            timed("zamba2_continuation", "[families] zamba2 continuation",
                  lambda: check_continuation(device, model, layers))
            if rec["mamba2_step_launches"]["[families] zamba2 continuation"] < n_mamba:
                raise AssertionError(f"zamba2's continuation launched the Mamba2 step kernel "
                                     f"fewer than {n_mamba} times, once a layer")
            timed("zamba2_train", "[families] zamba2 train", lambda: run_train(
                device, model=model, layers=ZAMBA2_TRAIN_LAYERS, seq=ZAMBA2_TRAIN_SEQ,
                batch=ZAMBA2_TRAIN_BATCH, tag="[families] zamba2 train"))
    timed("whisper_train", "[families] whisper train", lambda: run_train(
        device, model="whisper-base", seq=WHISPER_TRAIN_SEQ, batch=WHISPER_TRAIN_BATCH,
        tag="[families] whisper train"))
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.gf2mm import gf2mm
    from repro_torch.kernels.attention.decode_attention import decode_attention
    from repro_torch.kernels.ssm.mamba2_step import mamba2_step

    smi = nvidia_smi_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {smi}", flush=True)
    device = torch.device("cuda")

    t0 = time.monotonic()
    gf2mm.load_all()
    print(f"[build] K1 and K2 built and loaded in {time.monotonic() - t0:.2f} s", flush=True)
    for tag, name in (("K1", "gf2_rs_bytes"), ("K2", "gf2_matmul")):
        info = build.BUILD_INFO[name]
        print(f"[build] {tag} nvcc {info['seconds']:.2f} s -> {info['path']}", flush=True)
        for line in info["log"].splitlines():
            if "ptxas" in line:
                print(f"[build] {tag} {line.strip()}", flush=True)

    k1 = check_k1(device, np.random.default_rng(1))
    k2 = check_k2(device)
    mamba2_step_rec = check_mamba2_step(device)
    decode_attention_rec = check_decode_attention(device)
    latent_attention_rec = check_latent_attention(device)
    deepseek_rec = run_deepseek_decode(device)
    for name in ("mamba2_step", "decode_attention", "latent_attention"):
        info = build.BUILD_INFO[name]
        print(f"[build] {name} nvcc {info['seconds']:.2f} s -> {info['path']}", flush=True)
        for line in info["log"].splitlines():
            if "ptxas" in line:
                print(f"[build] {name} {line.strip()}", flush=True)

    gf2mm.gf2_rs_matmul_bytes.launches = 0
    main_rec = run_main_path(device)
    launches = gf2mm.gf2_rs_matmul_bytes.launches
    need = main_rec["codec_calls"] + main_rec["step_launches"]
    print(f"[main] K1 launches on the main path: {launches} "
          f"(codec calls {main_rec['codec_calls']} + fused steps "
          f"{main_rec['step_launches']} = {need})", flush=True)
    if launches < need or launches == 0:
        raise AssertionError(f"K1 launched {launches} times, expected at least {need}")

    gf2mm.gf2_matmul.launches = 0
    run_k2_path(device)
    k2_launches = gf2mm.gf2_matmul.launches
    print(f"[k2path] K2 launches on its path: {k2_launches}", flush=True)
    if k2_launches == 0:
        raise AssertionError("K2 was not launched on its path")

    gf2mm.gf2_rs_matmul_bytes.launches = 0
    decode_attention.launches = 0
    serve = run_serve(device, obs_rounds=SERVE_ROUNDS)
    serve_attention_launches = decode_attention.launches
    serve_launches = serve["k1_launches"]
    print(f"[serve] K1 launches in the phase: {serve_launches} (per round "
          f"{[r['k1_launches'] for r in serve['rounds']]}, the rest the proxy's write and read "
          "codec calls and the profiled round)", flush=True)
    if serve_launches < SERVE_ROUNDS:
        raise AssertionError(f"K1 launched {serve_launches} times in {SERVE_ROUNDS} rounds")
    obs_launches = serve["obs"]["k1_launches"]
    print(f"[obs] K1 launches in the {SERVE_ROUNDS} collected rounds: {obs_launches} (per "
          f"round {[r['k1_launches'] for r in serve['obs']['rounds']]})", flush=True)
    if obs_launches < SERVE_ROUNDS:
        raise AssertionError(f"K1 launched {obs_launches} times in {SERVE_ROUNDS} collected "
                             "rounds")
    torch.cuda.empty_cache()

    gf2mm.gf2_rs_matmul_bytes.launches = 0
    train = run_train(device)
    train_launches = gf2mm.gf2_rs_matmul_bytes.launches
    need = 4 * train["encode_groups"] + train["restore"]["decode_groups"]
    print(f"[train] K1 launches on the train path: {train_launches} (4 checkpoints x "
          f"{train['encode_groups']} encode groups + {train['restore']['decode_groups']} decode "
          f"groups = {need}, then the shard's write and read)", flush=True)
    if train_launches < need:
        raise AssertionError(f"K1 launched {train_launches} times on the train path, expected "
                             f"at least {need}")
    torch.cuda.empty_cache()

    gf2mm.gf2_rs_matmul_bytes.launches = 0
    mamba2_step.launches = decode_attention.launches = 0
    t0 = time.monotonic()
    families = run_families(device)
    families_launches = gf2mm.gf2_rs_matmul_bytes.launches
    mamba2_launches = mamba2_step.launches
    families_attention_launches = decode_attention.launches
    print(f"[families] the phase: {time.monotonic() - t0:.1f} s wall", flush=True)
    trained = [(name, families[f"{name}_train"]) for name in ("xlstm", "zamba2", "whisper")]
    need = len(FAMILY_SERVES) * FAMILY_ROUNDS + sum(
        4 * t["encode_groups"] + t["restore"]["decode_groups"] for _, t in trained)
    groups = " + ".join(f"4 {name} checkpoints x {t['encode_groups']} encode groups + "
                        f"{t['restore']['decode_groups']} decode groups" for name, t in trained)
    print(f"[families] K1 launches on the families path: {families_launches} ("
          f"{len(FAMILY_SERVES)} models x {FAMILY_ROUNDS} rounds + {groups} = {need}, then the "
          "profiled rounds, the proxies' codec calls and the shards)", flush=True)
    if families_launches < need:
        raise AssertionError(f"K1 launched {families_launches} times on the families path, "
                             f"expected at least {need}")

    fleet = run_fleet(device)
    taskq = run_taskq(device, fleet_tofec=fleet["tofec_points"])
    run_mpc()
    sched = run_sched(device)
    swept = run_obs_sweeps(device, fleet, taskq, sched)
    run_obs_profile(device, fleet)
    t0 = time.monotonic()
    run_shard(device, fleet, taskq, sched)
    print(f"[shard] the phase: {time.monotonic() - t0:.1f} s wall", flush=True)
    t0 = time.monotonic()
    run_launch(serve, train, families)
    print(f"[launch] the phase: {time.monotonic() - t0:.1f} s wall", flush=True)
    parts = []
    for ph in ("wall_ms", "launch_ms"):  # collection runs in the launch phase
        off, on = (float(np.mean([r[ph] for r in rounds[1:]]))
                   for rounds in (serve["rounds"], serve["obs"]["rounds"]))
        parts.append(f"closed loop {ph[:-3]}, warm rounds 1-{SERVE_ROUNDS - 1}: off {off:.3f} "
                     f"ms, on {on:.3f} ms ({on / off - 1:+.2%})")
    for name, rec in (("fleet", fleet), ("taskq", taskq), ("sched", sched)):
        off, on, off2 = rec["wall_s"], swept[name]["wall_on_s"], swept[name]["wall_off2_s"]
        parts.append(f"{name} off {off:.3f} s, on {on:.3f} s, off again {off2:.3f} s "
                     f"({on / ((off + off2) / 2) - 1:+.2%} against the offs' mean)")
    print(f"[obs] collection's wall cost ({smi}): " + "; ".join(parts), flush=True)

    kernels = {"kernels": [{
        "name": "gf2_rs_matmul_bytes",
        "route": "cuda",
        "source": "src/repro_torch/kernels/gf2mm/csrc/gf2_rs_bytes.cu",
        "replaces": "src/repro/kernels/gf2mm/gf2mm.py:154",
        "launches": launches,
        "launches_by_path": {"main": launches, "serve": serve_launches, "obs": obs_launches,
                             "train": train_launches, "families": families_launches},
        "byte_equal": k1["byte_equal"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "bmm_ms": k1["bmm_ms"],
        "b2b_ms": k1["b2b_ms"],
        "ms_over_bound": k1["ms"] / k1["bound_ms"],
        "b2b_over_bound": k1["b2b_ms"] / k1["bound_ms"],
        "bytes_bound_ms": k1["bytes_bound_ms"],
        "ops_bound_ms": k1["ops_bound_ms"],
        "cases": k1["cases"],
    }, {
        "name": "gf2_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/gf2mm/csrc/gf2_matmul.cu",
        "replaces": "src/repro/kernels/gf2mm/gf2mm.py:77",
        "launches": k2_launches,
        "byte_equal": k2["byte_equal"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "library_call": k2["library_call"],
        "cases": k2["cases"],
    }, {
        "name": "mamba2_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm/csrc/mamba2_step.cu",
        "replaces": None,
        "launches": mamba2_launches,
        "launches_by_path": families["mamba2_step_launches"],
        "capture_launches": families["serve"]["zamba2-2.7b"]["decode"]["capture_launches"],
        "bit_equal": mamba2_step_rec["bit_equal"],
        "y_err_over_bound": mamba2_step_rec["y_err_over_bound"],
        "library_ms": None,
        "cases": mamba2_step_rec["cases"],
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/decode_attention.cu",
        "replaces": None,
        "launches": serve_attention_launches + families_attention_launches,
        "launches_by_path": {"serve": serve_attention_launches,
                             **families["decode_attention_launches"]},
        "err_over_bound": decode_attention_rec["err_over_bound"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
        "cases": decode_attention_rec["cases"],
    }, {
        "name": "latent_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/latent_attention.cu",
        "replaces": None,
        "launches": deepseek_rec["launches"],
        "launches_by_path": deepseek_rec["launches_by_path"],
        "microbenchmark_launches": latent_attention_rec["microbenchmark_launches"],
        "err_over_bound": latent_attention_rec["err_over_bound"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
        "cases": latent_attention_rec["cases"],
    }]}
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
