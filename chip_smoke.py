#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card, and hold each of
its CUDA kernels against its plain PyTorch version there.

Usage, from the repository root, on a machine with one CUDA card (H100):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device — torch version and the card's name and power limit;
2. build  — builds K1 (``gf2_rs_bytes.cu``) from the sources with nvcc;
3. kernels — K1 against its plain version, byte for byte, at the main
   path's decode and encode shapes, a k=256 case and a ragged case; times
   both at the decode shape (CUDA events, median of 20 runs);
4. main path — the paper's §V-A deployment through the port's entry points:
   128 seeded 3 MiB objects written through the proxy (L = 16, (12, 6) strip
   code, feedback write policy), then 4 rounds of 32 raw reads decoded by
   the fused serving step, every byte checked and every controller pick
   held against the host TOFEC policy, then one fused encode round checked
   against the numpy codec, and one more fused decode under torch.profiler
   (device time by operation, the device's idle share); K1's launch counter
   must show the codec work went through the kernel.

The last lines are the card's ``nvidia-smi`` line, one JSON object with the
kernels' numbers, and ``{"ok": true, "device": {...}}``. Without a card it
exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

#: NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

#: The paper's §V-A deployment (tests/test_fused_serve.py, coding/layout.py).
FILE_BYTES = 3 * 2**20
K_MAX, R_MAX, L_THREADS = 6, 2, 16


def request_class():
    from repro_torch.core import PAPER_READ_3MB, RequestClass

    return RequestClass("read3mb", 3.0, PAPER_READ_3MB, k_max=K_MAX, r_max=float(R_MAX),
                        n_max=K_MAX * R_MAX)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()


def k1_bound(batch: int, m8: int, k8: int, B: int) -> tuple[float, str]:
    """Least time (ms) the card needs for one K1 call and what bounds it:
    each input byte read once and each output byte written once over HBM,
    vs the equivalent 0/1 int8 product's operations at the int8 peak."""
    nbytes = batch * m8 * k8 + batch * (k8 // 8) * B + batch * (m8 // 8) * B
    ops = 2.0 * batch * m8 * k8 * B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
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


def k1_cases(device, rng) -> list[tuple[str, "object", "object"]]:
    """(label, bitmats, data) at the main path's shapes and two edge cases."""
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
    return [
        ("decode", up(gf256.expand_bitmatrix_batched(dec)), data),
        ("encode", up(gf256.expand_bitmatrix_batched(enc)), data),
        ("wide_k256", up(gf256.expand_bitmatrix_batched(wide)),
         up(rng.integers(0, 256, (2, 256, 4096), dtype=np.uint8))),
        ("ragged", up(gf256.expand_bitmatrix_batched(ragged)),
         up(rng.integers(0, 256, (3, 6, 1001), dtype=np.uint8))),
    ]


def check_k1(device, rng) -> dict:
    """K1 vs its plain version on every case; times at the decode shape."""
    import torch

    from repro_torch.kernels.gf2mm.gf2mm import gf2_rs_matmul_bytes
    from repro_torch.kernels.gf2mm.ref import gf2_rs_matmul_bytes_ref

    rec = {"cases": {}, "max_abs_err": 0, "byte_equal": True}
    for label, bitmats, data in k1_cases(device, rng):
        got = gf2_rs_matmul_bytes(bitmats, data)
        want = gf2_rs_matmul_bytes_ref(bitmats, data)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        rec["cases"][label] = {"shape": [list(bitmats.shape), list(data.shape)],
                               "byte_equal": equal, "max_abs_err": err}
        rec["byte_equal"] &= equal
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"[kernels] K1 {label}: bitmats {tuple(bitmats.shape)} data "
              f"{tuple(data.shape)} byte_equal={equal} max_abs_err={err}", flush=True)
        if label == "decode":
            batch, m8, k8 = bitmats.shape
            B = data.shape[2]
            rec["ms"] = median_ms(lambda: gf2_rs_matmul_bytes(bitmats, data))
            rec["plain_ms"] = median_ms(lambda: gf2_rs_matmul_bytes_ref(bitmats, data))
            # Yardstick only: the float32 bmm at the heart of the plain
            # version, on planes unpacked beforehand (no unpack, mod 2 or
            # repack) — not the same function, so it is not library_ms.
            shifts = torch.arange(8, dtype=torch.uint8, device=device)
            planes = ((data[:, :, None, :] >> shifts[None, None, :, None]) & 1)
            planes = planes.reshape(batch, k8, B).to(torch.float32)
            bm32 = bitmats.to(torch.float32)
            rec["bmm_ms"] = median_ms(lambda: torch.bmm(bm32, planes))
            del planes, bm32
            rec["bound_ms"], rec["bound_by"] = k1_bound(batch, m8, k8, B)
            print(f"[kernels] K1 decode shape: {rec['ms']:.4f} ms kernel, "
                  f"{rec['plain_ms']:.4f} ms plain, {rec['bmm_ms']:.4f} ms float32 bmm, "
                  f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})", flush=True)
        del got, want
        torch.cuda.empty_cache()
    if not rec["byte_equal"]:
        raise AssertionError(f"K1 disagrees with its plain version: {rec['cases']}")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, pick = step.decode_batch(rows, present, n=n, k=k, q=q)
        wall_ms = (time.monotonic() - t0) * 1e3
    # Device-side events only (kernels and copies): a CPU op's device time
    # repeats its kernels' time. Busy time is the union of their intervals.
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    busy_ms = busy_us / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time for the fused step")
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            row = by_name.setdefault(ev.name, [ev.name, 0, 0.0])
            row[1] += 1
            row[2] += (ev.time_range.end - ev.time_range.start) / 1e3
    top = sorted(by_name.values(), key=lambda r: -r[2])
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "top": top[:8], "pick": list(pick)}
    print(f"[profile] fused decode of {rows.shape[0]} objects: {wall_ms:.3f} ms wall, "
          f"{busy_ms:.3f} ms device busy, idle share {rec['device_idle_share']:.4f}", flush=True)
    for name, count, ms in rec["top"]:
        print(f"[profile]   {ms:10.4f} ms  x{count:<4d} {name}", flush=True)
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

    smi = nvidia_smi_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {smi}", flush=True)
    device = torch.device("cuda")

    t0 = time.monotonic()
    gf2mm.load()
    info = build.BUILD_INFO["gf2_rs_bytes"]
    print(f"[build] K1 built in {info['seconds']:.2f} s (load {time.monotonic() - t0:.2f} s) "
          f"-> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "ptxas" in line:
            print(f"[build] {line.strip()}", flush=True)

    k1 = check_k1(device, np.random.default_rng(1))

    gf2mm.gf2_rs_matmul_bytes.launches = 0
    main_rec = run_main_path(device)
    launches = gf2mm.gf2_rs_matmul_bytes.launches
    need = main_rec["codec_calls"] + main_rec["step_launches"]
    print(f"[main] K1 launches on the main path: {launches} "
          f"(codec calls {main_rec['codec_calls']} + fused steps "
          f"{main_rec['step_launches']} = {need})", flush=True)
    if launches < need or launches == 0:
        raise AssertionError(f"K1 launched {launches} times, expected at least {need}")

    kernels = {"kernels": [{
        "name": "gf2_rs_matmul_bytes",
        "route": "cuda",
        "source": "src/repro_torch/kernels/gf2mm/csrc/gf2_rs_bytes.cu",
        "replaces": "src/repro/kernels/gf2mm/gf2mm.py:154",
        "launches": launches,
        "byte_equal": k1["byte_equal"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "bmm_ms": k1["bmm_ms"],
        "cases": k1["cases"],
    }]}
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
