#!/usr/bin/env python3
"""Where K1's time goes on the card: its kernel built with phases taken out.

Usage, from the repository root, on a machine with one CUDA card:

    python3 k1_ablation.py [--baseline OTHER_gf2_rs_bytes.cu]

Each variant is ``csrc/gf2_rs_bytes.cu`` with one or more phases removed by
a text substitution, built with the port's nvcc flags (one nvcc each,
started together) and launched through its C entry point on the main
path's two shapes: decode (32, 64, 48) × (32, 6, 524,288), and the write
path's batched encode (128, 64, 48) × (128, 6, 524,288). The variants:

* ``full`` — the kernel as it is (checked against the plain version);
* ``no_mma`` — each ``mma.sync`` replaced by one integer XOR of its B
  operands into the accumulators (the B build stays live);
* ``no_epilogue`` — each output byte takes one accumulator as it is, no
  mask-and-shift fold (the register path's; k ≤ 8);
* ``no_load`` — the 16-byte data loads replaced by words made from the
  column index (no global reads of data; the B build stays);
* ``no_store`` — no global stores of the output;
* ``mma_only`` — ``no_load``, ``no_epilogue`` and ``no_store`` together:
  the B build and the ``mma.sync`` remain.

``--baseline`` builds another K1 source with the same C entry point (an
earlier version of the kernel, say) beside the variants, checks it against
the plain version and times it in the same turns, so two versions compare
on one card in one process.

Only ``full`` (and the baseline) compute K1's function; the others time
what is left. Times are ``chip_smoke.back_to_back_ms`` (CUDA events around
10 consecutive launches, divided by 10, median of 20 after 3 warm-ups),
the variants in turns, forward then backward. The last lines are the
card's ``nvidia-smi`` line and one JSON object of the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "gf2mm", "csrc", "gf2_rs_bytes.cu")

NO_MMA = [
    ('"mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "\n'
     '      "{%8, %9}, {%0, %1, %2, %3};\\n"',
     '"xor.b32 %0, %0, %8; xor.b32 %1, %1, %9;\\n"'),
    ('"mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "\n'
     '      "{%0, %1, %2, %3};\\n"',
     '"xor.b32 %0, %0, %6;\\n"'),
]
NO_EPILOGUE = [("        y[e] += ((uint32_t)acc[mt][2 * h + e] & 0x81u) << (2 * mt + h);",
                "        y[e] = (uint32_t)acc[mt][2 * h + e];")]
NO_LOAD = [("      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + c));",
            "      const uint4 v = make_uint4((uint32_t)c, (uint32_t)c ^ 1u, (uint32_t)c ^ 2u,"
            " (uint32_t)c ^ 3u);")]
NO_STORE = [("    if (c < B) *reinterpret_cast<uint4*>(dst + c) = make_uint4(o[0], o[1], o[2], o[3]);",
             "    if (c < B && o[0] == 0x12345678u && o[1] == 0x9abcdef0u)\n"
             "      *reinterpret_cast<uint4*>(dst + c) = make_uint4(o[0], o[1], o[2], o[3]);")]
VARIANTS = {
    "full": [],
    "no_mma": NO_MMA,
    "no_epilogue": NO_EPILOGUE,
    "no_load": NO_LOAD,
    "no_store": NO_STORE,
    "mma_only": NO_LOAD + NO_EPILOGUE + NO_STORE,
}
SHAPES = {"decode": (32, 8, 6, 524_288), "encode128": (128, 8, 6, 524_288)}


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if old not in text:
            raise AssertionError(f"the kernel source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_all(out_dir: str, baseline: str | None = None) -> dict:
    """One nvcc for each variant, all started together; name -> entry point."""
    from repro_torch.kernels import build

    text = open(SOURCE).read()
    sources = {name: variant_source(text, subs) for name, subs in VARIANTS.items()}
    if baseline:
        sources["baseline"] = open(baseline).read()
    procs = {}
    for name, src in sources.items():
        cu, lib = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (lib, subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, cu],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = sorted({line.split("Used ")[1].split(",")[0] for line in log.splitlines()
                       if "Used " in line})
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and not line.strip().startswith("0 bytes")})
        print(f"[ablation] {name}: built, registers {regs}, spill lines {spills}", flush=True)
        fn = ctypes.CDLL(lib).gf2_rs_bytes_launch
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes, fn.restype = [P, P, P, I, I, I, L, P], ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.coding import gf256
    from repro_torch.kernels.gf2mm.ref import gf2_rs_matmul_bytes_ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another K1 source with the same C entry point")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_ablation: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        fns = build_all(tmp, args.baseline)
        times: dict = {}
        for label, (batch, m, k, B) in SHAPES.items():
            mats = rng.integers(0, 256, (batch, m, k), dtype=np.uint8)
            bitmats = torch.from_numpy(gf256.expand_bitmatrix_batched(mats)).to(dev)
            data = torch.from_numpy(rng.integers(0, 256, (batch, k, B), dtype=np.uint8)).to(dev)
            out = torch.empty((batch, m, B), dtype=torch.uint8, device=dev)

            def run(fn):
                rc = fn(bitmats.data_ptr(), data.data_ptr(), out.data_ptr(), batch, 8 * m, k, B,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch refused: cudaError {rc}")

            for name in ("full", "baseline"):
                if name not in fns:
                    continue
                out.zero_()
                run(fns[name])
                torch.cuda.synchronize()
                for i in range(0, batch, 32):  # the plain version's float32 planes, 32 at a time
                    want = gf2_rs_matmul_bytes_ref(bitmats[i:i + 32], data[i:i + 32])
                    if not torch.equal(out[i:i + 32], want):
                        raise AssertionError(f"{name} disagrees with the plain version ({label})")
                    del want
                torch.cuda.empty_cache()
            bound, by = chip_smoke.k1_bound(batch, 8 * m, 8 * k, B)
            order = list(fns) + list(reversed(list(fns)))
            for name in order:
                times.setdefault(label, {}).setdefault(name, []).append(
                    chip_smoke.back_to_back_ms(lambda: run(fns[name])))
            for name, ts in times[label].items():
                print(f"[ablation] {label} {name}: {ts[0]:.4f} / {ts[1]:.4f} ms (forward / "
                      f"backward turn), {min(ts) / bound:.2f}x the bound {bound:.4f} ms ({by})",
                      flush=True)
            del bitmats, data, out
            torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi_line(), flush=True)
    print(json.dumps({"ablation_ms": times, "shapes": SHAPES,
                      "baseline": args.baseline}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
