#!/usr/bin/env python3
"""Where K2's time goes on the card: its kernel built with phases taken out.

Usage, from the repository root, on a machine with one CUDA card:

    python3 k2_ablation.py

Each variant is ``csrc/gf2_matmul.cu`` with one or more phases removed by a
text substitution, built with the port's nvcc flags (one nvcc each, started
together) and launched through its C entry point on the shapes that
``chip_smoke.py`` times: encode (48, 48) @ (48, 524,288) and max_field
(1024, 1024) @ (1024, 65,536), 0/1 uint8. The variants:

* ``full`` — the kernel as it is (checked against the plain version);
* ``no_mma`` — no ldmatrix, mask or mma;
* ``no_prmt`` — B's words stored untransposed (the shared stores stay);
* ``no_load`` — no global loads of A or B (zeros);
* ``no_store`` — no global stores of the output;
* ``mma_only`` — ``no_load`` and ``no_store`` together;
* ``load_only`` — ``no_mma`` and ``no_store`` together.

Only ``full`` computes K2's function; the others time what is left. Times
are ``chip_smoke.median_ms`` (CUDA events, median of 20 after 3 warm-ups),
the variants in turns, forward then backward. The last lines are the card's
``nvidia-smi`` line and one JSON object of the times.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "gf2mm", "csrc", "gf2_matmul.cu")

NO_MMA = ("    if (warp_active) {  // k-steps", "    if (false) {  // k-steps")
NO_PRMT = ("    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),\n"
           "                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};",
           "    const uint32_t col[4] = {w0, w1, w2, w3};")
NO_LOAD_A = ("                                       int K, int row0, int k0) {\n",
             "                                       int K, int row0, int k0) {\n  return;\n")
NO_LOAD_B = ("    if (k + r >= K) continue;", "    continue;")
NO_STORE = ("      *reinterpret_cast<uint4*>(dst) = v;", "      if (v.x == 0x12345678u) *reinterpret_cast<uint4*>(dst) = v;")
VARIANTS = {
    "full": [],
    "no_mma": [NO_MMA],
    "no_prmt": [NO_PRMT],
    "no_load": [NO_LOAD_A, NO_LOAD_B],
    "no_store": [NO_STORE],
    "mma_only": [NO_LOAD_A, NO_LOAD_B, NO_STORE],
    "load_only": [NO_MMA, NO_STORE],
}


def build_all(out_dir: str) -> dict:
    """One nvcc for each variant, all started together; name -> entry point."""
    from repro_torch.kernels import build

    text = open(SOURCE).read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise AssertionError(f"{name}: the kernel source no longer holds {old!r}")
            src = src.replace(old, new)
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
        print(f"[ablation] {name}: built, {regs}", flush=True)
        fn = ctypes.CDLL(lib).gf2_matmul_launch
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes, fn.restype = [P, P, P, I, I, L, P], ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.gf2mm.ref import gf2_matmul_ref

    if not torch.cuda.is_available():
        print("k2_ablation: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def bits(shape):
        return torch.randint(0, 2, shape, generator=g, device=dev).to(torch.uint8)

    shapes = {"encode": (48, 48, 524_288), "max_field": (1024, 1024, 65_536)}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")
                                     if os.path.isdir(os.path.join(ROOT, "build")) else None) as tmp:
        fns = build_all(tmp)
        times: dict = {}
        for label, (M, K, N) in shapes.items():
            a, b = bits((M, K)), bits((K, N))
            out = torch.empty((M, N), dtype=torch.uint8, device=dev)

            def run(fn):
                rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch refused: cudaError {rc}")

            run(fns["full"])
            torch.cuda.synchronize()
            if not torch.equal(out, gf2_matmul_ref(a, b).to(torch.uint8)):
                raise AssertionError(f"the full kernel disagrees with the plain version ({label})")
            order = list(fns) + list(reversed(list(fns)))
            for name in order:
                times.setdefault(label, {}).setdefault(name, []).append(
                    chip_smoke.median_ms(lambda: run(fns[name])))
            for name, ts in times[label].items():
                print(f"[ablation] {label} {name}: {ts[0]:.4f} / {ts[1]:.4f} ms "
                      f"(forward / backward turn)", flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    print(json.dumps({"ablation_ms": times, "shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
