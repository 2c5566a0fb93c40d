"""Build and load the port's CUDA kernels at first use.

Each kernel source under ``kernels/<name>/csrc/`` exposes a plain C entry
point. It is compiled with ``nvcc`` for ``sm_90a`` into a shared library and
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds.

Libraries go to ``build/repro_torch_kernels/`` at the repository root, keyed
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the library already built. A process-wide lock serializes
builds (the proxy's admit-loop thread and the caller's thread can both reach
the first launch), and each library is written under a temporary name and
renamed into place, so concurrent processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build time (0.0 when loaded from the cache), "log": nvcc output}
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def load_library(name: str, source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content hash) and load it."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = source.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{tag}.so"
        info = {"seconds": 0.0, "log": "", "path": str(out)}
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            info["seconds"] = time.monotonic() - t0
            info["log"] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {source} (exit {proc.returncode}):\n"
                                   f"{info['log']}")
            os.replace(tmp, out)
        lib = _LIBS[name] = ctypes.CDLL(str(out))
        BUILD_INFO[name] = info
        return lib
