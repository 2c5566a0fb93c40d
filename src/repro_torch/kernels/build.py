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
:func:`load_libraries` starts one nvcc for each library still to build, all
together, and waits for them all.
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


def load_libraries(sources: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    """Compile each source (once per content hash), one nvcc for each,
    started together, and load them all; returns name -> library."""
    with _LOCK:
        procs = {}
        for name, source in sources.items():
            if name in _LIBS:
                continue
            src = source.read_bytes()
            tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            out = BUILD_DIR / f"lib{name}-{tag}.so"
            BUILD_INFO[name] = {"seconds": 0.0, "log": "", "path": str(out)}
            if out.exists():
                _LIBS[name] = ctypes.CDLL(str(out))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), time.monotonic(), tmp, out)
        failed = []
        for name, (proc, t0, tmp, out) in procs.items():
            log = proc.communicate()[0]
            BUILD_INFO[name].update(seconds=time.monotonic() - t0, log=log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed for {sources[name]} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            _LIBS[name] = ctypes.CDLL(str(out))
        if failed:
            raise RuntimeError("\n".join(failed))
        return {name: _LIBS[name] for name in sources}


def load_library(name: str, source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content hash) and load it."""
    return load_libraries({name: source})[name]
