"""Build and load the package's hand-written CUDA kernels.

All `csrc/*.cu` files compile with `nvcc` into one shared library with a
plain C interface, loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). The library lands in `build/kernels/` at the checkout
root, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import:
the first kernel launch triggers the build, so CPU-only installs import
every module without `nvcc`.

Every C entry point returns `cudaGetLastError()` after its launch; the
wrappers raise when it is not 0 (a refused launch never runs, and a
later synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C signatures of the entry points (csrc/pair_tt.cu, csrc/blob_forces.cu);
# pointers and the stream MUST be c_void_p or ctypes truncates them
SIGNATURES = {
    "pair_tt_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pair_tt_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "blob_forces_f32": (_P, _P, _I, _D, _D, _D, _P),
    "blob_forces_f64": (_P, _P, _I, _D, _D, _D, _P),
}

_lib = None
build_log = ""        # nvcc's output (ptxas register/spill report)
build_seconds = 0.0   # 0.0 when an existing library was reused


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "are built on the machine that has the card")


def library():
    """The loaded kernel library, building it on first use."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    target = BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(name, err):
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
