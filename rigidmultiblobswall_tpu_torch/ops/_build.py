"""Build and load the package's hand-written CUDA kernels.

Each `csrc/*.cu` file compiles with its own `nvcc` process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). The library lands in `build/kernels/` at the checkout root,
named by a hash of every source under `csrc/` (headers included) and the
flags, so an edited source or header rebuilds and an unchanged tree is
reused. Nothing here runs at import: the first kernel launch triggers the
build, so CPU-only installs import every module without `nvcc`.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C signatures of the entry points (csrc/pair_tt.cu, csrc/pair_couplings.cu,
# csrc/pair_fs.cu,
# csrc/blob_forces.cu, csrc/dense_tt.cu, csrc/symm_planes.cu,
# csrc/nl_forces.cu, csrc/near_rpy.cu, csrc/wall_near.cu,
# csrc/wall_rot_near.cu, csrc/laplace_layers.cu, csrc/blob_energy.cu,
# csrc/pair_radii.cu, csrc/near_radii.cu, csrc/gridding.cu);
# pointers and the stream MUST be c_void_p or ctypes truncates them
_PAIR = (_P,) * 5 + (_I,) * 8 + (_P,)
_PAIR_SYM = (_P,) * 4 + (_I,) * 8 + (_P,)
_PI = ctypes.POINTER(ctypes.c_int)
_PD = ctypes.POINTER(ctypes.c_double)
# the image boxes' arguments before the stream: L (3,), n_boxes, offsets
_BOXES = (_PD, _I, _PD)
_NL = (_P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _D, _D, _D, _P)
_NEAR = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _D, _D, _D, _D,
         _I, _I, _P)
_WALL = (_P,) * 6 + (_I,) * 9 + (_D,) * 11 + (_I, _I, _P)
_ROT = (_P,) * 7 + (_I,) * 9 + (_D,) * 12 + (_P,)
# K1's instances (csrc/pair_tt.cu, pair_couplings.cu, pair_fs.cu)
_COUPLINGS = ("tt", "tr", "rt", "rr", "grand", "tt_fs")
SIGNATURES = {
    **{f"pair_{c}_{t}": _PAIR for c in _COUPLINGS
       for t in ("f32", "f64")},
    **{f"pair_{c}_img_{t}": _PAIR[:-1] + _BOXES + (_P,)
       for c in _COUPLINGS for t in ("f32", "f64")},
    **{f"pair_{c}_shape": (_I, _I, _I, _I, _PI)
       for c in _COUPLINGS},
    **{f"pair_{c}_sym_{t}": _PAIR_SYM
       for c in _COUPLINGS for t in ("f32", "f64")},
    **{f"pair_{c}_sym_img_{t}": _PAIR_SYM[:-1] + _BOXES + (_P,)
       for c in _COUPLINGS for t in ("f32", "f64")},
    **{f"blob_forces_{t}": (_P,) * 3 + (_I,) * 3 + (_D,) * 3 + (_P,)
       for t in ("f32", "f64")},
    **{f"blob_forces_periodic_{t}": (_P,) * 3 + (_I,) * 3 + (_D,) * 3
       + (_PD, _I, _PD, _P) for t in ("f32", "f64")},
    **{f"blob_forces_one_box_{t}": (_P,) * 3 + (_I,) * 3 + (_D,) * 3
       + (_PD, _P) for t in ("f32", "f64")},
    "dense_tt_f32": (_P, _P, _I, _D, _D, _I, _P),
    "dense_tt_f64": (_P, _P, _I, _D, _D, _I, _P),
    "dense_tt_img_f32": (_P, _P, _I, _D, _D, _I) + _BOXES + (_P,),
    "dense_tt_img_f64": (_P, _P, _I, _D, _D, _I) + _BOXES + (_P,),
    "dense_tt_shape": (_I, _I, _I, _PI),
    "symm_matvec_f32": (_P, _P, _P, _P, _I, _I, _P),
    "symm_matvec_f64": (_P, _P, _P, _P, _I, _I, _P),
    "nl_forces_f32": _NL,
    "nl_forces_f64": _NL,
    **{f"nl_forces_open_{t}": (_P,) * 5 + (_I,) * 5 + (_PD,) * 3
       + (_D,) * 3 + (_P,) for t in ("f32", "f64")},
    **{f"near_rpy_{t}_b{b}": _NEAR for t in ("f32", "f64") for b in (1, 2)},
    **{f"wall_near_{t}_b{b}": _WALL for t in ("f32", "f64") for b in (1, 2)},
    **{f"wall_rot_near_{t}_{w}": _ROT for t in ("f32", "f64")
       for w in ("grand", "rt", "tr", "rr")},
    **{f"laplace_layers_{t}": (_I,) * 3 + (_P,) * 7 + (_D,) + (_I,) * 4
       + (_P,) * 3 for t in ("f32", "f64")},
    **{f"laplace_layers_sym_{t}": (_I,) * 2 + (_P,) * 6 + (_D,) + (_I,) * 3
       + (_P,) * 3 for t in ("f32", "f64")},
    **{f"blob_energy_{t}": (_P,) * 3 + (_I,) * 4 + (_D,) * 4 + (_PD, _I, _P)
       for t in ("f32", "f64")},
    **{f"pair_radii_sym_{t}": (_P,) * 4 + (_I,) * 5 + (_P,)
       for t in ("f32", "f64")},
    **{f"pair_radii_sym_img_{t}": (_P,) * 4 + (_I,) * 5 + _BOXES
       + (_D, _P) for t in ("f32", "f64")},
    **{f"blob_energy_small_{t}": (_P,) * 2 + (_I,) * 2 + (_D,) * 4
       + (_PD, _I, _P) for t in ("f32", "f64")},
    "launch_floor": (_P,),
    **{f"near_radii_pairs_{t}": (_P,) * 5 + (_I,) * 5 + (_D,) * 4 + (_I, _P)
       for t in ("f32", "f64")},
    **{f"near_rpy_radii_{t}_b{b}": (_P,) * 7 + (_I,) * 3 + (_D,) * 3
       + (_I, _I, _P)
       for t in ("f32", "f64") for b in (1, 2)},
    # G1 and G2 (csrc/gridding.cu): pos, sort_pos, ids, rows, src, dst,
    # then n, stride, gx, gy, gz, x0, nxl, P, then Lx, Ly, Lz, beta, and
    # the stream
    **{f"grid_{k}_{t}_c{c}": (_P,) * 6 + (_I,) * 8 + (_D,) * 4 + (_P,)
       for k in ("spread", "interp") for t in ("f32", "f64")
       for c in (3, 6, 9, 18)},
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    target = BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        build_log = _compile_and_link(sorted(CSRC.glob("*.cu")), target)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _compile_and_link(sources, target):
    """One `nvcc -c` per source, run in parallel, then one link into
    `target`. Returns the compilers' output (ptxas reports); raises on a
    failed step."""
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(proc.returncode)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n" + "\n".join(log))
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               + "\n".join(log))
        os.replace(tmp, target)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "\n".join(log)


def check(name, err):
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
