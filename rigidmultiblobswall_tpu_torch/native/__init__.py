"""Native (C++) host-side components of the port and their ctypes loader.

Counterpart of rigidmultiblobswall_tpu/native/__init__.py. The sources
here are the port's own copies (gr.cpp, the radial distribution's pair
sweep, as utils/gr.py uses it); each compiles on first use with the host
C++ toolchain (CXX, default g++) into `build/native/` at the checkout
root, named by a hash of its source, so an edited source rebuilds and an
unchanged one is reused. Every native entry point has a numpy fallback
in its Python wrapper: without a compiler the package works, slower.
These are host tools, not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LOADED: dict = {}


def load_library(name: str):
    """Compile `native/<name>.cpp` (if needed) and dlopen it.

    Returns the ctypes.CDLL, or None when no working C++ toolchain is
    available — callers must fall back to their numpy implementation.
    Results (including failure) are memoized per process.
    """
    if name in _LOADED:
        return _LOADED[name]
    src = SRC_DIR / (name + ".cpp")
    try:
        code = src.read_bytes()
    except OSError:
        _LOADED[name] = None
        return None
    out = BUILD_DIR / f"{name}-{hashlib.sha256(code).hexdigest()[:16]}.so"
    if not out.exists():
        cxx = os.environ.get("CXX", "g++")
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build to a temporary path, then rename: atomic against
            # concurrent compiles from parallel test workers
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run([cxx, "-O3", "-march=native", "-fPIC",
                                "-shared", "-fopenmp", "-o", tmp, str(src)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except (OSError, subprocess.SubprocessError):
            _LOADED[name] = None
            return None
    try:
        _LOADED[name] = ctypes.CDLL(str(out))
    except OSError:
        _LOADED[name] = None
    return _LOADED[name]
