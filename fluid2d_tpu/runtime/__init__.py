"""Native (C++) host-runtime components.

The compute path is JAX/XLA (the role Taichi's C++ runtime
plays in the reference — see SURVEY.md §2.2); the host-side runtime
pieces that benefit from native code live here. Currently: the scene
rasterizer (``rasterizer.cpp``), built on demand with g++ and loaded via
ctypes. Everything has a NumPy fallback, so the framework works without
a compiler toolchain.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["load_rasterizer", "native_available"]

_DIR = Path(__file__).parent
_SRC = _DIR / "rasterizer.cpp"
_LIB = _DIR / "_rasterizer.so"
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(_LIB)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_rasterizer():
    """ctypes handle to the native rasterizer, building it on first use;
    None when no toolchain is available (callers fall back to NumPy)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.raster_circles.argtypes = [u8p, f32p, f32p, ctypes.c_long, ctypes.c_long,
                                   f64p, ctypes.c_long]
    lib.raster_box.argtypes = [u8p, f32p, f32p] + [ctypes.c_long] * 6
    lib.raster_gray_mask.argtypes = [u8p, f32p, f32p, ctypes.c_long, ctypes.c_long,
                                     u8p, ctypes.c_long]
    for fn in (lib.raster_circles, lib.raster_box, lib.raster_gray_mask):
        fn.restype = None
    _lib = lib
    return _lib


def native_available() -> bool:
    return load_rasterizer() is not None
