"""ctypes bindings for the port's native host runtime (port of
``tpu_pathopt.runtime.native``): the C++ Felzenszwalb EDT of ``esdf.cpp``.

Nothing is built at import. The first call compiles ``esdf.cpp`` with
``g++`` into ``_build/`` next to the package, named by a hash of the source
and flags, as ``kernels.py`` names the CUDA library. Where ``g++`` is
missing, :func:`build_map_native` builds the map with the port's own exact
EDT (``maps.build_map``), as the JAX package falls back to its JAX EDT: the
two agree, and this is host data loading, not a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from tpu_pathopt_torch import maps

SOURCE = Path(__file__).resolve().parent / "esdf.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-fPIC", "-shared")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libpathopt_runtime_{h.hexdigest()[:16]}.so"


def available() -> bool:
    """Whether the library is built or ``g++`` can build it."""
    return library_path().exists() or shutil.which("g++") is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.esdf_f32.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                             ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                             ctypes.c_int]
    lib.esdf_f32.restype = None
    _lib = lib
    return lib


def esdf_pixels(obstacle_mask) -> np.ndarray:
    """Exact EDT in pixels from each cell to the nearest obstacle (True)
    cell, by the C++ runtime."""
    mask = np.ascontiguousarray(np.asarray(obstacle_mask).astype(np.uint8))
    if mask.ndim != 2:
        raise ValueError(f"obstacle mask: shape {mask.shape}, expected 2-D")
    rows, cols = mask.shape
    out = np.empty((rows, cols), np.float32)
    _load().esdf_f32(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                     rows, cols)
    return out


def build_map_native(obstacle_mask, resolution: float = 0.2,
                     device=None) -> maps.GridMap:
    """A GridMap on ``device`` (``cuda`` unless the caller asks for
    another) with the ESDF computed on the host by the C++ runtime; with no
    ``g++``, by ``maps.build_map`` on the device."""
    mask = np.asarray(obstacle_mask, bool)
    if available():
        return maps.from_esdf(esdf_pixels(mask) * np.float32(resolution),
                              resolution=resolution, device=device)
    return maps.build_map(mask, resolution=resolution, device=device)
