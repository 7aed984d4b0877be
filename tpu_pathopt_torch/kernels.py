"""Build, bind and count the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. Nothing is
built at import: the first launch builds, one ``nvcc -c`` per source, all
started together, then one link. The library lands in ``_build/`` next to
this file, named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once.

Every launcher returns the ``cudaError_t`` of its launch; :func:`check`
raises on anything but 0. Each wrapper calls :func:`count_launch` where it
launches its kernel, and nowhere else, which adds one to ``launches[name]``
and to ``shape_launches`` under the kernel and its block shape, so a run can
show that the main path went through each kernel at each of its shapes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_factor.cu", "fused_admm_round.cu",
           "fused_structured_round.cu", "dp_forward.cu")
HEADERS = ("common.cuh", "btri_sweep.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# Kernel name -> launches since the last reset.
launches = {"fused_factor": 0, "fused_admm_round": 0,
            "fused_structured_round": 0, "dp_forward": 0}
# "name[shape]" (e.g. "fused_factor[nb=9]") -> launches since the last reset.
shape_launches: dict = {}
# Filled by build(): the commands, seconds, library path and nvcc output.
build_info: dict = {}

_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0
    shape_launches.clear()


def count_launch(name: str, shape: str):
    """Count one launch of kernel ``name`` at block shape ``shape``."""
    launches[name] += 1
    key = f"{name}[{shape}]"
    shape_launches[key] = shape_launches.get(key, 0) + 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _key(flags) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the library's path. ``verbose`` adds ``-Xptxas -v`` so the
    output lists each kernel's registers, shared memory and spills."""
    so = BUILD_DIR / f"libpathopt_kernels_{_key(NVCC_FLAGS)}.so"
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    if so.exists():
        build_info.setdefault("path", str(so))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp_{so.stem}_{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *flags, "-c", str(CSRC / src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    failed = None
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode and failed is None:
            failed = (cmd, out)
    if failed:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n{failed[1]}")
    lib_tmp = tmp / so.name
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
            *[str(obj) for _, obj, _ in jobs]]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"link failed: {' '.join(link)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(lib_tmp, so)
    shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(
        commands=[" ".join(c) for c, _, _ in jobs] + [" ".join(link)],
        seconds=time.perf_counter() - t0, path=str(so),
        nvcc_output="".join(logs))
    return so


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.pathopt_fused_factor.argtypes = [p, p, p, p, i, i, i, p]
        L.pathopt_fused_admm_round.argtypes = (
            [p] * 18 + [i] * 4 + [f] * 3 + [p])
        L.pathopt_fused_structured_round.argtypes = (
            [p] * 11 + [i] * 6 + [f] * 3 + [p])
        L.pathopt_dp_forward.argtypes = [p] * 8 + [i, i, i, f, p]
        for fn in (L.pathopt_fused_factor, L.pathopt_fused_admm_round,
                   L.pathopt_fused_structured_round, L.pathopt_dp_forward):
            fn.restype = ctypes.c_int
        L.pathopt_error_string.argtypes = [i]
        L.pathopt_error_string.restype = ctypes.c_char_p
        _lib = L
    return _lib


def check(err: int, name: str):
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = lib().pathopt_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def expect(name: str, t: torch.Tensor, shape, dtype, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels take nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def kernel_device(*tensors) -> torch.device | None:
    """None when the tensors lie on the CPU (the caller takes the plain
    version); their CUDA device otherwise. Any other device raises."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {dev}")
    return dev
