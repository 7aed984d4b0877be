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
and to ``shape_launches`` under the kernel and its block shape (for K2 and
K3 also the knots and the launch plan's cluster size, e.g.
``fused_admm_round[nb=6,N=512,c=2]``; for K4 the laterals and the cluster
size, ``dp_forward[K=135,c=1]``), so a run can show that the main path
went through each kernel at each of its shapes and plans. A captured CUDA
graph launches its kernels at every replay without the wrappers running,
and how often its loop bodies run is known only on the device: a compiled
call's counts are added when they are read (:func:`sync_counts`, which
:func:`reset_launches` calls first), from the device's count of rounds and
refactors times the launches each body's capture recorded.

``graph_cond.cu`` is no TPU kernel's port: it adds the conditional graph
nodes of a compiled call's device-side loops (``torchutil.Segments``), and
the stamps and node counts of a traced compiled call (``profiling``).
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

from tpu_pathopt_torch import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_factor.cu", "fused_admm_round.cu",
           "fused_structured_round.cu", "dp_forward.cu", "graph_cond.cu")
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
# Compiled calls whose launches are still on the device, by id: objects
# with a ``sync()`` that adds them (``torchutil.Segments``).
_pending: dict = {}


def defer_counts(owner):
    """Register ``owner``, whose ``sync()`` adds launches not yet counted."""
    _pending[id(owner)] = owner


def synced(owner):
    """``owner`` has added its launches (its ``sync()`` ran)."""
    _pending.pop(id(owner), None)


def sync_counts(check: bool = True):
    """Add every compiled call's launches that are still on the device
    (one host read per cache entry replayed since the last sync). Read
    :data:`launches` and :data:`shape_launches` after it. With ``check``
    a check that failed in one of those calls raises here (once)."""
    while _pending:
        _pending.pop(next(iter(_pending))).sync(check=check)


def reset_launches():
    """Zero the counts, the launches still on the device included; their
    calls' failed checks are dropped, not raised."""
    sync_counts(check=False)
    for k in launches:
        launches[k] = 0
    shape_launches.clear()


def count_launch(name: str, shape: str):
    """Count one launch of kernel ``name`` at block shape ``shape``."""
    launches[name] += 1
    key = f"{name}[{shape}]"
    shape_launches[key] = shape_launches.get(key, 0) + 1


def fill_key(tag: str, value: str, counts: dict | None = None):
    """Replace ``tag`` by ``value`` in every launch key of ``counts``
    (default :data:`shape_launches`) that holds it. A wrapper launched
    before the host has read a part of its key (K2's collision rows, read
    with the round's flags) counts under a key holding the tag; the caller
    fills it once it has read the value."""
    counts = shape_launches if counts is None else counts
    for key in [k for k in counts if tag in k]:
        n = counts.pop(key)
        new = key.replace(tag, value)
        counts[new] = counts.get(new, 0) + n


def snapshot():
    """The launch counts as they stand, for :func:`delta` and
    :func:`restore`."""
    return dict(launches), dict(shape_launches)


def delta(before) -> dict:
    """The launches counted since ``before`` (a :func:`snapshot`), by
    ``"name[shape]"`` key."""
    return {k: n - before[1].get(k, 0) for k, n in shape_launches.items()
            if n != before[1].get(k, 0)}


def restore(before):
    """Set the counts back to ``before``: a capture records launches without
    running them, so its counts move to the replays (:func:`add_counts`)."""
    launches.clear()
    launches.update(before[0])
    shape_launches.clear()
    shape_launches.update(before[1])


def add_counts(counts: dict, times: int = 1):
    """Count the launches ``counts`` (a :func:`delta`) ``times`` more: a
    graph replays every kernel its capture recorded."""
    for key, n in counts.items():
        launches[key.split("[", 1)[0]] += n * times
        shape_launches[key] = shape_launches.get(key, 0) + n * times


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
    profiling.COUNTS["builds"] += 1
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
        with profiling.setup_span("kernels", "build or load"):
            _lib = _load()
    return _lib


def _load():
    """Build (where needed) and load the library; declare every
    function's arguments and result."""
    L = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L.pathopt_fused_factor.argtypes = [p, p, p, p, i, i, i, p]
    L.pathopt_fused_admm_round.argtypes = (
        [p] * 19 + [i] * 7 + [f] * 3 + [p])
    L.pathopt_fused_structured_round.argtypes = (
        [p] * 12 + [i] * 9 + [f] * 3 + [p])
    L.pathopt_dp_forward.argtypes = [p] * 8 + [i] * 9 + [f, p]
    L.pathopt_dp_resident.argtypes = [i] * 6 + [p]
    u64 = ctypes.c_ulonglong
    L.pathopt_graph_versions.argtypes = [p, p]
    L.pathopt_cond_handle.argtypes = [p, ctypes.c_uint, i, p]
    L.pathopt_cond_node.argtypes = [p, u64, i, p]
    L.pathopt_capture_to.argtypes = [p, p]
    L.pathopt_capture_end.argtypes = [p]
    L.pathopt_set_condition.argtypes = [u64, p, p]
    L.pathopt_stamp.argtypes = [p, p] + [i] * 3 + [p] + [i] * 2 + [p]
    L.pathopt_timer_probe.argtypes = [p, i, p]
    L.pathopt_capture_nodes.argtypes = [p, p]
    L.pathopt_graph_nodes.argtypes = [p, p]
    for fn in (L.pathopt_fused_factor, L.pathopt_fused_admm_round,
               L.pathopt_fused_structured_round, L.pathopt_dp_forward,
               L.pathopt_dp_resident,
               L.pathopt_graph_versions, L.pathopt_cond_handle,
               L.pathopt_cond_node, L.pathopt_capture_to,
               L.pathopt_capture_end, L.pathopt_set_condition,
               L.pathopt_stamp, L.pathopt_timer_probe,
               L.pathopt_capture_nodes, L.pathopt_graph_nodes):
        fn.restype = ctypes.c_int
    L.pathopt_error_string.argtypes = [i]
    L.pathopt_error_string.restype = ctypes.c_char_p
    return L


def check(err: int, name: str):
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = lib().pathopt_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def ptr_or_null(t: torch.Tensor | None) -> int | None:
    """A tensor's pointer, or NULL for None."""
    return None if t is None else t.data_ptr()


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


# -------------------------- conditional graph nodes --------------------------
#
# ``graph_cond.cu``: the nodes of a compiled call's device-side loops, added
# to the graph a stream is capturing into (``torchutil.Segments``).

# WHILE nodes need this CUDA runtime and driver (1000 major + 10 minor).
CONDITIONAL_NODES_CUDA = 12040


def graph_versions() -> tuple[int, int]:
    """The CUDA runtime the library was built against and the CUDA
    driver's."""
    rt, drv = ctypes.c_int(), ctypes.c_int()
    _graph_check(lib().pathopt_graph_versions(ctypes.byref(rt),
                                              ctypes.byref(drv)), "versions")
    return rt.value, drv.value


def require_conditional_nodes():
    """Raise unless the CUDA runtime and driver have WHILE nodes."""
    rt, drv = graph_versions()
    if min(rt, drv) < CONDITIONAL_NODES_CUDA:
        raise RuntimeError(
            f"conditional graph nodes need CUDA {CONDITIONAL_NODES_CUDA} in "
            f"the runtime and the CUDA driver; runtime {rt}, CUDA driver "
            f"{drv}")


def _graph_check(err: int, what: str):
    if err != 0:
        msg = lib().pathopt_error_string(err).decode()
        raise RuntimeError(f"conditional graph node: {what} failed: {msg} "
                           f"({err})")


def cond_handle(stream: int, default: int, assign_default: bool) -> int:
    """A condition handle of the graph ``stream`` is capturing into; with
    ``assign_default`` each launch of the graph sets it to ``default``."""
    h = ctypes.c_ulonglong()
    _graph_check(lib().pathopt_cond_handle(stream, default,
                                           int(assign_default),
                                           ctypes.byref(h)), "handle")
    return h.value


def cond_node(stream: int, handle: int, is_while: bool) -> int:
    """Add a WHILE (or IF) node on ``handle`` to the graph ``stream`` is
    capturing into, after the capture's work so far; returns its body."""
    body = ctypes.c_void_p()
    _graph_check(lib().pathopt_cond_node(stream, handle, int(is_while),
                                         ctypes.byref(body)), "node")
    return body.value


def capture_to(stream: int, graph: int):
    """Capture ``stream``'s work into ``graph`` until :func:`capture_end`."""
    _graph_check(lib().pathopt_capture_to(stream, graph), "body capture")


def capture_end(stream: int):
    _graph_check(lib().pathopt_capture_end(stream), "body capture end")


def set_condition(handle: int, flag: torch.Tensor, stream: int):
    """Launch the kernel that sets ``handle``'s condition to ``flag``, a
    0-d bool device tensor, when it runs."""
    if flag.dtype != torch.bool or flag.dim() != 0:
        raise ValueError(f"set_condition: flag {flag.dtype} of shape "
                         f"{tuple(flag.shape)}, expected a 0-d bool")
    _graph_check(lib().pathopt_set_condition(handle, ptr(flag), stream),
                 "set_condition")


# ------------------------------ trace stamps ---------------------------------
#
# ``graph_cond.cu``'s stamps and node counts, for a traced compiled call
# (``profiling``, ``torchutil.Segments``).


def stamp(ring: torch.Tensor, counter: torch.Tensor, slot: int,
          values: torch.Tensor | None, n_values: int, advance: bool,
          stream: int):
    """Launch a stamp: %globaltimer into ``ring[counter % rows, slot]``
    (``ring`` (rows, slots) int64, ``counter`` (1,) int64), then the first
    ``n_values`` of ``values`` (int64) into the slots after it; with
    ``advance`` the counter moves on a row."""
    rows, slots = ring.shape
    if not 0 <= slot <= slots - 1 - n_values:
        raise ValueError(f"stamp: slot {slot} (+{n_values}) outside "
                         f"{slots} slots")
    _graph_check(lib().pathopt_stamp(
        ptr(ring), ptr(counter), slot, slots, rows, ptr_or_null(values),
        n_values, int(advance), stream), "stamp")


def timer_probe(out: torch.Tensor, stream: int):
    """Fill ``out`` ((n,) int64) with n back-to-back %globaltimer reads."""
    _graph_check(lib().pathopt_timer_probe(ptr(out), out.numel(), stream),
                 "timer probe")


def capture_nodes(stream: int) -> int:
    """The nodes so far of the graph ``stream`` is capturing into."""
    n = ctypes.c_ulonglong()
    _graph_check(lib().pathopt_capture_nodes(stream, ctypes.byref(n)),
                 "capture nodes")
    return n.value


def graph_nodes(graph: int) -> int:
    """The nodes of ``graph`` (a conditional node's body)."""
    n = ctypes.c_ulonglong()
    _graph_check(lib().pathopt_graph_nodes(graph, ctypes.byref(n)),
                 "graph nodes")
    return n.value
