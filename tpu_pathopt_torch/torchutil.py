"""Small PyTorch helpers shared by the port (counterpart of ``jaxutil``)."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from tpu_pathopt_torch import kernels


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. With no GPU present a CUDA request raises; nothing falls
    back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def tree_map(fn, obj):
    """Apply ``fn`` to every tensor inside nested dataclasses / tuples /
    lists (the pytree ``tree_map`` of the JAX package, for this port's
    dataclasses). Non-tensor leaves are kept as they are."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, o) for o in obj)
    return obj


def tree_leaves(obj) -> list:
    """Every tensor inside ``obj``, in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, obj)
    return out


def to_device(obj, device):
    """Move every tensor of ``obj`` to ``device`` (no copy where it lies)."""
    return tree_map(lambda t: t.to(device), obj)


def take(arr, idx):
    """``jnp.take(arr, idx)`` along the last axis for one index per row:
    arr (..., n), idx (...) -> (...). Negative indices wrap as in JAX; an
    index is never out of range on the device."""
    n = arr.shape[-1]
    i = torch.remainder(idx.long(), n).clamp(max=n - 1)
    return torch.gather(arr, -1, i.unsqueeze(-1)).squeeze(-1)


@contextlib.contextmanager
def highest_precision():
    """Full float32 products (no TF32) inside the block, the previous
    setting restored after it: the counterpart of JAX's
    ``default_matmul_precision("highest")``."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# ------------------------------ constants ------------------------------------

_CONSTS: dict = {}


def const(values, dtype=torch.float32, device=None) -> torch.Tensor:
    """A tensor of fixed host data (a number or nested lists of numbers) on
    ``device``, built once per (values, dtype, device) and then reused.
    Making a tensor from host data is a copy to the device with a host
    synchronisation, which a captured segment cannot hold: the first call
    (a segment's warm-up) builds it, later calls (its capture) find it.
    Callers never write into it."""
    def freeze(v):
        return tuple(freeze(x) for x in v) if isinstance(v, (list, tuple)) \
            else float(v)
    key = (freeze(values), dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def scalar(v, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(v, dtype, device)`` without making a tensor from
    host data where ``v`` is a tensor or a Python number: a number goes
    through ``torch.full``, which a captured segment can hold."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device)
    if isinstance(v, (bool, int, float)):
        return torch.full((), v, dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


_PLAIN_READS = [0]


@contextlib.contextmanager
def plain_read():
    """Marks a host read that only a kernel's plain version makes: it runs
    on CPU tensors, never in a segment on the card, so a segment guard
    (:data:`SEGMENT_GUARD`) lets it pass (:func:`in_plain_read`)."""
    _PLAIN_READS[0] += 1
    try:
        yield
    finally:
        _PLAIN_READS[0] -= 1


def in_plain_read() -> bool:
    return _PLAIN_READS[0] > 0


# ------------------------- segments (compiled calls) -------------------------

def host_flags(flags: torch.Tensor) -> list:
    """The values of a small bool device tensor, read to the host in one
    copy: packed into one integer on the device (flag i in bit i) and read
    with ``item()``. Returns a flat list of bools."""
    t = flags.reshape(-1)
    if t.dtype != torch.bool or t.numel() > 62:
        raise ValueError("host_flags reads at most 62 bool flags")
    n = t.numel()
    code = int(torch.sum(t.to(torch.int64) << torch.arange(
        n, device=t.device)).item())
    return [bool(code >> i & 1) for i in range(n)]


def signature(obj):
    """A hashable description of a pytree's static part: each tensor's
    shape and dtype, every other leaf as it is (the counterpart of what
    ``jax.jit`` keys a trace on)."""
    if isinstance(obj, torch.Tensor):
        return ("T", tuple(obj.shape), obj.dtype)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, signature(getattr(obj, f.name)))
            for f in dataclasses.fields(obj) if f.init)
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(signature(o) for o in obj)
    return obj


# A context-manager factory wrapped around every segment body a compiled
# call runs on the CPU (after the segment's warm-up, where a capture on the
# card would come), or None. Tests set it to a dispatch mode that refuses
# what a CUDA graph cannot hold.
SEGMENT_GUARD = None


def _copy_into(dst, src):
    """Copy every tensor leaf of ``src`` into the matching leaf of ``dst``
    (same structure), skipping leaves that are already the same tensor."""
    d_leaves, s_leaves = tree_leaves(dst), tree_leaves(src)
    if len(d_leaves) != len(s_leaves):
        raise ValueError(f"segment result has {len(s_leaves)} tensors, its "
                         f"destination {len(d_leaves)}")
    for d, s in zip(d_leaves, s_leaves):
        if d is not s:
            d.copy_(s)
    return dst


@dataclasses.dataclass
class _Captured:
    """One captured segment: its graph, the addresses of the arguments it
    was captured on, its result and the kernel launches it holds."""
    graph: object
    arg_ptrs: list
    out: object
    launch_delta: dict


class Segments:
    """The segment runner of one compiled call: the straight-line pieces of
    a program between two host decisions, each called as
    ``segs(name, fn, *args, into=None)``.

    - ``capture=False`` (the eager path, and with ``compiled`` a compiled
      call on the CPU): ``fn(*args)`` runs at once; in a compiled call
      under :data:`SEGMENT_GUARD` if one is set, after one warm-up.
    - ``capture=True`` (a compiled call on CUDA): the first call of ``name``
      runs ``fn`` once on a side stream (the warm-up: library workspaces,
      constants), captures it into a CUDA graph in the key's memory pool
      on that stream, and replays it; every later call replays the graph.
      The arguments must be the tensors it was captured on (the previous
      segments' results, or the key's static inputs), else it raises.
      Nothing falls back to running ``fn`` eagerly.

    With ``into`` (a pytree of tensors, e.g. a solver's loop state) the
    result of ``fn`` is copied into those tensors and ``into`` is returned:
    a round updates its state in place, so the next replay reads it where
    the graph reads. Without it the result is returned (on CUDA the
    captured graph's own tensors, rewritten by every replay).

    :meth:`read` is the one host read between segments."""

    def __init__(self, device=None, capture: bool = False,
                 compiled: bool = False):
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.capture = capture
        self.compiled = compiled or capture
        if capture and self.device.type != "cuda":
            raise ValueError(f"segments capture on CUDA, not {self.device}")
        self.segments: dict = {}
        self.static_in = None
        self.capture_seconds = 0.0
        if capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        self._warm = set()

    def load(self, obj):
        """The key's static copy of the caller's inputs ``obj`` (a pytree):
        made on the first call, refilled in place on every later one."""
        if self.static_in is None:
            self.static_in = tree_map(
                lambda t: t.to(self.device, copy=True), obj)
        else:
            _copy_into(self.static_in, obj)
        return self.static_in

    def read(self, flags) -> list:
        """One host read of a small device tensor (see :func:`host_flags`)."""
        return host_flags(flags)

    def __call__(self, name, fn, *args, into=None):
        if not self.capture:
            return self._run(name, fn, args, into)
        seg = self.segments.get(name)
        if seg is None:
            seg = self.segments[name] = self._capture(name, fn, args, into)
        elif [t.data_ptr() for t in tree_leaves(args)] != seg.arg_ptrs:
            raise RuntimeError(f"segment {name!r}: replayed on other tensors "
                               "than it was captured on")
        seg.graph.replay()
        kernels.add_counts(seg.launch_delta)
        return seg.out

    def _run(self, name, fn, args, into):
        guard = SEGMENT_GUARD if self.compiled else None
        if guard is not None and name not in self._warm:
            fn(*args)       # the warm-up, as a capture is preceded by one
            self._warm.add(name)
        with guard() if guard is not None else contextlib.nullcontext():
            out = fn(*args)
        if into is None:
            return out
        self._check_into(name, out, into)
        return _copy_into(into, out)

    @staticmethod
    def _check_into(name, out, into):
        """A result leaf written into ``into`` must not share memory with
        another destination leaf (the copies would overwrite each other)."""
        written = [(d, s) for d, s in zip(tree_leaves(into),
                                          tree_leaves(out)) if d is not s]
        dst = [d.untyped_storage().data_ptr() for d, _ in written]
        if len(set(dst)) != len(dst):
            raise RuntimeError(f"segment {name!r}: two destinations share "
                               "memory")
        src = {s.untyped_storage().data_ptr() for _, s in written}
        if src & set(dst):
            raise RuntimeError(f"segment {name!r}: a result aliases a "
                               "destination it is copied into")

    def _capture(self, name, fn, args, into):
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = self.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args)                       # warm-up
            if into is not None:
                self._check_into(name, out, into)
        del out
        before = kernels.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            out = fn(*args)
            if into is not None:
                out = _copy_into(into, out)
        delta = kernels.delta(before)
        kernels.restore(before)
        cur.wait_stream(side)
        self.capture_seconds += time.perf_counter() - t0
        return _Captured(graph, [t.data_ptr() for t in tree_leaves(args)],
                         out, delta)


EAGER = Segments()


class SegmentCache:
    """Compiled calls' :class:`Segments`, one per static key, the least
    recently used dropped past ``maxsize`` (its graphs and pool freed)."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self.entries: dict = {}

    def get(self, key, device) -> Segments:
        """The key's segments, made on its first call."""
        segs = self.entries.pop(key, None)
        if segs is None:
            segs = Segments(device, capture=device.type == "cuda",
                            compiled=True)
        self.entries[key] = segs
        while len(self.entries) > self.maxsize:
            self.entries.pop(next(iter(self.entries)))
        return segs

    def clear(self):
        self.entries.clear()
