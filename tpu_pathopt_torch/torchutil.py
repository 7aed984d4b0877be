"""Small PyTorch helpers shared by the port (counterpart of ``jaxutil``)."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from array import array

import torch

from tpu_pathopt_torch import kernels, profiling


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
    lists / dicts (the pytree ``tree_map`` of the JAX package, for this
    port's dataclasses). Non-tensor leaves are kept as they are."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
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
    on CPU tensors, never in a compiled call on the card, so a call guard
    (:data:`CALL_GUARD`) lets it pass (:func:`in_plain_read`)."""
    _PLAIN_READS[0] += 1
    try:
        yield
    finally:
        _PLAIN_READS[0] -= 1


def in_plain_read() -> bool:
    return _PLAIN_READS[0] > 0




_LOOP_READS = [0]


@contextlib.contextmanager
def loop_read():
    """Marks the one host read a compiled call on the CPU makes in each
    round of a device-side loop: the runner's stand-in for the condition a
    conditional graph node tests on the card (:meth:`Segments.loop`). A
    call guard (:data:`CALL_GUARD`) lets it pass (:func:`in_loop_read`)."""
    _LOOP_READS[0] += 1
    try:
        yield
    finally:
        _LOOP_READS[0] -= 1


def in_loop_read() -> bool:
    return _LOOP_READS[0] > 0


def write_row(bufs, values, i):
    """Write each of ``values`` into row ``i`` (a 0-d int64 device tensor)
    of its buffer in ``bufs``, with no host read of ``i``: a trace's
    record of a round inside a device-side loop."""
    for b, v in zip(bufs, values):
        b.index_copy_(0, i.reshape(1), v.unsqueeze(0))


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
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, signature(v)) for k, v in obj.items())
    return obj


# A context-manager factory wrapped around the whole program a compiled call
# runs on the CPU (after the key's warm-up, where a capture on the card
# would come), or None. Tests set it to a dispatch mode that refuses what a
# CUDA graph cannot hold.
CALL_GUARD = None


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


def _bump(tally: torch.Tensor, i: int):
    """Add one to ``tally[i]`` in place (one kernel, no host value)."""
    tally[i:i + 1].add_(1)


# A traced key's stamp ring (``profiling``): a row a call, the oldest
# overwritten, and the slots of a row.
RING_ROWS = 4096
RING_SLOTS = 32


class Segments:
    """The runner of one program: the eager path's stage chain, or one
    compiled call's. The program's straight-line pieces are segments,
    ``drv(name, fn, *args, into=None)``, run at once; its QP solves'
    rounds are :meth:`loop`, the counterpart of ``lax.while_loop`` with a
    ``lax.cond`` around each refactor. With ``into`` (a pytree of tensors,
    e.g. a solver's loop state) the result of ``fn`` is copied into those
    tensors and ``into`` is returned: a round updates its state in place.

    A compiled call (:meth:`call`) runs in one of these modes:

    - on CUDA (``capture``): the first call of the key runs the program
      once as the eager path does (the warm-up: constants, library
      workspaces, the launch keys and the checks the host reads), then
      captures the whole program into one CUDA graph in the key's memory
      pool, each loop a WHILE node whose body holds the round and an IF
      node around the refactor (``csrc/graph_cond.cu``); every call,
      the first too, replays that graph. No host read is left inside a
      call, and nothing falls back to the eager loop: missing conditional
      nodes, a failed capture or a failed replay raise.
    - on the CPU: the program runs on every call, under
      :data:`CALL_GUARD` if one is set (after one warm-up), each loop on
      the host with one read a round, marked as the condition's stand-in
      (:func:`loop_read`), and otherwise as the card runs it: round and
      refactor counts kept on the device, checks carried there.

    A compiled call's launch counts and round counts stay on the device
    until :meth:`sync` reads them (``kernels.sync_counts``).

    A ``traced`` runner (the traced key of a compiled call, ``profiling``)
    stamps its call: at each stage boundary the program marks
    (:meth:`mark`), before and after each loop, and where the caller asks
    (:meth:`stamp`); on the card each stamp is a node of the graph, written
    into a ring on the device, and the capture counts the graph's nodes by
    stage and by body."""

    def __init__(self, device=None, capture: bool = False,
                 traced: bool = False):
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.capture = capture
        if capture and self.device.type != "cuda":
            raise ValueError(f"segments capture on CUDA, not {self.device}")
        # "eager" (and a compiled call's "warm" up) loops on the host with
        # one read a round; "run" is a compiled call on the CPU, "capture"
        # one on the card.
        self.mode = "eager"
        self.static_in = None
        self.setup_spans: list = []   # its warm-up and capture
        self.graph = None
        self.out = None
        self.conditional_nodes = 0
        self.loops: dict = {}     # name -> (4,) int64 tally on the device
        self.faults: dict = {}    # check name -> (1,) int64 tally
        self.messages: dict = {}  # check name -> its error message
        self.fills: dict = {}     # loop name -> launch-key fills read
        self.deltas: dict = {}    # body name -> its launches, once
        self.static = None        # launches outside the loops, a call
        self.replays = 0          # calls whose launches are not yet added
        self._synced: dict = {}   # loop name -> (rounds, refactors) added
        self._warm = False
        if capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            # A body is captured on the stream of its depth: a WHILE body
            # on the first, the IF body nested in it on the second.
            self._body_streams = [torch.cuda.Stream(self.device)
                                  for _ in range(2)]
            self._depth = 0
        self.traced = traced
        if traced:
            self._trace_init()

    @property
    def capture_seconds(self) -> float:
        """Seconds the key's warm-up and capture took (its set-up spans)."""
        return sum(b - a for name, _, a, b in self.setup_spans
                   if name in ("warm_up", "capture")) / 1e9

    # ------------------------------ stamps -----------------------------------

    def _trace_init(self):
        self.slots: dict = {}       # stamp name -> (slot, width)
        self.calls_made = 0         # calls stamped (the ring's next row)
        self.stage = None           # the stage the program is in
        self.stage_nodes: dict = {}  # stage -> top-level nodes, stamps out
        self.body_nodes: dict = {}  # "<loop>.round" / ".refactor" -> nodes
        self.loop_stage: dict = {}  # loop -> its stage
        self.stamp_nodes = 0        # stamp nodes among the top-level ones
        self._mark_nodes = 0
        if self.device.type == "cuda":
            self.ring = torch.zeros((RING_ROWS, RING_SLOTS),
                                    dtype=torch.int64, device=self.device)
            self.counter = torch.zeros(1, dtype=torch.int64,
                                       device=self.device)
        else:
            self.ring = array("q", bytes(8 * RING_ROWS * RING_SLOTS))
            self.counter = 0

    def stamp(self, name: str, values=None, last: bool = False):
        """Stamp the clock into slot ``name`` of the call's row: on the card
        %globaltimer by a one-thread kernel (a graph node where a capture
        is in progress), on the CPU ``time.perf_counter_ns()``. ``values``
        (a loop's rounds and refactors: on the card its tally, whose first
        two entries are the call's; on the CPU two ints) go into the two
        slots after it. ``last`` moves the ring to the next row. In a
        warm-up the slot is only assigned."""
        slot = self.slots.get(name)
        if slot is None:
            width = 1 if values is None else 3
            start = sum(w for _, w in self.slots.values())
            if start + width > RING_SLOTS:
                raise RuntimeError(f"stamp {name!r}: the ring's {RING_SLOTS} "
                                   "slots are taken")
            slot = self.slots[name] = (start, width)
        if self.mode == "warm":
            return
        i = slot[0]
        if last:
            self.calls_made += 1
        if self.device.type == "cuda":
            kernels.stamp(self.ring, self.counter, i, values,
                          0 if values is None else 2, last, self._stream())
            if torch.cuda.is_current_stream_capturing():
                self.stamp_nodes += 1
            return
        base = (self.counter % RING_ROWS) * RING_SLOTS + i
        self.ring[base] = time.perf_counter_ns()
        if values is not None:
            self.ring[base + 1], self.ring[base + 2] = values
        if last:
            self.counter += 1

    def mark(self, name: str):
        """A stage boundary of a traced program (the ``hook`` of
        ``pipeline._pipeline``): its stamp, and in a capture the top-level
        nodes the stage before it added, stamps left out."""
        if self.mode == "capture":
            n = kernels.capture_nodes(self._stream()) - self.stamp_nodes
            if self.stage is not None:
                self.stage_nodes[self.stage] = n - self._mark_nodes
            self._mark_nodes = n
        self.stage = name
        self.stamp(name)

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

    # ------------------------------ loops ------------------------------------

    def loop(self, name: str, run, round_fn, refactor_fn, start: bool,
             on_read=None):
        """A QP solve's rounds: ``run = round_fn(run)`` (segment ``name +
        ".round"``) while ``run.flags[0]`` after it, and after each round
        ``run = refactor_fn(run)`` (segment ``name + ".refactor"``) where
        ``run.flags[1]``; no round where ``start`` is False. Both update
        ``run`` in place; a ``refactor_fn`` of None is a loop with no
        refactor (no IF node). ``on_read(flags)``, if given, sees each
        round's read on the eager path and in a warm-up and returns the
        launch-key fills it decided (``{tag: value}``, see
        ``kernels.fill_key``); a compiled call reuses the warm-up's. Returns ``(run, rounds)``:
        rounds a Python int on the eager path, in a compiled call a 0-d
        int64 device tensor (read only by :meth:`sync`)."""
        if self.traced:
            self.loop_stage[name] = self.stage
            self.stamp(name + ".start")
        if self.mode == "capture":
            run, rounds = self._loop_graph(name, run, round_fn, refactor_fn,
                                           start)
            if self.traced:
                self.stamp(name + ".stop", self.loops[name])
            return run, rounds
        compiled = self.mode == "run"
        tally = (self._tally(self.loops, name, 4) if self.mode != "eager"
                 else None)
        if compiled:
            tally[:2].zero_()
        rounds = refactors = 0
        active = start
        while active:
            run = self._body(name, ".round", round_fn, run)
            rounds += 1
            if compiled:
                _bump(tally, 0)
                with loop_read():
                    flags = self.read(run.flags)
            else:
                flags = self.read(run.flags)
                if on_read is not None:
                    self._fill(name, on_read(flags) or {})
            active, need = flags[0], flags[1]
            if need and refactor_fn is not None:
                run = self._body(name, ".refactor", refactor_fn, run)
                refactors += 1
                if compiled:
                    _bump(tally, 1)
        if self.traced:
            self.stamp(name + ".stop", tally if self.device.type == "cuda"
                       else (rounds, refactors))
        if not compiled:
            return run, rounds
        tally[2:] += tally[:2]
        return run, tally[0]

    def _loop_graph(self, name, run, round_fn, refactor_fn, start):
        """:meth:`loop` captured: a WHILE node whose first test is
        ``start`` and whose body is the round, an IF node on
        ``run.flags[1]`` around the refactor, and the kernel that sets the
        next test from ``run.flags[0]``."""
        tally = self._tally(self.loops, name, 4)
        tally[:2].zero_()
        with self._node(True, default=int(start),
                        label=name + ".round") as handle:
            run = self._body(name, ".round", round_fn, run)
            _bump(tally, 0)
            if refactor_fn is not None:
                run = self._if(name, run, refactor_fn, tally)
            kernels.set_condition(handle, run.flags[0], self._stream())
        tally[2:] += tally[:2]
        return run, tally[0]

    def _if(self, name, run, refactor_fn, tally):
        """The refactor under an IF node on ``run.flags[1]``, counted in
        ``tally[1]``."""
        with self._node(False, flag=run.flags[1], label=name + ".refactor"):
            run = self._body(name, ".refactor", refactor_fn, run)
            _bump(tally, 1)
        return run

    def repeat(self, name: str, run, round_fn, refactor_fn, n: int,
               each=None):
        """Exactly ``n`` rounds, the counterpart of ``lax.scan`` over a
        round: ``run = round_fn(run)`` (segment ``name + ".round"``), then
        ``run = refactor_fn(run)`` where ``run.flags[1]`` (the round's
        ``lax.cond``; None: no refactor), then ``each(run, i)`` with ``i``
        the round's index, a 0-d int64 tensor on the device of
        ``run.flags`` (a trace writes its row ``i``). Captured as a WHILE
        node on a device counter (``i < n``; XLA compiles a scan to a loop
        too: the body is captured once, not ``n`` times), each refactor an
        IF node in it. Eager and on the
        CPU a host loop of ``n`` rounds, each refactor's test one host
        read, in a compiled call marked as the IF node's stand-in. Returns
        ``run``."""
        counted = self.mode in ("run", "capture")
        tally = (self._tally(self.loops, name, 4) if self.mode != "eager"
                 else None)
        if counted:
            tally[:2].zero_()
        dev = run.flags.device
        i = torch.zeros((), dtype=torch.int64, device=dev)
        if self.mode == "capture":
            more = torch.zeros((), dtype=torch.bool, device=dev)
            with self._node(True, default=int(n > 0)) as handle:
                run = self._body(name, ".round", round_fn, run)
                _bump(tally, 0)
                if refactor_fn is not None:
                    run = self._if(name, run, refactor_fn, tally)
                if each is not None:
                    each(run, i)
                i.add_(1)
                torch.lt(i, n, out=more)
                kernels.set_condition(handle, more, self._stream())
            tally[2:] += tally[:2]
            return run
        for _ in range(n):
            run = self._body(name, ".round", round_fn, run)
            if counted:
                _bump(tally, 0)
            if refactor_fn is not None:
                with loop_read() if counted else contextlib.nullcontext():
                    need = self.read(run.flags)[1]
                if need:
                    run = self._body(name, ".refactor", refactor_fn, run)
                    if counted:
                        _bump(tally, 1)
            if each is not None:
                each(run, i)
            i.add_(1)
        if counted:
            tally[2:] += tally[:2]
        return run

    def _body(self, name, part, fn, run):
        """A loop's round or refactor, in place on ``run``. In a compiled
        call its launches are not counted as they happen: they are
        recorded once, as the body's, and counted from the device's tally
        of how often the body ran (:meth:`sync`)."""
        if self.mode not in ("run", "capture"):
            return self(name + part, fn, run, into=run)
        before = kernels.snapshot()
        run = self(name + part, fn, run, into=run)
        delta = kernels.delta(before)
        kernels.restore(before)
        for tag, value in self.fills.get(name, {}).items():
            kernels.fill_key(tag, value, delta)
        self.deltas.setdefault(name + part, delta)
        return run

    def _fill(self, name, fills: dict):
        for tag, value in fills.items():
            kernels.fill_key(tag, value)
        if self.mode == "warm":
            self.fills[name] = fills

    def check(self, name: str, ok: torch.Tensor, message: str):
        """A condition the eager path raises on when a loop reads it (its
        ``on_read``), carried on the device in a compiled call: ``ok`` (a
        0-d bool tensor) False in a call raises ``ValueError(message)`` at
        the first :meth:`sync` after that call, and only there."""
        if self.mode == "eager":
            return
        tally = self._tally(self.faults, name, 1)
        self.messages[name] = message
        if self.mode != "warm":
            tally |= (~ok).to(torch.int64)

    def _tally(self, table: dict, name: str, size: int) -> torch.Tensor:
        """An int64 tally of ``table`` on the device (a loop's rounds,
        refactors and their totals over every call; a check's fault flag),
        made in the warm-up, before a capture."""
        t = table.get(name)
        if t is None:
            if self.mode == "capture":
                raise RuntimeError(f"{name!r} was not met in the warm-up")
            t = table[name] = torch.zeros(size, dtype=torch.int64,
                                          device=self.device)
        return t

    # ----------------------- conditional graph nodes -------------------------

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    @contextlib.contextmanager
    def _node(self, is_while: bool, default: int = 0, flag=None,
              label: str | None = None):
        """Add a WHILE (or IF, on the 0-d bool ``flag``) node to the graph
        the current stream is capturing into and capture the block's work
        into its body, on a stream of the body's depth. PyTorch routes a
        capture's allocations to its pool by the capture's id, and a body
        is a capture of its own: the key's pool is handed to the body's
        stream for the block and back to the parent's after it. Yields the
        node's handle. A traced runner counts the body's nodes under
        ``label``."""
        s = self._stream()
        handle = kernels.cond_handle(s, default, assign_default=is_while)
        if flag is not None:
            kernels.set_condition(handle, flag, s)
        body = kernels.cond_node(s, handle, is_while)
        self.conditional_nodes += 1
        stream = self._body_streams[self._depth]
        dev = self.device.index
        torch._C._cuda_endAllocateToPool(dev, self.pool)
        try:
            with torch.cuda.stream(stream):
                torch._C._cuda_beginAllocateCurrentStreamToPool(dev,
                                                                self.pool)
                try:
                    kernels.capture_to(stream.cuda_stream, body)
                    self._depth += 1
                    try:
                        yield handle
                    finally:
                        self._depth -= 1
                        kernels.capture_end(stream.cuda_stream)
                    if self.traced and label is not None:
                        self.body_nodes[label] = kernels.graph_nodes(body)
                finally:
                    torch._C._cuda_endAllocateToPool(dev, self.pool)
                    torch._C._cuda_releasePool(dev, self.pool)
        finally:
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, self.pool)
            torch._C._cuda_releasePool(dev, self.pool)

    # --------------------------- compiled calls ------------------------------

    def call(self, program, inputs):
        """One compiled call of ``program(drv, *static)``, ``static`` the
        key's copy of ``inputs`` (a tuple): on the card a replay of the
        key's graph (captured by the first call), on the CPU a run of the
        program (see the class). Returns the program's result: on CUDA the
        graph's own tensors, rewritten by every replay."""
        return self.run(program, self.load(inputs))

    def run(self, program, static):
        """:meth:`call` on inputs already in the key's copy (:meth:`load`)."""
        if not self.capture:
            guard = CALL_GUARD
            if guard is not None and not self._warm:
                self._warm_up(program, static)
            self.mode = "run"
            with guard() if guard is not None else contextlib.nullcontext():
                out = self._counted(program, static)
            self._called()
            return out
        if self.graph is None:
            self._capture(program, static)
        self.graph.replay()
        self._called()
        return self.out

    def _warm_up(self, program, static):
        self.mode = "warm"
        with profiling.setup_span("warm_up", self._label(),
                                  into=self.setup_spans):
            program(self, *static)
        profiling.COUNTS["warm_ups"] += 1
        self._warm = True

    def _label(self) -> str:
        return "traced" if self.traced else ""

    def _counted(self, program, static):
        """Run the program, keeping its launches outside the loops as a
        call's (:attr:`static`) instead of counting them now."""
        before = kernels.snapshot()
        try:
            out = program(self, *static)
            if self.static is None:
                self.static = kernels.delta(before)
            return out
        finally:
            kernels.restore(before)

    def _capture(self, program, static):
        kernels.require_conditional_nodes()
        cur = torch.cuda.current_stream(self.device)
        side = self.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._warm_up(program, static)
        self.mode = "capture"
        if self.traced:
            self.stage, self._mark_nodes = None, 0
        graph = torch.cuda.CUDAGraph()
        with profiling.setup_span("capture", self._label(),
                                  into=self.setup_spans):
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                out = self._counted(program, static)
        profiling.COUNTS["captures"] += 1
        cur.wait_stream(side)
        self.graph, self.out = graph, out

    def _called(self):
        self.replays += 1
        kernels.defer_counts(self)

    def sync(self, check: bool = True) -> dict:
        """Read the device's tallies (one host read) and count the launches
        of the calls since the last sync: each call's launches outside the
        loops, and each body's times the rounds and refactors it ran.
        Clears the checks' faults; with ``check``, raises where a check
        failed in any of those calls. Returns each loop's rounds in the
        last call."""
        kernels.synced(self)
        tallies = list(self.loops.values()) + list(self.faults.values())
        vals = torch.cat(tallies).tolist() if tallies else []
        for t in self.faults.values():
            t.zero_()
        if self.static is not None:
            kernels.add_counts(self.static, self.replays)
        self.replays = 0
        rounds = {}
        for i, name in enumerate(self.loops):
            r, _, total_r, total_f = vals[4 * i:4 * i + 4]
            done_r, done_f = self._synced.get(name, (0, 0))
            kernels.add_counts(self.deltas.get(name + ".round", {}),
                               total_r - done_r)
            kernels.add_counts(self.deltas.get(name + ".refactor", {}),
                               total_f - done_f)
            self._synced[name] = (total_r, total_f)
            rounds[name] = r
        failed = [self.messages[name] for name, v in
                  zip(self.faults, vals[4 * len(self.loops):]) if v]
        if failed and check:
            raise ValueError("; ".join(failed))
        return rounds


EAGER = Segments()


def compiled(cache: "SegmentCache", key, program, inputs: tuple, device,
             tracer: "profiling.Tracer | None" = None):
    """One compiled call of ``program(drv, *inputs)`` (a tuple of pytrees)
    on ``device``, through the :class:`Segments` that ``cache`` keeps for
    the static ``key`` (the arguments ``program`` closes over), the device
    and the inputs' signature: on CUDA a replay of the graph the key's
    first call captured, on the CPU a run of the program
    (:meth:`Segments.call`). The result is cloned out of the graph's
    memory, so a later call never changes a result already returned.
    Returns (result, the key's Segments); its round counts stay on the
    device until :meth:`Segments.sync` reads them.

    With a ``tracer`` (tracing on, ``profiling.traced``; ``key`` then says
    so) the key's runner is a traced one, the call's host spans go to
    ``tracer`` (``entry``, and in it ``key``, ``load``, ``replay``,
    ``clone``) and the device is stamped before the input copy (``load``)
    and after the result clone (``clone``, which ends the call's row)."""
    tr = tracer
    if tr is not None:
        tr.begin_call("key")
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        segs = cache.get((key, dev, signature(inputs)), dev,
                         traced=tr is not None)
        if tr is not None:
            tr.bind(segs)
            tr.step("load")
            segs.stamp("load")
        static = segs.load(inputs)
        if tr is not None:
            tr.step("replay")
        out = segs.run(program, static)
        if tr is not None:
            tr.step("clone")
        out = tree_map(torch.clone, out)
        if tr is not None:
            segs.stamp("clone", last=True)
    finally:
        if tr is not None:
            tr.end_call()
    return out, segs


class SegmentCache:
    """Compiled calls' :class:`Segments`, one per static key, the least
    recently used dropped past ``maxsize`` (its graph and pool freed, its
    launches counted first and its checks' faults dropped: they are
    raised only by a read the caller makes)."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self.entries: dict = {}

    def get(self, key, device, traced: bool = False) -> Segments:
        """The key's segments, made on its first call (``traced``: a
        traced runner, see :class:`Segments`)."""
        segs = self.entries.pop(key, None)
        if segs is None:
            segs = Segments(device, capture=device.type == "cuda",
                            traced=traced)
        self.entries[key] = segs
        while len(self.entries) > self.maxsize:
            profiling.COUNTS["evictions"] += 1
            self.entries.pop(next(iter(self.entries))).sync(check=False)
        return segs

    def clear(self):
        while self.entries:
            self.entries.pop(next(iter(self.entries))).sync(check=False)


# The standalone QP solvers' compiled calls (``qp.admm``, ``qp.structured``,
# ``solver.path_solver``): a cache of their own, so that a solver's keys
# never evict the pipeline's (``pipeline.COMPILED``).
SOLVERS = SegmentCache(maxsize=16)
