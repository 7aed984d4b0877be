"""Per-stage timing and the tracing of compiled calls (port of
``tpu_pathopt.profiling``; reference: include/tools/time_recorder.h:14-25,
src/tools/time_recorder.cpp:10-33, named clock checkpoints with a per-stage
ms printout).

:class:`TimeRecorder` takes host clock checkpoints. Handed the previous
stage's outputs, it first synchronises the CUDA device they lie on, so a
stage's time is the time the device took to finish it, not the time the
host took to enqueue it.

:func:`traced` turns on the spans of the port's compiled call
(``pipeline.compiled_call``: ``solve_batch_jit``, ``solve_jit``,
``replan.replan_step``), on one clock with the device:

- device stamps (``csrc/graph_cond.cu``): the traced key's CUDA graph
  holds a stamp node at each stage boundary ``pipeline._pipeline`` marks
  (:data:`STAGES`, then ``done``, the graph's first and last nodes) and
  just before and after each QP solve's WHILE node (``<loop>.start``,
  ``<loop>.stop``; the stop stamp also keeps the call's rounds and
  refactors of the loop); outside the graph one stamp before the input
  copy (``load``) and one after the result clone (``clone``), the call's
  last, which moves the ring to its next row. On the CPU the same points
  record ``time.perf_counter_ns()``.
- host spans of each call, in a preallocated ring: ``entry`` (the whole
  compiled call) and its children ``key`` (signature and cache lookup),
  ``load``, ``replay`` (the graph launch; on the CPU the program's run)
  and ``clone``; ``gc``, each Python collection, with its generation.
- the traced key's graph nodes by stage and by conditional body, counted
  as it is captured.

Whether tracing is on is part of a compiled key, so turning it on captures
a second graph and the untraced key is never touched; with tracing off a
call tests one module-level value (:data:`ACTIVE`) and does nothing more.

Recorded whether tracing is on or not, since none happens per call: the
set-up spans :data:`SETUP` (kernel build or load, map and ESDF, each key's
warm-up and capture) and the counts :data:`COUNTS` (graph captures,
warm-ups, cache evictions, kernel builds).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import logging
import time
from array import array

import torch

logger = logging.getLogger("tpu_pathopt_torch")

# The stage boundaries ``pipeline._pipeline`` marks, in order; ``done``
# ends the last.
STAGES = ("prep", "smooth", "corridor", "post_smooth", "bounds", "path_qp",
          "finalize")
# The host spans of one compiled call, under ``entry``.
CALL_SPANS = ("entry", "key", "load", "replay", "clone")
# Brackets (host time, stamp, host time after a synchronise) the clock map
# takes the narrowest of.
BRACKETS = 16
# The host spans a tracer keeps, the oldest overwritten.
SPANS = 1 << 16

# Process-wide counts: how many times a graph was captured, a key warmed
# up (before each capture; on the CPU under a call guard), a key was
# evicted from a full cache, and ``nvcc`` built the kernels.
COUNTS = {"captures": 0, "warm_ups": 0, "evictions": 0, "builds": 0}
# Set-up spans, the latest first dropped: (name, label, start, end), ns on
# ``time.perf_counter_ns``.
SETUP: collections.deque = collections.deque(maxlen=256)
# The tracer while tracing is on (:func:`traced`), else None.
ACTIVE: "Tracer | None" = None


class TimeRecorder:
    """Named wall-clock checkpoints (host side). Call ``record(name)`` before
    each stage and ``print_time()`` at the end, mirroring the reference
    API."""

    def __init__(self, title: str):
        self.title = title
        self._names: list[str] = []
        self._times: list[float] = []

    def record(self, name: str, block_on=None):
        """Start a named stage; first wait for the CUDA devices that hold
        any tensor of ``block_on`` (the previous stage's outputs) to finish
        their work."""
        if block_on is not None:
            from tpu_pathopt_torch.torchutil import tree_leaves
            for dev in {t.device for t in tree_leaves(block_on)
                        if t.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
        self._names.append(name)
        self._times.append(time.perf_counter())

    def stage_ms(self) -> dict:
        """Milliseconds of each recorded stage (checkpoint to the next)."""
        return {n: (b - a) * 1e3 for n, a, b in
                zip(self._names, self._times, self._times[1:])}

    def print_time(self):
        if len(self._times) < 2:
            return None
        total = (self._times[-1] - self._times[0]) * 1e3
        lines = [f"[{self.title}] total {total:.2f} ms"]
        lines += [f"  {n}: {ms:.2f} ms" for n, ms in self.stage_ms().items()]
        msg = "\n".join(lines)
        logger.info(msg)
        return msg


@contextlib.contextmanager
def stage(recorder: TimeRecorder | None, name: str):
    if recorder is not None:
        recorder.record(name)
    yield


# --------------------------------- set-up ------------------------------------

@contextlib.contextmanager
def setup_span(name: str, label: str = "", into: list | None = None):
    """Record the block as a set-up span in :data:`SETUP` (and in ``into``
    if given), even where it raises."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        rec = (name, label, t0, time.perf_counter_ns())
        SETUP.append(rec)
        if into is not None:
            into.append(rec)


# -------------------------------- tracing ------------------------------------

@contextlib.contextmanager
def traced():
    """Tracing on inside the block: compiled calls run their traced keys
    and record their spans in the yielded :class:`Tracer`; Python's
    collections are recorded as ``gc`` spans. On a CUDA machine the
    current device's clock is mapped onto the host's first."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("tracing is already on")
    tr = Tracer()
    if torch.cuda.is_available():
        tr.calibrate(torch.device("cuda", torch.cuda.current_device()))
    gc.callbacks.append(tr._gc)
    ACTIVE = tr
    try:
        yield tr
    finally:
        ACTIVE = None
        gc.callbacks.remove(tr._gc)


class Tracer:
    """The spans of the compiled calls made while tracing is on. Host spans
    go to a ring of :data:`SPANS` spans (the oldest overwritten), each with
    its name, start and end (ns on ``time.perf_counter_ns``), its parent
    (the span open when it opened) and its call's index; the device stamps
    stay in each traced key's ring on the device until :meth:`report`
    reads them."""

    def __init__(self):
        self._name = [""] * SPANS
        zeros = bytes(8 * SPANS)
        self._t0, self._t1 = array("q", zeros), array("q", zeros)
        self._parent, self._call = array("q", zeros), array("q", zeros)
        self._arg = array("q", zeros)
        self._n = 0
        self._top = -1          # the innermost open span
        self._gc_open = -1
        self.call = -1          # the call in progress, else -1
        self._entry = self._step = -1   # its open spans
        # Per call: (index of its key in ``keys``, its row in the key's
        # ring, whether the key was new).
        self.calls: list = []
        self.keys: list = []    # the traced Segments used, in order met
        self._key_index: dict = {}
        self.clock: dict = {}   # device -> its clock map (:meth:`calibrate`)
        self._counts0 = dict(COUNTS)

    # ------------------------------ host spans -------------------------------

    def open(self, name: str, arg: int = -1) -> int:
        """Open a span of the current call under the innermost open one;
        returns its number for :meth:`close`."""
        n = self._n
        i = n % SPANS
        self._name[i] = name
        self._t0[i] = time.perf_counter_ns()
        self._t1[i] = -1
        self._parent[i] = self._top
        self._call[i] = self.call
        self._arg[i] = arg
        self._n = n + 1
        self._top = n
        return n

    def close(self, n: int):
        i = n % SPANS
        self._t1[i] = time.perf_counter_ns()
        self._top = self._parent[i]

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_open = self.open("gc", info.get("generation", -1))
        elif self._gc_open >= 0:
            self.close(self._gc_open)
            self._gc_open = -1

    def begin_call(self, first: str) -> int:
        """A new call: its ``entry`` span opened, and in it ``first``. The
        call's spans carry its index (returned)."""
        self.call = len(self.calls)
        self.calls.append(None)
        self._entry = self.open("entry")
        self._step = self.open(first)
        return self.call

    def step(self, name: str):
        """Close the call's current span and open ``name`` after it."""
        self.close(self._step)
        self._step = self.open(name)

    def bind(self, segs):
        """The current call runs the traced key ``segs`` (its ring's next
        row is the call's; a key with no call before captures in it)."""
        k = self._key_index.get(id(segs))
        if k is None:
            k = self._key_index[id(segs)] = len(self.keys)
            self.keys.append(segs)
        self.calls[self.call] = (k, segs.calls_made, segs.calls_made == 0)

    def end_call(self):
        """Close the call's current span and its ``entry`` (where the call
        raised, at the time it did)."""
        self.close(self._step)
        self.close(self._entry)
        self.call = -1

    def spans(self) -> list:
        """The host spans still in the ring, oldest first: (name, start,
        end, parent, call, arg); a parent or end of -1 is none."""
        lo = max(0, self._n - SPANS)
        out = []
        for n in range(lo, self._n):
            i = n % SPANS
            p = self._parent[i]
            out.append((self._name[i], self._t0[i], self._t1[i],
                        p if p >= lo else -1, self._call[i], self._arg[i]))
        return out

    # -------------------------------- clock ----------------------------------

    def calibrate(self, device) -> dict:
        """Map ``device``'s %globaltimer onto ``time.perf_counter_ns`` from
        the narrowest of :data:`BRACKETS` brackets (host time, a stamp,
        host time after a synchronise): the offset (device less host ns),
        its half-width, and the timer's resolution as observed (the least
        step of back-to-back readings). A second calibration
        (:meth:`report`) gives the drift."""
        from tpu_pathopt_torch import kernels
        dev = torch.device(device)
        ring = torch.zeros((1, BRACKETS), dtype=torch.int64, device=dev)
        row = torch.zeros(1, dtype=torch.int64, device=dev)
        probe = torch.zeros(4096, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        torch.cuda.synchronize(dev)
        hosts = []
        for i in range(BRACKETS):
            h0 = time.perf_counter_ns()
            kernels.stamp(ring, row, i, None, 0, False, stream)
            torch.cuda.synchronize(dev)
            hosts.append((h0, time.perf_counter_ns()))
        kernels.timer_probe(probe, stream)
        stamps = ring[0].tolist()
        steps = torch.diff(probe.cpu())
        steps = steps[steps > 0]
        i = min(range(BRACKETS), key=lambda j: hosts[j][1] - hosts[j][0])
        h0, h1 = hosts[i]
        got = dict(offset_ns=stamps[i] - (h0 + h1) // 2,
                   half_width_ns=(h1 - h0) / 2,
                   resolution_ns=int(steps.min()) if len(steps) else None,
                   at_ns=h0)
        self.clock.setdefault(dev, got)
        return got

    def _offset(self, dev) -> int:
        if dev.type != "cuda":
            return 0
        if dev not in self.clock:
            self.calibrate(dev)
        return self.clock[dev]["offset_ns"]

    # -------------------------------- report ---------------------------------

    def report(self) -> dict:
        """Everything recorded, ns on the host's clock:

        - ``calls``: per call its key's index, whether the key was new
          (``first``: its graph captured in the call), its host spans
          (``host``: name -> [start, end]), its stamps (``device``: name ->
          time, device stamps mapped onto the host clock) and each loop's
          rounds and refactors (``runs``), where its key's ring still
          holds them;
        - ``gc``: [start, end, generation, call] of each collection;
        - ``nodes``: per key its graph nodes (:func:`executed_nodes`);
        - ``clock``: per device the offset, its half-width, the drift
          since tracing began and the timer's resolution;
        - ``counts``: :data:`COUNTS` since tracing began; ``setup``: the
          set-up spans in :data:`SETUP`.

        Reads each traced key's ring from the device (one read a key)."""
        rows = [_ring_rows(segs) for segs in self.keys]
        offsets = [self._offset(segs.device) for segs in self.keys]
        calls = []
        for c, bound in enumerate(self.calls):
            if bound is None:       # failed before its key was found
                calls.append(dict(call=c, key=-1, first=True, host={},
                                  device={}, runs={}))
                continue
            k, row, first = bound
            segs, (count, ring) = self.keys[k], rows[k]
            rec = dict(call=c, key=k, first=first, host={}, device={},
                       runs={})
            if count - len(ring) <= row < count:
                vals = ring[row % len(ring)]
                for name, (slot, width) in segs.slots.items():
                    if vals[slot]:
                        rec["device"][name] = vals[slot] - offsets[k]
                    if width == 3:
                        rec["runs"][name.rsplit(".", 1)[0]] = \
                            vals[slot + 1:slot + 3]
            calls.append(rec)
        gcs = []
        for name, t0, t1, _, call, arg in self.spans():
            if name == "gc":
                gcs.append([t0, t1, arg, call])
            elif 0 <= call < len(calls):
                calls[call]["host"][name] = [t0, t1]
        clock = {}
        for dev, first in self.clock.items():
            now = self.calibrate(dev) if self.keys else first
            clock[str(dev)] = dict(first, drift_ns=now["offset_ns"]
                                   - first["offset_ns"],
                                   drift_half_width_ns=now["half_width_ns"])
        return dict(
            calls=calls, gc=gcs, clock=clock,
            nodes=[dict(stages=dict(s.stage_nodes), bodies=dict(s.body_nodes),
                        loop_stage=dict(s.loop_stage),
                        stamps=s.stamp_nodes) for s in self.keys],
            counts={k: v - self._counts0.get(k, 0)
                    for k, v in COUNTS.items()},
            setup=[list(r) for r in SETUP])


def _ring_rows(segs) -> tuple:
    """(calls the key's ring has seen, its rows as lists of int)."""
    from tpu_pathopt_torch.torchutil import RING_SLOTS
    if segs.device.type == "cuda":
        flat = torch.cat([segs.counter, segs.ring.reshape(-1)]).tolist()
        count, vals = flat[0], flat[1:]
    else:
        count, vals = segs.counter, segs.ring.tolist()
    return count, [vals[i:i + RING_SLOTS]
                   for i in range(0, len(vals), RING_SLOTS)]


# ------------------------------ reading spans --------------------------------

def executed_nodes(nodes: dict, runs: dict) -> dict:
    """Graph nodes one call executes, by stage: the stage's top-level nodes
    (``nodes["stages"]``, a conditional node counting as one) plus, for
    each QP loop of the stage (``nodes["loop_stage"]``), its round body's
    nodes (``nodes["bodies"]["<loop>.round"]``) times its rounds and its
    refactor body's nodes (``"<loop>.refactor"``) times its refactors,
    ``runs[loop] = (rounds, refactors)``."""
    out = dict(nodes["stages"])
    bodies = nodes["bodies"]
    for loop, where in nodes["loop_stage"].items():
        rounds, refactors = runs.get(loop, (0, 0))
        out[where] = (out.get(where, 0)
                      + bodies.get(loop + ".round", 0) * rounds
                      + bodies.get(loop + ".refactor", 0) * refactors)
    return out


def _mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def summarize(rep: dict) -> dict:
    """Means over the calls of ``rep`` (a :meth:`Tracer.report`) that did
    not capture their key, each with every stamp: ms of each stage
    (:data:`STAGES`, stamp to the next, ``done`` ending ``finalize``), of
    each QP loop (``<loop>.start`` to ``<loop>.stop``) and of the four
    together (``qp_loop_ms``), each loop's rounds, the replay's device
    span (``prep`` to ``done``) and the device's whole call (``load`` to
    ``clone``), ms of each host span of the call, the nodes each stage
    executes and their total less the stamps (``graph_nodes``; None where
    no graph ran: on the CPU), and us a node by stage. Empty where no such
    call was made."""
    calls = [c for c in rep["calls"] if not c["first"]
             and set(STAGES) | {"done", "load", "clone"} <= set(c["device"])]
    if not calls:
        return {}
    ends = STAGES[1:] + ("done",)

    def ms(c, a, b):
        return (c["device"][b] - c["device"][a]) / 1e6

    stage_ms = {s: _mean(ms(c, s, e) for c in calls)
                for s, e in zip(STAGES, ends)}
    loops = sorted({n.rsplit(".", 1)[0] for c in calls for n in c["device"]
                    if n.endswith(".start")})
    loop_ms = {lp: _mean(ms(c, lp + ".start", lp + ".stop") for c in calls)
               for lp in loops}
    nodes = [executed_nodes(rep["nodes"][c["key"]], c["runs"])
             for c in calls if rep["nodes"][c["key"]]["stages"]]
    stage_nodes = ({s: _mean(n.get(s, 0) for n in nodes) for s in STAGES}
                   if nodes else {})
    return dict(
        calls=len(calls), stage_ms=stage_ms, loop_ms=loop_ms,
        qp_loop_ms=sum(loop_ms.values()),
        rounds={lp: _mean(c["runs"][lp][0] for c in calls) for lp in loops},
        replay_ms=_mean(ms(c, "prep", "done") for c in calls),
        device_call_ms=_mean(ms(c, "load", "clone") for c in calls),
        entry_ms={n: _mean((c["host"][n][1] - c["host"][n][0]) / 1e6
                           for c in calls if n in c["host"])
                  for n in CALL_SPANS},
        stage_nodes=stage_nodes,
        graph_nodes=sum(stage_nodes.values()) if nodes else None,
        us_per_node={s: 1e3 * stage_ms[s] / n
                     for s, n in stage_nodes.items() if n})


def _overlap(a0, a1, gap) -> int:
    return sum(max(0, min(a1, g1) - max(a0, g0)) for g0, g1 in gap)


def _union(spans) -> list:
    out = []
    for a0, a1 in sorted(spans):
        if out and a0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], a1)
        else:
            out.append([a0, a1])
    return out


def name_gap(gap: list, spans: list) -> tuple:
    """What covers most of ``gap`` (host ns intervals [(start, end)]):
    ``spans`` are (name, start, end) on the same clock, each counting only
    where no span inside it covers the gap (a collection during the clone
    counts as ``gc``, not as the clone); the part no span covers is the
    ``caller``'s. Returns (name, ns it covers, ns of the gap)."""
    total = sum(g1 - g0 for g0, g1 in gap)
    best = ("caller", total - _overlap_union([(a, b) for _, a, b in spans],
                                              gap))
    cover: dict = {}
    for name, a0, a1 in spans:
        inner = [(b0, b1) for _, b0, b1 in spans
                 if a0 <= b0 and b1 <= a1 and (b0, b1) != (a0, a1)]
        own = _overlap(a0, a1, gap) - _overlap_union(inner, gap)
        cover[name] = cover.get(name, 0) + own
    for name, ns in cover.items():
        if ns > best[1]:
            best = (name, ns)
    return best[0], best[1], total


def _overlap_union(spans, gap) -> int:
    return sum(_overlap(a0, a1, gap) for a0, a1 in _union(spans))


def gap_label(call: int, name: str, covered_ns: int, total_ns: int) -> str:
    """``call 644: gc gen2 47.1 of 49.3 ms``, at most 64 characters."""
    return (f"call {call}: {name} {covered_ns / 1e6:.1f} of "
            f"{total_ns / 1e6:.1f} ms")[:64]


def call_spans(rep: dict, call: int) -> list:
    """The named spans that may cover a gap of ``call``: its host spans but
    ``entry``, each collection (``gc gen<n>``), and its device copies
    (``load`` stamp to ``prep``: ``input copy``; ``done`` to ``clone``:
    ``result clone``), as (name, start, end) on the host clock."""
    c = rep["calls"][call]
    out = [(n, a, b) for n, (a, b) in c["host"].items() if n != "entry"]
    out += [(f"gc gen{g}", a, b) for a, b, g, _ in rep["gc"] if b >= 0]
    d = c["device"]
    if {"load", "prep"} <= set(d):
        out.append(("input copy", d["load"], d["prep"]))
    if {"done", "clone"} <= set(d):
        out.append(("result clone", d["done"], d["clone"]))
    return out


def longest_gaps(rep: dict, calls: list, walls: list, top: int = 10) -> list:
    """The ``top`` longest gaps of ``calls`` (records of ``rep``, a
    :meth:`Tracer.report`), each call's wall on the host clock
    (``walls``: its caller's (start, end) ns, in the same order) less its
    graph's device span (``prep`` to ``done``), as [ms, label], each named
    by :func:`name_gap` over :func:`call_spans`."""
    out = []
    for c, (w0, w1) in zip(calls, walls):
        d = c["device"]
        if "prep" not in d or "done" not in d:
            continue
        gap = [(w0, max(w0, min(w1, d["prep"]))),
               (min(w1, max(w0, d["done"])), w1)]
        name, ns, total = name_gap(gap, call_spans(rep, c["call"]))
        out.append([total / 1e6, gap_label(c["call"], name, ns, total)])
    return sorted(out, reverse=True)[:top]

