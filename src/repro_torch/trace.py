"""Spans and counters of the port's engine, kept in memory while a
:func:`recording` block is open.

Recording is off by default. The engine marks where its work happens with
``with trace.span(name):`` and ``trace.count(name, n)``; while nothing
records, each is one check of a module attribute (``span`` then returns a
shared no-op context). An operator turns it on for a block::

    from repro_torch import trace

    with trace.recording() as rec:
        run = lasana.simulate(spec, x, surrogates=sur)
    snap = rec.snapshot()
    snap.spans       # [Span(name, start_ns, end_ns, seq, parent, id, thread)]
    snap.counters    # {"records.bytes": ..., "launches.network_tick": ...}

A span records its name, its start and end on ``time.perf_counter_ns()``,
its parent (the innermost span open on the same thread) and an ``id``
shared by the spans of one call or one chunk: a span given no id takes its
parent's, and a span with neither takes its own sequence number (so a
call's spans carry the sequence number of its ``engine.dispatch`` span).
The snapshot's counters also hold ``ops.LAUNCHES``' moves since recording
began, as ``launches.<kernel>``, and the kernel libraries loaded since, as
``kernels.loaded``.

Nothing is written out and no profiler range is emitted: a
``torch.profiler.record_function`` range would be mirrored onto the
device's timeline on the card and counted there as a device operation.

The spans the engine records (``core/network.py``):

    engine.dispatch     NetworkEngine.dispatch, id = the call
      engine.build      a runner built on a cache miss
      engine.enqueue    the runner call: every tick enqueued
        engine.pack     the megakernel head pack of a block of ticks
        tick / chunk    one tick of the per-tick loop / one time-looped launch
          layer.drive   a layer's adapters, synaptic product, event detection
          layer.step    that layer's Algorithm-1 tick
        engine.flush    the run-end idle-energy flush
    run.result          PendingRun.result, id = the call
      run.wait          the wait on the event recorded at the end of dispatch
      run.fetch         the copies to the host and the NetworkRun
    stream.*            a stream's per-chunk steps, id = the chunk index:
                        block, upload, to_host, wait, convert, flush (and
                        engine.build / engine.enqueue as above)

and the counters: ``records.bytes`` (record bytes brought to the host),
``runner.builds`` (runners built on a cache miss) and ``kernels.loaded``
(kernel libraries loaded while it recorded: ``_build.n_loaded()``'s move).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import NamedTuple, Optional

_active: Optional["Recorder"] = None      # the recorder while recording
_switch = threading.Lock()

# the engine's counters, present (at 0) in every snapshot
COUNTERS = ("records.bytes", "runner.builds", "kernels.loaded")


class Span(NamedTuple):
    name: str
    start_ns: int            # time.perf_counter_ns()
    end_ns: int
    seq: int                 # the span's number within its recording
    parent: Optional[int]    # the enclosing span's seq, None at the top
    id: Optional[int]        # the call or chunk the span belongs to
    thread: int              # threading.get_ident() of its thread


@dataclasses.dataclass
class Snapshot:
    spans: list              # Span, in the order they ended
    counters: dict           # name -> total


class _Null:
    """The context ``span`` returns while nothing records."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """One span while it is open."""

    __slots__ = ("rec", "name", "id", "seq", "parent", "start")

    def __init__(self, rec, name, id):
        self.rec, self.name, self.id = rec, name, id

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.seq = next(rec._seqs)
        self.parent = None if top is None else top.seq
        if self.id is None:
            self.id = self.seq if top is None else top.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = self.rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.rec._add(Span(self.name, self.start, end, self.seq,
                           self.parent, self.id, threading.get_ident()))
        return False


class Recorder:
    """The spans and counters of one :func:`recording` block: a list and
    a dict under one lock, so any thread may record into it."""

    def __init__(self):
        from repro_torch.kernels import _build, ops
        self._lock = threading.Lock()
        self._spans: list = []
        self._counters: dict = dict.fromkeys(COUNTERS, 0)
        self._seqs = itertools.count()
        self._local = threading.local()
        self._launches0 = dict(ops.LAUNCHES)
        self._loaded0 = _build.n_loaded()
        self._closed = None               # (launches, loaded) when it closed

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def add(self, name: str, n) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def _now(self) -> tuple:
        from repro_torch.kernels import _build, ops
        return dict(ops.LAUNCHES), _build.n_loaded()

    def _close(self) -> None:
        self._closed = self._now()

    def snapshot(self) -> Snapshot:
        """The spans ended so far and the counters, with the kernel
        launches counted while it recorded as ``launches.<kernel>`` and
        the libraries loaded as ``kernels.loaded``."""
        with self._lock:
            spans, counters = list(self._spans), dict(self._counters)
        launches, loaded = self._closed or self._now()
        counters["kernels.loaded"] = loaded - self._loaded0
        for k, v in launches.items():
            moved = v - self._launches0.get(k, 0)
            if moved:
                counters[f"launches.{k}"] = moved
        return Snapshot(spans=spans, counters=counters)


def span(name: str, id: Optional[int] = None):
    """A context that records one span while a recording is open (a
    shared no-op one otherwise); ``as`` gives it, with its ``id``."""
    rec = _active
    if rec is None:
        return _NULL
    return _Open(rec, name, id)


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` while a recording is open."""
    rec = _active
    if rec is not None:
        rec.add(name, n)


@contextlib.contextmanager
def recording():
    """Record the process's spans and counters for the block; yields the
    :class:`Recorder`. One recording is open at a time."""
    global _active
    rec = Recorder()
    with _switch:
        if _active is not None:
            raise RuntimeError("a trace recording is already open")
        _active = rec
    try:
        yield rec
    finally:
        with _switch:
            _active = None
        rec._close()
