"""The port's span and counter recorder (``repro_torch.trace``): the span
tree the engine records for a batch call, a crossbar wave and a chunked
stream, the counters at the same boundaries, nothing recorded (and
nothing allocated) with recording off, threads recording at once, and
the program audit's per-tick counts unchanged with recording on."""

import contextlib
import pathlib
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import lasana, trace  # noqa: E402
from repro_torch.analysis import jaxpr_audit  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402

KNOBS = np.asarray([0.58, 0.5, 0.5, 0.5], np.float32)


def _snn(widths, seed=0):
    """A fresh LIF spec of ``widths`` (its own engine cache)."""
    rng = np.random.default_rng(seed)
    ws = [rng.uniform(-1, 1, (a, b)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    return network.snn_spec(ws, [KNOBS] * len(ws))


def _spikes(t, b, n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((t, b, n)) < 0.5).astype(np.float32) * 1.5


@pytest.fixture(scope="module")
def lif():
    return jaxpr_audit.synthetic_surrogate("lif", device="cpu")


@pytest.fixture(scope="module")
def xbar():
    return jaxpr_audit.synthetic_surrogate("crossbar", device="cpu")


def _by_seq(snap):
    return {s.seq: s for s in snap.spans}


def _children(snap, span):
    return sorted((s for s in snap.spans if s.parent == span.seq),
                  key=lambda s: s.start_ns)


def _named(snap, name):
    return sorted((s for s in snap.spans if s.name == name),
                  key=lambda s: s.start_ns)


def _assert_nested(snap):
    """Every child lies inside its parent, on its parent's thread."""
    seqs = _by_seq(snap)
    for s in snap.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = seqs[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s
            assert p.thread == s.thread


def _record_nbytes(run, final=True):
    """Bytes of a NetworkRun's records as they leave the device: every
    array of the record, events at their device width (int32), the flush
    only where the device computed it (a batch call, a stream's final
    chunk)."""
    arrays = [run.outputs, run.energy, run.latency]
    if run.out_spikes is not None:
        arrays.append(run.out_spikes)
    arrays += run.layer_spikes or []
    if final:
        arrays.append(run.flush_energy)
    return sum(a.nbytes for a in arrays) + run.events.size * 4


# --- the span tree --------------------------------------------------------------

def test_snn_simulate_span_tree(lif):
    spec = _snn((6, 5, 3))
    x = _spikes(3, 2, 6)
    with trace.recording() as rec:
        run = lasana.simulate(spec, x, surrogates=lif, device="cpu")
    snap = rec.snapshot()
    _assert_nested(snap)
    (dispatch,) = _named(snap, "engine.dispatch")
    (result,) = _named(snap, "run.result")
    assert dispatch.parent is None and result.parent is None
    assert dispatch.id == dispatch.seq and result.id == dispatch.id
    assert {s.id for s in snap.spans} == {dispatch.id}
    assert [s.name for s in _children(snap, dispatch)] == [
        "engine.build", "engine.enqueue"]
    enqueue = _children(snap, dispatch)[1]
    names = [s.name for s in _children(snap, enqueue)]
    assert names == ["engine.pack", "tick", "tick", "tick", "engine.flush"]
    for tick in _named(snap, "tick"):
        assert [s.name for s in _children(snap, tick)] == [
            "layer.drive", "layer.step"] * 2
    assert [s.name for s in _children(snap, result)] == [
        "run.wait", "run.fetch"]
    assert snap.counters["records.bytes"] == _record_nbytes(run)
    assert snap.counters["runner.builds"] == 1
    assert run.energy.shape == (3, 2)


def test_crossbar_wave_span_tree(xbar):
    rng = np.random.default_rng(2)
    spec = network.crossbar_mlp_spec(
        [rng.integers(-1, 2, (40, 12)), rng.integers(-1, 2, (12, 4))])
    volts = rng.uniform(-0.8, 0.8, (3, 40)).astype(np.float32)
    with trace.recording() as rec:
        run = lasana.simulate(spec, volts, surrogates=xbar, device="cpu")
    snap = rec.snapshot()
    _assert_nested(snap)
    (tick,) = _named(snap, "tick")
    assert [s.name for s in _children(snap, tick)] == [
        "layer.drive", "layer.step"] * 2
    (enqueue,) = _named(snap, "engine.enqueue")
    assert tick.parent == enqueue.seq
    assert run.out_spikes is None
    assert snap.counters["records.bytes"] == _record_nbytes(run)


@pytest.mark.parametrize("widths,per_tick", [((6, 5, 3), True),
                                             ((6, 5), False)])
def test_stream_span_tree(lif, widths, per_tick):
    """Four chunks of two ticks: the stream's steps are top-level spans
    with the chunk's index as their id; a two-layer graph enqueues tick
    by tick, a one-LIF-layer graph one time-looped chunk."""
    spec = _snn(widths, seed=3)
    x = _spikes(8, 2, 6, seed=4)
    with trace.recording() as rec:
        chunks = list(lasana.stream(spec, x, chunk_ticks=2, surrogates=lif,
                                    device="cpu"))
    snap = rec.snapshot()
    _assert_nested(snap)
    assert len(chunks) == 4
    top = [s for s in snap.spans if s.parent is None]
    ids = lambda name: [s.id for s in _named(snap, name)]
    assert ids("stream.block") == [0, 1, 2, 3, 4]   # the last finds none
    for name in ("stream.upload", "engine.enqueue", "stream.to_host",
                 "stream.wait", "stream.convert"):
        assert ids(name) == [0, 1, 2, 3], name
    assert ids("stream.flush") == [3]
    assert ids("engine.build") == [0, 3]            # the step, the flush
    assert {s.name for s in top} == {
        "stream.block", "stream.upload", "engine.build", "engine.enqueue",
        "stream.to_host", "stream.wait", "stream.convert", "stream.flush"}
    (flush,) = _named(snap, "stream.flush")
    assert [s.name for s in _children(snap, flush)] == ["engine.flush"]
    for enq in _named(snap, "engine.enqueue"):
        kids = [s.name for s in _children(snap, enq)]
        assert kids == (["engine.pack", "tick", "tick"] if per_tick
                        else ["engine.pack", "chunk"])
        assert all(s.id == enq.id for s in snap.spans
                   if s.parent == enq.seq)
    if not per_tick:
        for ch in _named(snap, "chunk"):
            assert [s.name for s in _children(snap, ch)] == [
                "layer.drive", "layer.step"]
    # chunk k's records are read once chunk k+1 is enqueued
    enq, conv = _named(snap, "engine.enqueue"), _named(snap, "stream.convert")
    for k in range(3):
        assert enq[k + 1].end_ns <= conv[k].start_ns
    want = sum(_record_nbytes(c, final=i == 3) for i, c in enumerate(chunks))
    assert snap.counters["records.bytes"] == want
    assert snap.counters["runner.builds"] == 2


def test_builds_then_hits_on_a_repeat_call(lif):
    """The first call builds its runner; the repeat finds it cached:
    no build counted and no ``engine.build`` span."""
    spec = _snn((6, 5, 3), seed=5)
    x = _spikes(2, 2, 6)
    counts = []
    for _ in range(2):
        with trace.recording() as rec:
            lasana.simulate(spec, x, surrogates=lif, device="cpu")
        snap = rec.snapshot()
        counts.append((snap.counters["runner.builds"],
                       len(_named(snap, "engine.build")),
                       len(_named(snap, "engine.enqueue"))))
    assert counts == [(1, 1, 1), (0, 0, 1)]


def test_snapshot_holds_every_counter_and_the_launches():
    with trace.recording() as rec:
        ops.count_launch("network_tick")
        ops.count_launch("network_tick")
    ops.LAUNCHES["network_tick"] -= 2
    c = rec.snapshot().counters
    assert set(trace.COUNTERS) <= set(c)
    assert c["launches.network_tick"] == 2
    assert not any(k.startswith("launches.") and k != "launches.network_tick"
                   for k in c)


def test_kernel_loads_are_counted(monkeypatch):
    monkeypatch.setattr(_build, "_start", lambda name: None)
    monkeypatch.setattr(_build, "_target", lambda name: pathlib.Path(name))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_LIBS", {})
    with trace.recording() as rec:
        _build.library("probe")
        _build.library("probe")
    assert rec.snapshot().counters["kernels.loaded"] == 1


# --- ids, errors, nesting ---------------------------------------------------------

def test_ids_inherit_and_roots_take_their_own():
    with trace.recording() as rec:
        with trace.span("a") as a:
            with trace.span("b"):
                pass
            with trace.span("c", 41):
                with trace.span("d"):
                    pass
        with trace.span("e"):
            pass
    s = {x.name: x for x in rec.snapshot().spans}
    assert a.id == s["a"].seq == s["b"].id
    assert s["c"].id == s["d"].id == 41
    assert s["e"].id == s["e"].seq != s["a"].id
    assert s["d"].parent == s["c"].seq and s["c"].parent == s["a"].seq


def test_a_raising_call_closes_its_span(lif):
    spec = _snn((6, 5, 3), seed=6)
    with trace.recording() as rec:
        with pytest.raises(ValueError, match="fan_in"):
            lasana.simulate(spec, _spikes(2, 2, 7), surrogates=lif,
                            device="cpu")
        with trace.span("after"):
            pass
    snap = rec.snapshot()
    (d,) = _named(snap, "engine.dispatch")
    (after,) = _named(snap, "after")
    assert after.parent is None and d.end_ns <= after.start_ns


def test_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass
    with trace.recording() as rec:         # closed: a new one opens
        trace.count("records.bytes", 3)
    assert rec.snapshot().counters["records.bytes"] == 3


# --- recording off ----------------------------------------------------------------

def test_nothing_recorded_or_allocated_when_off(lif, monkeypatch):
    assert trace._active is None
    assert trace.span("x") is trace.span("y", 3) is trace._NULL

    def refuse(*a, **k):
        raise AssertionError("a span was opened with recording off")

    monkeypatch.setattr(trace, "_Open", refuse)
    monkeypatch.setattr(trace.Recorder, "add", refuse)
    spec = _snn((6, 5, 3), seed=7)
    lasana.simulate(spec, _spikes(2, 2, 6), surrogates=lif, device="cpu")
    for _ in lasana.stream(spec, _spikes(4, 2, 6), chunk_ticks=2,
                           surrogates=lif, device="cpu"):
        pass
    with trace.span("z") as z:
        assert z.id is None


def test_durations_do_not_read_the_wall_clock(lif, monkeypatch):
    """``wall_seconds`` and the build and load times come from the
    monotonic ``time.perf_counter``."""
    def wall():
        raise AssertionError("time.time() read")

    spec = _snn((6, 5, 3), seed=8)
    monkeypatch.setattr(network, "time", types.SimpleNamespace(
        time=wall, perf_counter=time.perf_counter))
    run = lasana.simulate(spec, _spikes(2, 2, 6), surrogates=lif,
                          device="cpu")
    chunks = list(lasana.stream(spec, _spikes(4, 2, 6), chunk_ticks=2,
                                surrogates=lif, device="cpu"))
    monkeypatch.undo()
    assert 0.0 <= run.wall_seconds < 60.0 and run.compile_seconds >= 0.0
    assert all(0.0 <= c.wall_seconds < 60.0 for c in chunks)


# --- threads --------------------------------------------------------------------

def _in_thread_pool(n, work):
    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


def test_threads_record_at_once():
    """More threads than cores, a short switch interval: no span or count
    is lost, and each span's parent is on its own thread."""
    n, k = 16, 300
    errors = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as rec:
            def work(i):
                try:
                    for j in range(k):
                        with trace.span("outer", i):
                            with trace.span("inner"):
                                trace.count("probe")
                except Exception as e:        # noqa: BLE001 - reported below
                    errors.append(e)
            _in_thread_pool(n, work)
    finally:
        sys.setswitchinterval(switch)
    assert errors == []
    snap = rec.snapshot()
    assert len(snap.spans) == 2 * n * k
    assert snap.counters["probe"] == n * k
    assert len({s.seq for s in snap.spans}) == 2 * n * k
    seqs = _by_seq(snap)
    for s in snap.spans:
        if s.name == "inner":
            p = seqs[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert s.id == p.id
        else:
            assert s.parent is None


def test_two_threads_simulate_while_recording(lif):
    specs = [_snn((6, 5, 3), seed=10 + i) for i in range(2)]
    x = _spikes(3, 2, 6)
    runs = [None, None]
    both = threading.Barrier(2, timeout=60)    # alive at once: two idents

    def work(i):
        both.wait()
        runs[i] = lasana.simulate(specs[i], x, surrogates=lif, device="cpu")

    with trace.recording() as rec:
        _in_thread_pool(2, work)
    snap = rec.snapshot()
    _assert_nested(snap)
    calls = _named(snap, "engine.dispatch")
    assert len(calls) == 2 and len({c.id for c in calls}) == 2
    assert len({c.thread for c in calls}) == 2
    for c in calls:
        mine = [s for s in snap.spans if s.id == c.id]
        assert {s.thread for s in mine} == {c.thread}
        assert sum(s.name == "tick" for s in mine) == 3
    assert snap.counters["records.bytes"] == sum(map(_record_nbytes, runs))


# --- the program audit ------------------------------------------------------------

def test_audit_counts_unchanged_with_recording_on():
    """The span sites add no aten op: every entrypoint's frozen row holds
    with a recording open around each counted run."""
    snaps = []

    @contextlib.contextmanager
    def around():
        with trace.recording() as rec:
            yield
        snaps.append(rec.snapshot())

    with jaxpr_audit.pinned_env():
        ctx = jaxpr_audit.build_context("cpu")
        audited = jaxpr_audit._audit_all(ctx, around)
    rows = {name: m.budget_row() for name, (m, _) in audited.items()}
    frozen = jaxpr_audit.load_budgets()
    assert jaxpr_audit.compare_budgets(rows, frozen, ctx.device) == []
    assert rows == frozen
    assert any(s.name == "tick" for snap in snaps for s in snap.spans)

