"""The program's own spans and counters (``repro_torch.trace``) over the
benchmark's traced slice, placed on the device trace's clock.

The recorder is on exactly over the profiled slice (:class:`RecordingSlice`
opens ``trace.recording()`` after the profiler starts and closes it before
the profiler stops). Program spans are on ``time.perf_counter_ns``; the
profile's events are on the profiler's own clock, so one offset maps the
first onto the second, fitted over the harness's ``bench.*`` spans, which
it holds in both clocks (:func:`fit_clock`; the most a mapped time can be
off is ``span_clock_error_us``). With it each idle gap of the slice is named
``host:<bench span>/<innermost program span>`` (:func:`name_gaps`), and
``idle_named_share`` is the share of the idle seconds that a program span
covers.

The per-layer metrics that read the snapshot are ``PROGRAM_METRICS`` (their
readers in ``metrics/``, each over ``ctx.program`` and ``ctx.slice_ticks``;
None where the run holds no snapshot). ``run.py`` does not open the
recorder, so no cell reports them yet; this script runs a cell as
``run.py`` does with the recorder on::

    python3 lasana_bench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

``--trace 1`` records over the profiled slice and adds to the result line
the four metrics, the counters, ``span_clock_error_us``,
``idle_named_share``, the named gaps and the slice's garbage collections;
``--trace 0`` records over the whole run, so that its ``events_per_s``
against ``run.py``'s is what recording costs, and adds the span metrics
read over the timed window alone, without the profiler.

:func:`hooked`, :func:`traced_run` and :func:`main` are a stand-in for
``run.py``: they swap ``profiling.Slice`` and ``harness.reader`` for the
length of one run. They go once ``profiling.Slice`` opens and closes the
recorder and ``run.py`` sets ``ctx.program`` itself; what stays is
:class:`RecordingSlice`, :func:`fit_clock`, :func:`name_gaps`,
:func:`program_extras`, ``PROGRAM_METRICS`` and the readers.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import pathlib
import sys
import time
import types

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from lasana_bench import harness, profiling  # noqa: E402

# the per-layer entries the program's snapshot feeds, as BENCHMARK.json
# would list them
PROGRAM_METRICS = [
    {"name": "enqueue_ms_per_tick", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "engine", "moves": "events_per_s"},
    {"name": "host_wait_ms_per_tick", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "engine records",
     "moves": "events_per_s"},
    {"name": "fetch_ms_per_tick", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "engine records",
     "moves": "events_per_s"},
    {"name": "record_bytes_per_tick", "unit": "MB", "better": "lower",
     "source": "program_counter", "layer": "engine records",
     "moves": "events_per_s"},
]


def span_ms_per_tick(ctx, names):
    """Host milliseconds of the program's spans named ``names`` in the
    slice, per simulated tick; None without a snapshot or such spans."""
    snap = getattr(ctx, "program", None)
    if snap is None:
        return None
    ns = [s.end_ns - s.start_ns for s in snap.spans if s.name in names]
    if not ns or not ctx.slice_ticks:
        return None
    return sum(ns) / 1e6 / ctx.slice_ticks


class RecordingSlice(profiling.Slice):
    """The profiled slice with the program's recorder on over it:
    ``program`` is the snapshot (None where the program has no recorder),
    ``perf`` the slice's ends on ``time.perf_counter``, ``gc`` the
    interpreter's garbage collections in it as ``(start_s, end_s)`` on the
    same clock."""

    def start(self):
        try:
            trace = importlib.import_module("repro_torch.trace")
        except ImportError:
            trace = None
        super().start()
        self._open = contextlib.ExitStack()
        self.recorder = (self._open.enter_context(trace.recording())
                         if trace is not None else None)
        self.gc, began = [], []

        def collected(phase, info):
            if phase == "start":
                began.append(time.perf_counter())
            elif began:
                self.gc.append((began.pop(), time.perf_counter()))
        gc.callbacks.append(collected)
        self._open.callback(gc.callbacks.remove, collected)
        self.perf = [time.perf_counter(), None]

    def stop(self):
        self._sync()
        self.perf[1] = time.perf_counter()
        self._open.close()
        self.program = (self.recorder.snapshot()
                        if self.recorder is not None else None)
        super().stop()


def bench_events(prof) -> tuple:
    """``(window, spans)`` of a finished profile, in microseconds on its
    clock: the ``bench.slice`` range and the other ``bench.*`` ranges as
    ``(name, start, end)``, in order."""
    from torch.autograd import DeviceType
    host = [e for e in prof.events() if e.device_type != DeviceType.CUDA
            and e.name.startswith("bench.")]
    win = next(e for e in host if e.name == "bench.slice")
    spans = sorted(((e.name[len("bench."):], e.time_range.start,
                     e.time_range.end) for e in host
                    if e.name != "bench.slice"), key=lambda s: s[1])
    return (win.time_range.start, win.time_range.end), spans


def fit_clock(profiled, held, perf) -> tuple:
    """``(offset_us, error_us)``: profile time = perf_counter time in
    microseconds + offset, from the slice's bench spans (``profiled``: the
    profile's ``(name, start_us, end_us)``; ``held``: the harness's
    ``(name, start_s, end_s)`` on ``time.perf_counter``, those inside
    ``perf`` = the slice's ends, paired in turn). A held span starts before
    its profiled range and ends after it (the harness reads the clock, then
    opens the range), so the offset lies between the largest end
    difference and the smallest start difference; the offset is their
    middle and the error half their distance, the most a mapped time can
    be off (or, where the two cross, half by how much the spans
    contradict one offset). ``(None, None)`` where the two do not pair."""
    inside = [s for s in held if perf[0] <= s[1] and s[2] <= perf[1]]
    if not profiled or [s[0] for s in inside] != [s[0] for s in profiled]:
        return None, None
    hi = min(p[1] - h[1] * 1e6 for p, h in zip(profiled, inside))
    lo = max(p[2] - h[2] * 1e6 for p, h in zip(profiled, inside))
    return (lo + hi) / 2, abs(hi - lo) / 2


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def name_gaps(window, device_ops, bench_spans, program) -> tuple:
    """``(gaps, idle_named_share)``: each idle gap of the slice (between
    ``device_ops``' intervals inside ``window``, all in microseconds on the
    profile's clock) as ``(name, seconds, seconds into the slice)``,
    longest first, named
    ``host:<bench span>`` (the innermost one at its middle, or
    ``host:harness``) plus ``/<program span>`` where a program span
    (``(name, start, end)`` mapped onto the same clock) covers the middle,
    the innermost (latest started) one; and the share of the idle time
    that the program's spans cover."""
    w0, w1 = window
    busy = _merged((max(a, w0), min(b, w1)) for a, b in device_ops
                   if min(b, w1) > max(a, w0))
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    covered = _merged((a, b) for _, a, b in program)
    program = sorted(program, key=lambda s: s[1])
    gaps, idle, named = [], 0.0, 0.0
    nxt, active, c = 0, [], 0          # a sweep over the gaps in time order
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        bench = [s for s in bench_spans if s[1] <= mid <= s[2]]
        name = f"host:{bench[-1][0]}" if bench else "host:harness"
        while nxt < len(program) and program[nxt][1] <= mid:
            active.append(program[nxt])
            nxt += 1
        active = [s for s in active if s[2] >= mid]
        if active:
            name += "/" + max(active, key=lambda s: s[1])[0]
        gaps.append((name, (b - a) / 1e6, (a - w0) / 1e6))
        idle += b - a
        while c < len(covered) and covered[c][1] <= a:
            c += 1
        k = c
        while k < len(covered) and covered[k][0] < b:
            named += min(b, covered[k][1]) - max(a, covered[k][0])
            k += 1
    gaps.sort(key=lambda g: -g[1])
    return gaps, (named / idle if idle > 0 else None)


def program_extras(sl, trace_, held) -> dict:
    """What the slice adds to the result line: the program's counters,
    ``span_clock_error_us``, ``idle_named_share``, the ten longest idle
    gaps named by the program's spans, and the seconds of garbage
    collection in the slice (``gc_s``) with its five longest pauses as
    ``(seconds, seconds into the slice)`` (``sl`` a finished
    :class:`RecordingSlice`, ``trace_`` its ``reduce()``, ``held`` the
    harness's spans)."""
    if sl.program is None:
        return {}
    window, profiled = bench_events(sl.prof)
    off, err = fit_clock(profiled, held, sl.perf)
    out = {"counters": dict(sl.program.counters), "span_clock_error_us": err}
    if off is None:
        return out
    program = [(s.name, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off)
               for s in sl.program.spans]
    ops = [(a * 1e6, b * 1e6) for _, _, a, b in trace_.ops]
    gaps, share = name_gaps(window, ops, profiled, program)
    out["idle_named_share"] = share
    out["idle_gaps"] = [list(g) for g in gaps[:10]]
    out["gc_s"] = sum(b - a for a, b in sl.gc)
    out["gc_longest"] = sorted(((b - a, (a * 1e6 + off - window[0]) / 1e6)
                                for a, b in sl.gc), reverse=True)[:5]
    return out


@contextlib.contextmanager
def hooked():
    """Within the block, ``run.run_cell`` profiles its slice through a
    :class:`RecordingSlice` and hands each metric reader a context that
    holds ``program``, the slice's snapshot (what ``run.py`` would do
    itself once it opens the recorder): yields a namespace whose ``slice``
    (None untraced) and ``ctx`` are the run's. A stand-in, to be deleted
    with :func:`traced_run` and :func:`main` once ``run.py`` does this."""
    got = types.SimpleNamespace(slice=None, ctx=None)
    make, reader = profiling.Slice, harness.reader

    def recording_slice(torch):
        got.slice = RecordingSlice(torch)
        return got.slice

    def with_program(name, bench=harness.BENCH):
        read = reader(name, bench)

        def read_ctx(ctx):
            if got.slice is not None:
                ctx.program = got.slice.program
            got.ctx = ctx
            return read(ctx)
        return read_ctx

    profiling.Slice, harness.reader = recording_slice, with_program
    try:
        yield got
    finally:
        profiling.Slice, harness.reader = make, reader


def _program_metrics(ctx, bench) -> dict:
    out = {}
    for m in PROGRAM_METRICS:
        v = harness.reader(m["name"], bench)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def traced_run(manifest, cell, seed, seconds, trace, **kw) -> tuple:
    """``run.run_cell`` with the program's recorder on over the slice
    (``trace``) or over the whole run: ``(result, check lines)``, the
    result holding the program's metrics and extras. Untraced, the span
    metrics are also read over the timed window alone (its calls or
    chunks, without the profiler), as ``window_program_metrics``."""
    from lasana_bench import run
    from repro_torch import trace as program_trace
    bench = kw.get("bench", harness.BENCH)
    with hooked() as got:
        if trace:
            result, lines = run.run_cell(manifest, cell, seed, seconds,
                                         True, **kw)
        else:
            with program_trace.recording() as rec:
                result, lines = run.run_cell(manifest, cell, seed, seconds,
                                             False, **kw)
    if trace:
        result["metrics"].update(_program_metrics(got.ctx, bench))
        result.update(program_extras(got.slice, got.ctx.trace,
                                     got.ctx.spans.spans))
        return result, lines
    snap = rec.snapshot()
    t0, t1 = got.ctx.units[0]["t0"] * 1e9, got.ctx.units[-1]["t1"] * 1e9
    got.ctx.program = types.SimpleNamespace(counters={}, spans=[
        s for s in snap.spans if t0 <= s.start_ns and s.end_ns <= t1])
    result["window_program_metrics"] = _program_metrics(got.ctx, bench)
    result["program_counters"] = snap.counters
    return result, lines


def main(argv=None) -> int:
    import argparse
    from lasana_bench import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run._caches()
    manifest = harness.load_manifest(ROOT / "BENCHMARK.json")
    result, lines = traced_run(manifest, args.workload, args.seed,
                               args.seconds, bool(args.trace))
    for ln in lines:
        print(ln, file=sys.stderr)
    print(json.dumps({"route": result["launches"],
                      "traced": result.get("traced_launches")}))
    print(harness.result_line(**result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
