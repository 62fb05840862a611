"""The program's spans and counters in the benchmark, on the CPU: the four
readers over a synthetic snapshot, the clock fit and the gap names on
synthetic intervals and on a CPU profile, the manifest sound with the
four entries added, and a traced run at a tiny size."""

import copy
import pathlib
import types

import numpy as np
import pytest

from lasana_bench import harness, program_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = [m["name"] for m in program_trace.PROGRAM_METRICS]
SPAN_NAMES = ("engine.dispatch", "engine.build", "engine.enqueue",
              "engine.pack", "tick", "chunk", "layer.drive", "layer.step",
              "engine.flush", "run.result", "run.wait", "run.fetch",
              "stream.block", "stream.upload", "stream.to_host",
              "stream.wait", "stream.convert", "stream.flush")


def _span(name, a_ms, b_ms, seq=0, parent=None):
    from repro_torch.trace import Span
    return Span(name, int(a_ms * 1e6), int(b_ms * 1e6), seq, parent, 0, 1)


def _ctx(spans, counters, ticks):
    return types.SimpleNamespace(
        program=types.SimpleNamespace(spans=spans, counters=counters),
        slice_ticks=ticks)


def test_readers_over_a_synthetic_snapshot():
    spans = [_span("engine.dispatch", 0, 10), _span("engine.enqueue", 1, 7),
             _span("engine.enqueue", 20, 23), _span("run.wait", 10, 14),
             _span("stream.wait", 30, 31), _span("run.fetch", 14, 16),
             _span("stream.to_host", 40, 40.5),
             _span("stream.convert", 41, 42.5), _span("tick", 2, 3)]
    ctx = _ctx(spans, {"records.bytes": 12_000_000}, 4)
    got = {n: harness.reader(n)(ctx) for n in NAMES}
    assert got == pytest.approx({
        "enqueue_ms_per_tick": (6 + 3) / 4, "host_wait_ms_per_tick": 5 / 4,
        "fetch_ms_per_tick": (2 + 0.5 + 1.5) / 4,
        "record_bytes_per_tick": 3.0})


@pytest.mark.parametrize("ctx", [
    types.SimpleNamespace(slice_ticks=4),                # no snapshot
    types.SimpleNamespace(program=None, slice_ticks=4),
    _ctx([], {"records.bytes": 0}, 4),                   # nothing in it
])
def test_readers_find_nothing_without_the_program(ctx):
    assert [harness.reader(n)(ctx) for n in NAMES] == [None] * 4


def test_manifest_sound_with_the_four_entries():
    m = harness.load_manifest(ROOT / "BENCHMARK.json")
    m["per_layer"] += copy.deepcopy(program_trace.PROGRAM_METRICS)
    assert harness.check_manifest(m) == []
    layers = {x["layer"] for x in m["per_layer"]}
    assert {x["layer"] for x in program_trace.PROGRAM_METRICS} <= layers
    for cell in (w["name"] for w in m["workloads"]):
        got = {x["name"] for x in harness.metrics_for(m, cell, True)}
        assert set(NAMES) <= got


def test_fit_clock_on_synthetic_spans():
    held = [("dispatch", 1.0, 1.5), ("result", 1.5, 2.0),
            ("dispatch", 2.0, 2.2), ("late", 9.0, 9.5)]
    off = 1234.5
    profiled = [(n, a * 1e6 + off + d, b * 1e6 + off - d)
                for (n, a, b), d in zip(held[:3], (2.0, 4.0, 6.0))]
    got_off, err = program_trace.fit_clock(profiled, held, (0.5, 3.0))
    # the tightest start (2 us in) and end (2 us early) bracket the offset
    assert got_off == pytest.approx(off) and err == pytest.approx(2.0)
    # a range ending 6 us past its held span: start and end bounds cross
    # by 4 us, half of it either way
    bad = profiled[:2] + [("dispatch", 2.0e6 + off + 10, 2.2e6 + off + 6)]
    assert program_trace.fit_clock(bad, held, (0.5, 3.0)) == \
        pytest.approx((off + 4.0, 2.0))
    renamed = [("result",) + p[1:] for p in profiled]
    assert program_trace.fit_clock(renamed, held, (0.5, 3.0)) == (None,
                                                                  None)


def test_name_gaps_on_synthetic_intervals():
    window = (0.0, 100.0)
    ops = [(10.0, 20.0), (15.0, 30.0), (60.0, 70.0)]
    bench = [("dispatch", 0.0, 50.0), ("result", 50.0, 100.0)]
    program = [("engine.dispatch", 2.0, 48.0), ("engine.enqueue", 5.0, 45.0),
               ("tick", 32.0, 46.0), ("run.wait", 52.0, 90.0)]
    gaps, share = program_trace.name_gaps(window, ops, bench, program)
    assert gaps == [("host:dispatch/tick", 30e-6, 30e-6),
                    ("host:result/run.wait", 30e-6, 70e-6),
                    ("host:dispatch/engine.enqueue", 10e-6, 0.0)]
    # idle 0-10, 30-60, 70-100: spans cover 2-10, 30-48, 52-60, 70-90
    assert share == pytest.approx((8 + 18 + 8 + 20) / 70)


@pytest.fixture(scope="module")
def tiny_traced():
    """One traced run of the SNN batch cell and one of the stream at a tiny
    size, on the CPU, with the program's recorder over the slice."""
    m = harness.load_manifest(ROOT / "BENCHMARK.json")
    out = {}
    for cell, tiny in [
            ("snn_mnist10k_packable",
             {"batch": 4, "sample_calls": 1, "profile_calls": 2}),
            ("snn_stream_b2000_c64",
             {"batch": 4, "chunk_ticks": 4, "check_chunks": 6,
              "profile_chunks": [2, 5]})]:
        _, cfg, tr = harness.resolve_cell(m, cell)
        tr.update(tiny)
        cfg = dict(cfg, ticks=8)
        res, lines = program_trace.traced_run(m, cell, 2 ** 33 + 7, 0.0,
                                              True, device="cpu", cfg=cfg,
                                              traffic=tr)
        out[cell] = (res, lines, cfg, tr)
    return out


def test_traced_run_prints_the_program_metrics(tiny_traced):
    for cell, (res, lines, cfg, tr) in tiny_traced.items():
        assert res["correct"], lines
        assert set(NAMES) <= set(res["metrics"]), cell
        c = res["counters"]
        assert c["runner.builds"] == 0 and c["kernels.loaded"] == 0
        # the records of the slice, to the byte: the output layer's spikes
        # fp32 a tick (a batch call also every layer's, 128 + 10 wide), the
        # per-tick energy, latency and events (int32) of two layers, the
        # spike counts; a batch call also fetches its flush
        b = tr["batch"]
        if cell == "snn_stream_b2000_c64":
            units, ticks, flush, width = 3, tr["chunk_ticks"], 0, 10
        else:
            units, ticks, flush = tr["profile_calls"], cfg["ticks"], 2 * 4
            width = 128 + 10 + 10
        per = ticks * (b * width * 4 + 3 * 2 * 4) + b * 10 * 4
        assert c["records.bytes"] == units * (per + flush)
        assert res["metrics"]["record_bytes_per_tick"]["value"] == \
            pytest.approx(c["records.bytes"] / 1e6 / (units * ticks))


def test_traced_run_names_its_gaps(tiny_traced):
    """The clock fit pairs the bench spans, and the gaps (on the CPU, the
    whole slice: no device operation) are named by a bench span and, where
    one covers the gap's middle, a program span."""
    for cell, (res, _, _, _) in tiny_traced.items():
        assert res["span_clock_error_us"] >= 0, cell
        assert 0.0 < res["idle_named_share"] <= 1.0
        for name, *_ in res["idle_gaps"]:
            bench, _, prog = name.partition("/")
            assert bench in ("host:dispatch", "host:result", "host:next",
                             "host:harness")
            assert prog in ("", *SPAN_NAMES), name


def test_program_spans_nest_in_bench_spans_on_a_cpu_profile():
    import torch
    from lasana_bench import profiling
    from repro_torch import lasana
    from repro_torch.analysis import jaxpr_audit
    from repro_torch.core import network
    rng = np.random.default_rng(0)
    spec = network.snn_spec(
        [rng.uniform(-1, 1, (6, 5)).astype(np.float32),
         rng.uniform(-1, 1, (5, 3)).astype(np.float32)],
        [np.asarray([0.58, 0.5, 0.5, 0.5], np.float32)] * 2)
    sur = jaxpr_audit.synthetic_surrogate("lif", device="cpu")
    x = torch.as_tensor((rng.random((4, 2, 6)) < 0.5) * 1.5,
                        dtype=torch.float32)
    eng = lasana.engine(spec, device="cpu")
    eng.dispatch(x, surrogates=sur).result()
    spans = harness.Spans()
    sl = program_trace.RecordingSlice(torch)
    spans.profiled = True
    sl.start()
    for _ in range(3):
        with spans("dispatch"):
            pend = eng.dispatch(x, surrogates=sur)
        with spans("result"):
            pend.result()
    sl.stop()
    spans.profiled = False
    window, profiled = program_trace.bench_events(sl.prof)
    off, err = program_trace.fit_clock(profiled, spans.spans, sl.perf)
    assert err is not None
    # the median fit: each top-level program span, mapped, lies inside the
    # bench span the harness wrapped around it, within 200 us
    top = [s for s in sl.program.spans if s.parent is None]
    want = {"engine.dispatch": "dispatch", "run.result": "result"}
    assert sorted(s.name for s in top) == sorted(list(want) * 3)
    for s in top:
        a, b = s.start_ns / 1e3 + off, s.end_ns / 1e3 + off
        host = [p for p in profiled if p[0] == want[s.name]
                and p[1] - 200 <= a and b <= p[2] + 200]
        assert len(host) == 1, s
    gaps, share = program_trace.name_gaps(
        window, [(o[2] * 1e6, o[3] * 1e6) for o in sl.reduce().ops],
        profiled, [(s.name, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off)
                   for s in sl.program.spans])
    assert share > 0.0
    assert all(g[0].partition("/")[2] in ("", *SPAN_NAMES) for g in gaps)
    assert isinstance(sl, profiling.Slice)


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """At a commit whose program has no ``repro_torch.trace`` the slice
    records nothing, adds no extras and every reader finds nothing."""
    import sys
    import torch
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    sl = program_trace.RecordingSlice(torch)
    sl.start()
    torch.ones(3).sum()
    sl.stop()
    assert sl.program is None
    assert program_trace.program_extras(sl, sl.reduce(), []) == {}
    ctx = types.SimpleNamespace(program=sl.program, slice_ticks=1)
    assert [harness.reader(n)(ctx) for n in NAMES] == [None] * 4
