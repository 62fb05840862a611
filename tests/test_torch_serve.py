"""Port parity: continuous-batching serving, the engine side
(``repro_torch.serve`` and ``NetworkEngine.slot_programs`` vs ``repro``).

The raw slot runners (join, step, flush) follow the reference's on the
same inputs; the port's ``Lane`` serves tests/test_serve.py's join/leave
mix, the mixed recurrent graph, annotation mode and a behavioral lane,
and every request's merged record equals both its solo run in the port
and the same request served by the reference's ``Lane``. Two surrogate
versions share one slot step. The engine's cache bound
(``REPRO_ENGINE_CACHE``) and its build counter follow the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import (assert_close,  # noqa: E402,F401
                                 assert_request_parity, surrogate_pairs)

WIDTH = 4
# LASANA states are M_V head outputs fed back tick after tick; where they
# cancel to near zero they differ between XLA-CPU and torch-CPU (1-ULP
# exp / tanh) by ~1e-6 of the field's scale — the port's own stream
# carries differ from the reference's stream by as much — so carries
# compare at rtol 1e-5 with an atol at 1e-5 of the field's scale, as
# tests/test_torch_layer.py's HEAD_ATOL
HEAD_ATOL = 1e-5


def _engines(desc, kw, record_hidden=False):
    from repro.core.network import NetworkEngine as JaxEngine
    from repro_torch.core.network import NetworkEngine
    jspec, tspec = fx.jax_graph_spec(desc), fx.port_graph_spec(desc)
    return (JaxEngine(jspec, record_hidden=record_hidden, **kw),
            NetworkEngine(tspec, record_hidden=record_hidden, device="cpu",
                          **kw))


def _lanes(desc, kw, surs, width=WIDTH, record_hidden=False):
    """(reference Lane, port Lane) over fresh engines of ``desc``."""
    from repro.serve.buckets import Bucket as JaxBucket
    from repro.serve.metrics import ServerMetrics as JaxMetrics
    from repro.serve.scheduler import Lane as JaxLane
    from repro_torch.serve import Bucket, Lane, ServerMetrics
    jeng, teng = _engines(desc, kw, record_hidden)
    jsur, tsur = surs
    jlane = JaxLane(jeng, jeng.spec, JaxBucket("k", width, fx.SERVE_CHUNK),
                    jsur, metrics=JaxMetrics())
    tlane = Lane(teng, teng.spec, Bucket("k", width, fx.SERVE_CHUNK), tsur,
                 metrics=ServerMetrics())
    return jlane, tlane


def _serve_both(desc, kw, surs, stims, record_hidden=False):
    """Serve ``stims`` on both packages' lanes; every port request is held
    to its solo run in the port and to the reference's served record."""
    from repro.serve.scheduler import RequestHandle as JaxHandle
    from repro_torch.serve import RequestHandle
    jlane, tlane = _lanes(desc, kw, surs, record_hidden=record_hidden)
    jh = fx.drive_lane(jlane, JaxHandle, stims)
    th = fx.drive_lane(tlane, RequestHandle, stims)
    eng = tlane.engine
    # crossbar codes differ from the jitted reference's by ~1 ULP (it
    # multiplies by a reciprocal where the port divides; ADC codes agree),
    # so a crossbar layer's hidden trace is held to the reference at rtol
    # 1e-5 and to the port's solo run bit for bit
    xbar = [i for i, c in enumerate(eng.spec.circuits) if c == "crossbar"]
    for x, j, t in zip(stims, jh, th):
        got, want = t.result(), j.result()
        assert len(t.chunks()) == -(-x.shape[0] // fx.SERVE_CHUNK)
        assert_request_parity(eng.run(x, surrogates=surs[1]), got,
                              hidden=record_hidden)
        assert_request_parity(want, got, hidden=record_hidden and not xbar)
        if record_hidden and xbar:
            for i, (a, b) in enumerate(zip(want.layer_spikes,
                                           got.layer_spikes)):
                if i in xbar:
                    assert_close(b, np.asarray(a), f"layer_spikes[{i}]")
                else:
                    np.testing.assert_array_equal(b, np.asarray(a))
    return jlane, tlane, th


# --- the raw slot runners against the reference's -----------------------------

def _leaves(carries):
    return [np.asarray(a) for c in carries for a in c]


@pytest.mark.parametrize("layers", [2, 1])
def test_slot_runner_sequence_matches_reference(surrogate_pairs, layers):
    """join {0, 1} at g0 = 0, step, join {2} at g0 = 8 with mixed end
    ticks, step, flush: discrete records equal, energy / latency /
    carries / flush within rtol 1e-5. Dead slots get nonzero stimulus:
    the live mask must freeze them (one layer: the chunk kernel's path
    with the mask folded into its events)."""
    jsur, tsur = surrogate_pairs["packable"]
    jeng, teng = _engines(fx.small_net_desc(n_layers=layers),
                          dict(fused_kernel=True), record_hidden=True)
    b, tc = WIDTH, fx.SERVE_CHUNK
    jp, tp = jeng.slot_programs(b, tc, jsur), teng.slot_programs(b, tc, tsur)
    jbanks = jeng._donatable_banks(jeng._runtime_banks(jsur))
    tbanks = teng._runtime_banks(tsur)
    jc = [jeng._init_carry(i, b) for i in range(layers)]
    tcar = [teng._init_carry(i, b) for i in range(layers)]
    n_out = [l.n_out for l in teng.spec.layers]
    jprev = [jnp.zeros((b, n), jnp.float32) for n in n_out]
    tprev = [torch.zeros((b, n)) for n in n_out]
    x = fx.serve_stimuli([(2 * tc, b)], seed=5, rate=0.3)[0]
    for g, joiners, end_ks in ((0, [0, 1], [12, 6, 0, 0]),
                               (8, [2], [12, 6, 20, 0])):
        mask = np.zeros(b, bool)
        mask[joiners] = True
        end_ks = np.asarray(end_ks, np.float32)
        jc, jprev = jp.join(jc, jprev, jnp.asarray(mask), jnp.float32(g))
        tcar, tprev = tp.join(tcar, tprev, torch.as_tensor(mask),
                              torch.tensor(float(g)))
        xk = x[g:g + tc]
        jo = jp.step(jnp.asarray(xk), jnp.float32(g), jnp.asarray(end_ks),
                     jc, jprev, jbanks)
        to = tp.step(torch.as_tensor(xk), float(g), torch.as_tensor(end_ks),
                     tcar, tprev, tbanks)
        for name, j, t in (("primary", jo[0], to[0]), ("out_seq", jo[1], to[1]),
                           ("events", jo[5], to[5])):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
        for i, (j, t) in enumerate(zip(jo[2], to[2])):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"hidden[{i}]")
        assert to[3].shape == (tc, layers, b) and to[5].dtype == torch.int32
        assert_close(to[3].numpy(), np.asarray(jo[3]), "energy")
        assert_close(to[4].numpy(), np.asarray(jo[4]), "latency")
        jc, jprev, jbanks = jo[6], jo[7], jo[8]
        tcar, tprev = to[6], to[7]
        for i, (j, t) in enumerate(zip(_leaves(jc), _leaves(tcar))):
            assert_close(t, j, f"carry leaf {i}", atol_scale=HEAD_ATOL)
        # slot 3 never joined: it holds no event, energy or spike
        assert not to[5][:, :, 3].any() and not to[3][:, :, 3].any()
        assert not to[1][:, 3].any()
    clocks = [c.clock_ns for c in teng.circs]
    t_ends = np.asarray([[np.float32(12 * c), np.float32(6 * c), 0, 0]
                         for c in clocks], np.float32)
    jf = np.asarray(jp.flush(jc, jnp.asarray(t_ends), jbanks))
    tf = tp.flush(tcar, torch.as_tensor(t_ends), tbanks).numpy()
    assert tf.shape == (layers, b) and not tf[:, 2:].any()
    assert_close(tf, jf, "flush")


@pytest.mark.parametrize("backend,chunk", [("golden", 8), ("lasana", 0),
                                           ("lasana", -3)])
def test_slot_programs_refusals_match_reference(surrogate_pairs, backend,
                                                chunk):
    jsur, tsur = surrogate_pairs["packable"]
    jeng, teng = _engines(fx.small_net_desc(), dict(backend=backend))
    surs = (None, None) if backend == "golden" else (jsur, tsur)
    with pytest.raises(ValueError) as want:
        jeng.slot_programs(WIDTH, chunk, surs[0])
    with pytest.raises(ValueError) as got:
        teng.slot_programs(WIDTH, chunk, surs[1])
    assert str(got.value) == str(want.value)
    assert teng.compile_count == 0


# --- lanes: each request against its solo run and the reference's lane ------

def test_join_leave_mix_matches_reference_lane_and_solo(surrogate_pairs):
    """tests/test_serve.py's 7 requests of heterogeneous length and batch
    on 4 slots: later requests join mid-stream as earlier ones leave."""
    stims = fx.serve_stimuli(fx.SERVE_JOBS, seed=1)
    jlane, tlane, _ = _serve_both(fx.small_net_desc(),
                                  dict(fused_kernel=True),
                                  surrogate_pairs["packable"], stims)
    assert tlane.g == jlane.g and tlane.free == list(range(WIDTH))
    snap = tlane.metrics.snapshot()
    assert snap["requests_completed"] == len(stims)
    assert snap["batch_occupancy"] > 0.3          # slots actually shared


@pytest.mark.parametrize("case", ["mixed", "annotation", "behavioral",
                                  "unpackable", "one_layer"])
def test_other_lanes_match_reference_lane_and_solo(surrogate_pairs, case):
    """The mixed crossbar -> LIF graph with its recurrent edge (a
    {crossbar, lif} library), annotation mode, a behavioral lane (whose
    handles are flagged ``degraded``), an unpackable surrogate (the
    stacked heads) and a one-LIF-layer graph (the chunk kernel's path),
    with hidden traces."""
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro.core.surrogate import SurrogateLibrary as JaxLibrary
    from repro_torch.core.surrogate import Surrogate, SurrogateLibrary
    surs = surrogate_pairs["packable"]
    desc = fx.small_net_desc()
    stims = fx.serve_stimuli([(13, 2), (20, 1), (6, 1)], seed=4)
    kw = dict(fused_kernel=True)
    if case == "mixed":
        desc, stims = fx.mixed_serve_net()
        jx = JaxSurrogate.load(str(fx.XBAR_PACKABLE))
        tx = Surrogate.load(str(fx.XBAR_PACKABLE), device="cpu")
        surs = (JaxLibrary({"crossbar": jx, "lif": surs[0]}),
                SurrogateLibrary({"crossbar": tx, "lif": surs[1]}))
    elif case == "annotation":
        kw = dict(mode="annotation")
    elif case == "behavioral":
        kw, surs = dict(backend="behavioral"), (None, None)
    elif case == "unpackable":
        surs = surrogate_pairs["unpackable"]
    elif case == "one_layer":
        desc = fx.small_net_desc(n_layers=1)
    _, tlane, handles = _serve_both(desc, kw, surs, stims,
                                    record_hidden=True)
    assert all(h.degraded == (case == "behavioral") for h in handles)
    assert tlane.metrics.snapshot()["requests_degraded"] == (
        len(stims) if case == "behavioral" else 0)


def test_two_versions_share_one_slot_step(surrogate_pairs):
    """Two same-structure surrogates serve from two lanes of one engine
    through ONE slot step (``compile_count == 1``; join and flush count
    nothing), each request equal to its solo run with its own version."""
    from repro_torch.core.network import NetworkEngine
    from repro_torch.serve import Bucket, Lane, RequestHandle
    sur = surrogate_pairs["packable"][1]
    swap = fx.scaled_surrogate(sur, 1.05)
    spec = fx.port_graph_spec(fx.small_net_desc(seed=7))
    eng = NetworkEngine(spec, record_hidden=False, device="cpu")
    bucket = Bucket("k", WIDTH, fx.SERVE_CHUNK)
    lanes = [Lane(eng, spec, bucket, s) for s in (sur, swap)]
    assert eng.compile_count == 1 and lanes[1].programs.compile_seconds == 0
    stims = fx.serve_stimuli([(16, 1), (11, 2)], seed=2)
    served = [fx.drive_lane(lane, RequestHandle, stims) for lane in lanes]
    assert eng.compile_count == 1
    for s, handles in zip((sur, swap), served):
        for x, h in zip(stims, handles):
            assert_request_parity(eng.run(x, surrogates=s), h.result())
    assert (served[0][0].result().energy.sum()
            != served[1][0].result().energy.sum())


# --- the repairs: the engine cache bound and the build counter ---------------

@pytest.mark.parametrize("env", ["2", "", None])
def test_engine_cache_capacity_follows_reference(monkeypatch, env):
    """Three engine variants of one spec under ``REPRO_ENGINE_CACHE``: the
    port keeps what the reference keeps (2 under "2"; the module
    constant, 8, when unset or empty)."""
    import repro.kernels.ops as jax_ops
    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    from repro_torch.kernels import ops
    if env is None:
        monkeypatch.delenv("REPRO_ENGINE_CACHE", raising=False)
    else:
        monkeypatch.setenv("REPRO_ENGINE_CACHE", env)
    assert ops.engine_cache_capacity(8) == jax_ops.engine_cache_capacity(8)
    desc = fx.small_net_desc()
    jspec, tspec = fx.jax_graph_spec(desc), fx.port_graph_spec(desc)
    for kw in ({}, dict(record_hidden=False), dict(mode="annotation")):
        jax_lasana.engine(jspec, **kw)
        lasana.engine(tspec, device="cpu", **kw)
    want = len(getattr(jspec, "_lasana_engine_cache"))
    assert len(getattr(tspec, "_lasana_engine_cache")) == want
    assert want == (2 if env == "2" else 3)


def test_compile_count_counts_tick_loops_only(surrogate_pairs):
    """A 20-tick stream in chunks of 8 builds two chunk runners and a
    flush: the count is 2, as the reference's; a monolithic run adds 1."""
    jsur, tsur = surrogate_pairs["packable"]
    jeng, teng = _engines(fx.small_net_desc(), dict(fused_kernel=True))
    x = fx.small_net(t_steps=20, batch=2)[2]
    jeng.run_stream(jnp.asarray(x), chunk_ticks=8, surrogates=jsur)
    teng.run_stream(x, chunk_ticks=8, surrogates=tsur)
    assert teng.compile_count == jeng.compile_count == 2
    jeng.run(jnp.asarray(x), surrogates=jsur)
    teng.run(x, surrogates=tsur)
    assert teng.compile_count == jeng.compile_count == 3
