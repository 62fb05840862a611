"""Port parity: streaming (``repro_torch`` vs ``repro``).

Inside the port, a stream of any chunk size (1, 7 and 23 ticks here)
equals the monolithic run bit for bit, for every backend and lasana path
on the LIF, crossbar and mixed recurrent graphs; the one-LIF-layer graphs
take the time-looped chunk kernels (``network_tick_chunk``, ``lif_chunk``)
and equal the per-tick path bit for bit. Against the reference's stream,
discrete records are identical and continuous ones agree to rtol 1e-5.
The chunking, the record accumulator and the kernels' plain versions are
held against the reference's own functions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import (assert_close, assert_runs_match,  # noqa: E402,F401
                                 surrogate_pairs, tick_inputs)

T_STEPS = 23
CHUNKS = (1, 7, 23)
RECORD = ("outputs", "out_spikes", "energy", "latency", "events",
          "flush_energy")


def assert_identical(got, want):
    """Every record field equal bit for bit."""
    for f in RECORD:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f)
    if want.layer_spikes is not None:
        for i, (g, w) in enumerate(zip(got.layer_spikes, want.layer_spikes)):
            np.testing.assert_array_equal(g, w, err_msg=f"layer_spikes[{i}]")


# --- workloads: numpy descriptions shared by both packages --------------------

def _lif_net(t_steps=T_STEPS):
    """``small_net`` (12-8-4 LIF) with three idle trailing ticks, so the
    end-of-run flush charges energy."""
    ws, knobs, x = fx.small_net(t_steps=t_steps)
    x[-3:] = 0.0
    return {"layers": [{"circuit": "lif", "weight": w, "params": p}
                       for w, p in zip(ws, knobs)], "edges": []}, x


def _one_layer(t_steps=T_STEPS, edge=False):
    """One 12 -> 8 LIF layer (the chunk kernels' graph); ``edge`` adds a
    zero recurrent edge, which changes no number but makes the graph take
    the per-tick path."""
    desc, x = _lif_net(t_steps)
    desc = {"layers": desc["layers"][:1], "edges": []}
    if edge:
        desc["edges"] = [(0, 0, np.zeros((8, 8), np.float32))]
    return desc, x


def _xbar_mlp(t_steps=T_STEPS):
    rng = np.random.default_rng(12)
    ws = [rng.integers(-1, 2, (70, 12)), rng.integers(-1, 2, (12, 4))]
    x = rng.uniform(-0.8, 0.8, (t_steps, 2, 70)).astype(np.float32)
    x[:, :, 40:] *= rng.random((t_steps, 2, 1)) < 0.5   # dead input lines
    return {"layers": [{"circuit": "crossbar", "weight": w} for w in ws],
            "edges": []}, x


def _mixed_net(t_steps=T_STEPS):
    """A 20-8 crossbar front end feeding a 6-neuron LIF bank with lateral
    inhibition (a one-tick-delayed edge)."""
    rng = np.random.default_rng(3)
    xw = rng.integers(-1, 2, (20, 8)).astype(np.float32)
    lw = (rng.normal(0, 0.5, (8, 6)) * 2.2).astype(np.float32)
    inhib = (-0.6 * (1 - np.eye(6))).astype(np.float32)
    x = (rng.integers(-1, 2, (t_steps, 3, 20)) * 0.8).astype(np.float32)
    return {"layers": [{"circuit": "crossbar", "weight": xw},
                       {"circuit": "lif", "weight": lw,
                        "params": np.asarray(fx.LIF_KNOBS, np.float32)}],
            "edges": [(1, 1, inhib)]}, x


WORKLOADS = {"lif": _lif_net, "one_layer": _one_layer, "xbar": _xbar_mlp,
             "mixed": _mixed_net}


def _jax_spec(desc):
    from repro.core.network import (crossbar_layer, graph_spec, lif_layer,
                                    recurrent_edge)
    layers = [crossbar_layer(jnp.asarray(d["weight"], jnp.float32))
              if d["circuit"] == "crossbar" else
              lif_layer(jnp.asarray(d["weight"]), jnp.asarray(d["params"]))
              for d in desc["layers"]]
    return graph_spec(layers, edges=[recurrent_edge(s, d, w)
                                     for s, d, w in desc["edges"]])


def _port_spec(desc):
    from repro_torch.convert import graph_spec_from_numpy
    return graph_spec_from_numpy(desc["layers"], desc["edges"])


@pytest.fixture(scope="module")
def banks(surrogate_pairs):
    """name -> (JAX surrogates, port surrogates) for every path below."""
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro.core.surrogate import SurrogateLibrary as JaxLibrary
    from repro_torch.core.surrogate import Surrogate, SurrogateLibrary
    jx = JaxSurrogate.load(str(fx.XBAR_PACKABLE))
    tx = Surrogate.load(str(fx.XBAR_PACKABLE), device="cpu")
    jl, tl = surrogate_pairs["packable"]
    return {"packable": (jl, tl),
            "unpackable": surrogate_pairs["unpackable"],
            "crossbar": (jx, tx),
            "library": (JaxLibrary({"crossbar": jx, "lif": jl}),
                        SurrogateLibrary({"crossbar": tx, "lif": tl}))}


# (workload, path) -> (surrogates or None, engine keywords)
PATHS = {
    ("lif", "golden"): (None, dict(backend="golden")),
    ("lif", "behavioral"): (None, dict(backend="behavioral")),
    ("lif", "megakernel"): ("packable", dict(fused_kernel=True)),
    ("lif", "fused"): ("packable", dict(fused_kernel=False)),
    ("lif", "percall"): ("packable", dict(fused=False)),
    ("lif", "annotation"): ("packable", dict(mode="annotation")),
    ("lif", "unpackable"): ("unpackable", dict(fused_kernel=True)),
    ("one_layer", "golden"): (None, dict(backend="golden")),
    ("one_layer", "megakernel"): ("packable", dict(fused_kernel=True)),
    ("xbar", "golden"): (None, dict(backend="golden")),
    ("xbar", "behavioral"): (None, dict(backend="behavioral")),
    ("xbar", "megakernel"): ("crossbar", dict(fused_kernel=True)),
    ("mixed", "golden"): (None, dict(backend="golden")),
    ("mixed", "behavioral"): (None, dict(backend="behavioral")),
    ("mixed", "megakernel"): ("library", dict(fused_kernel=True)),
    ("mixed", "annotation"): ("library", dict(mode="annotation")),
}


def _engines(workload, path, banks, record_hidden=True):
    """(JAX engine, port engine, (JAX, port) surrogates, stimulus)."""
    from repro.core.network import NetworkEngine as JaxEngine
    from repro_torch.core.network import NetworkEngine
    desc, x = WORKLOADS[workload]()
    which, kw = PATHS[(workload, path)]
    surs = banks[which] if which is not None else (None, None)
    jeng = JaxEngine(_jax_spec(desc), record_hidden=record_hidden, **kw)
    teng = NetworkEngine(_port_spec(desc), record_hidden=record_hidden,
                         device="cpu", **kw)
    return jeng, teng, surs, x


# --- stream == monolithic inside the port --------------------------------------

@pytest.mark.parametrize("workload,path", list(PATHS))
def test_stream_equals_monolithic_bitwise(banks, workload, path):
    """Chunk sizes 1, 7 and 23 (a divisor, neither, and the whole run):
    every record field bit for bit, the flush charged once."""
    _, eng, (_, sur), x = _engines(workload, path, banks)
    mono = eng.run(x, surrogates=sur)
    for chunk in CHUNKS:
        assert_identical(eng.run_stream(x, chunk_ticks=chunk,
                                        surrogates=sur), mono)
    if workload == "lif" and path == "megakernel":
        assert mono.flush_energy.sum() > 0


def test_iterator_stimulus_rebuffered(banks):
    """Blocks of 5 ticks re-buffered to chunks of 7 (a short last one)."""
    _, eng, (_, sur), x = _engines("lif", "megakernel", banks)
    mono = eng.run(x, surrogates=sur)
    blocks = (x[a:a + 5] for a in range(0, len(x), 5))
    chunks = list(eng.stream(blocks, chunk_ticks=7, surrogates=sur))
    assert [c.energy.shape[0] for c in chunks] == [7, 7, 7, 2]
    assert all(c.flush_energy.sum() == 0 for c in chunks[:-1])
    from repro_torch.core.network import NetworkRun
    assert_identical(NetworkRun.merge(chunks), mono)


# --- stream against the reference's stream -------------------------------------

@pytest.mark.parametrize("workload,path", [
    ("lif", "megakernel"), ("lif", "golden"), ("lif", "annotation"),
    ("one_layer", "megakernel"), ("one_layer", "golden"),
    ("mixed", "megakernel")])
def test_stream_matches_reference_stream(banks, workload, path):
    jeng, teng, (jsur, tsur), x = _engines(workload, path, banks)
    want = jeng.run_stream(jnp.asarray(x), chunk_ticks=7, surrogates=jsur)
    got = teng.run_stream(x, chunk_ticks=7, surrogates=tsur)
    if workload == "mixed":        # crossbar outputs feed an LIF layer
        for f in ("events", "outputs", "out_spikes"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))
        for f in ("energy", "latency", "flush_energy"):
            assert_close(getattr(got, f), np.asarray(getattr(want, f)), f)
    else:
        assert_runs_match(got, want)
    if (workload, path) == ("lif", "megakernel"):
        assert want.flush_energy.sum() > 0          # the flush is exercised


def test_hot_swap_iterator_matches_reference(banks):
    """A surrogate iterator swaps the weights per chunk (None holds the
    last): the port follows the reference, builds nothing for the swap,
    and leaves the caller's surrogates unchanged."""
    jeng, teng, (jsur, tsur), x = _engines("lif", "megakernel", banks)
    jb = fx.scaled_surrogate(jsur, 1.05, jax_side=True)
    tb = fx.scaled_surrogate(tsur, 1.05)
    before = {p: {k: a.clone() for k, a in d.items()}
              for p, d in tsur.params.items()}
    want = jeng.run_stream(jnp.asarray(x), chunk_ticks=7,
                           surrogates=iter([jsur, jb, None, jsur]))
    plain = teng.run_stream(x, chunk_ticks=7, surrogates=tsur)
    builds = teng.compile_count
    got = teng.run_stream(x, chunk_ticks=7,
                          surrogates=iter([tsur, tb, None, tsur]))
    assert teng.compile_count == builds
    assert_runs_match(got, want)
    assert not np.array_equal(got.energy, plain.energy)
    for p, d in tsur.params.items():
        for k, a in d.items():
            assert torch.equal(a, before[p][k])


# --- chunking and the record accumulator against the reference ---------------

def _chunks_of(fn, *args, **kw):
    return [np.asarray(c) for c in fn(*args, **kw)]


@pytest.mark.parametrize("case", [
    "array", "array_whole", "array_skip", "blocks", "blocks_skip",
    "blocks_unbuffered", "blocks_2d"])
def test_iter_chunks_matches_reference(case):
    from repro.core.network import _iter_chunks as ref_chunks
    from repro_torch.core.network import _iter_chunks
    x = np.arange(11 * 2 * 3, dtype=np.float32).reshape(11, 2, 3)
    blocks = lambda: iter([x[:4], x[4:5], x[5:11]])
    args = {"array": (x, 3), "array_whole": (x, None),
            "array_skip": (x, 4, 5), "blocks": (blocks, 3),
            "blocks_skip": (blocks, 3, 6), "blocks_unbuffered": (blocks, None),
            "blocks_2d": (lambda: iter([x[0], x[1], x[2]]), 2)}[case]
    stim, rest = args[0], args[1:]
    want = _chunks_of(ref_chunks, stim() if callable(stim) else stim,
                      rest[0], 3, *rest[1:])
    got = _chunks_of(_iter_chunks, stim() if callable(stim) else stim,
                     rest[0], 3, *rest[1:])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a torch tensor slices like the array
    if case.startswith("array"):
        got_t = _chunks_of(_iter_chunks, torch.as_tensor(x), rest[0], 3,
                           *rest[1:])
        for g, w in zip(got_t, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bad", ["chunk_zero", "width", "ndim"])
def test_iter_chunks_errors_match_reference(bad):
    from repro.core.network import _iter_chunks as ref_chunks
    from repro_torch.core.network import _iter_chunks
    x = np.zeros((4, 2, 3), np.float32)
    stim, chunk, fan_in = {"chunk_zero": (x, 0, 3), "width": (x, 2, 5),
                           "ndim": (iter([x[None]]), 2, 3)}[bad]
    with pytest.raises(ValueError) as want:
        list(ref_chunks(stim, chunk, fan_in))
    if bad == "ndim":
        stim = iter([x[None]])
    with pytest.raises(ValueError) as got:
        list(_iter_chunks(stim, chunk, fan_in))
    assert str(got.value) == str(want.value)


def _ref_run(run):
    """The same record as a reference NetworkRun."""
    from repro.core.network import NetworkRun as JaxRun
    return JaxRun(**{f: getattr(run, f) for f in (
        "backend", "mode", "outputs", "out_spikes", "layer_spikes", "energy",
        "latency", "events", "flush_energy", "n_circuits", "clock_ns",
        "wall_seconds", "circuits", "compile_seconds")})


@pytest.mark.parametrize("workload", ["lif", "xbar"])
def test_streaming_run_merge_and_report_match_reference(banks, workload):
    """The same chunk records through both accumulators: the merged
    records and their reports agree, and the live totals track them."""
    from repro.core.network import NetworkRun as JaxRun
    from repro.core.network import StreamingRun as JaxAcc
    from repro_torch.core.network import NetworkRun, StreamingRun
    path = "megakernel"
    _, eng, (_, sur), x = _engines(workload, path, banks)
    chunks = list(eng.stream(x, chunk_ticks=7, surrogates=sur))
    acc, jacc = StreamingRun(), JaxAcc()
    for c in chunks:
        acc.update(c)
        jacc.update(_ref_run(c))
        assert (acc.ticks, acc.events) == (jacc.ticks, jacc.events)
        assert acc.energy_j == jacc.energy_j
    got, want = acc.result(), jacc.result()
    assert_identical(got, want)
    assert_identical(NetworkRun.merge(chunks),
                     JaxRun.merge([_ref_run(c) for c in chunks]))
    rg, rw = got.report(), want.report()
    assert rg == rw


def test_merge_rejects_mismatched_chunks(banks):
    from repro_torch.core.network import NetworkRun, StreamingRun
    _, eng, (_, sur), x = _engines("lif", "megakernel", banks)
    _, geng, _, _ = _engines("lif", "golden", banks)
    a = list(eng.stream(x, chunk_ticks=12, surrogates=sur))
    b = list(geng.stream(x, chunk_ticks=12))
    with pytest.raises(ValueError, match="different runs"):
        NetworkRun.merge([a[0], b[1]])
    with pytest.raises(ValueError, match="before any update"):
        StreamingRun().result()


def _old_merge(chunks):
    """``NetworkRun.merge`` as the port had it before it went through
    :class:`StreamingRun`: the oracle that the repair changed nothing."""
    from repro_torch.core.network import NetworkRun
    first = chunks[0]
    cat = lambda f: np.concatenate([getattr(c, f) for c in chunks])
    hidden = None
    if first.layer_spikes is not None:
        hidden = [np.concatenate([c.layer_spikes[i] for c in chunks])
                  for i in range(len(first.layer_spikes))]
    if first.circuits and first.circuits[-1] != "lif":
        outputs, out_spikes = chunks[-1].outputs, None
    else:
        outputs = sum(np.asarray(c.outputs, np.int64) for c in chunks
                      ).astype(first.outputs.dtype)
        out_spikes = cat("out_spikes")
    return NetworkRun(
        backend=first.backend, mode=first.mode, outputs=outputs,
        out_spikes=out_spikes, layer_spikes=hidden, energy=cat("energy"),
        latency=cat("latency"), events=cat("events"),
        flush_energy=sum(c.flush_energy for c in chunks),
        n_circuits=first.n_circuits, clock_ns=first.clock_ns,
        wall_seconds=sum(c.wall_seconds for c in chunks),
        circuits=first.circuits,
        compile_seconds=sum(c.compile_seconds for c in chunks))


@pytest.mark.parametrize("backend", ["golden", "lasana"])
def test_merge_unchanged_on_chip_workload_records(surrogate_pairs, backend):
    """The chip-smoke SNN (first 4 digits, 20 ticks) streamed in chunks of
    6: the StreamingRun-based merge equals the earlier merge field for
    field, and both equal the monolithic run."""
    import repro_torch.lasana as lasana
    from repro_torch.convert import spec_from_numpy
    from repro_torch.core.network import NetworkRun
    ws, knobs = fx.snn_weights()
    x, _ = fx.chip_workload(n_images=4, t_steps=20)
    spec = spec_from_numpy(ws, knobs)
    kw = ({"backend": "golden"} if backend == "golden"
          else {"surrogates": surrogate_pairs["packable"][1]})
    chunks = list(lasana.stream(spec, x, chunk_ticks=6, record_hidden=True,
                                device="cpu", **kw))
    new, old = NetworkRun.merge(chunks), _old_merge(chunks)
    assert_identical(new, old)
    for f in ("n_circuits", "clock_ns", "circuits", "wall_seconds",
              "compile_seconds", "backend", "mode"):
        assert np.all(getattr(new, f) == getattr(old, f)), f
    assert_identical(new, lasana.simulate(spec, x, device="cpu", **kw))


# --- the time-looped chunk paths ---------------------------------------------

def test_chunk_eligible_truth_table_matches_reference():
    from repro.core.network import NetworkEngine as JaxEngine
    from repro_torch.core.network import NetworkEngine
    specs = {"one_lif": _one_layer()[0], "lif_edge": _one_layer(edge=True)[0],
             "two_lif": _lif_net()[0],
             "xbar": {"layers": _xbar_mlp()[0]["layers"][:1], "edges": []},
             "mixed": _mixed_net()[0]}
    rows = []
    for name, desc in specs.items():
        for backend in ("golden", "behavioral", "lasana"):
            for mode in ("standalone", "annotation"):
                for fused in (True, False):
                    kw = dict(backend=backend, mode=mode, fused=fused)
                    j = JaxEngine(_jax_spec(desc), **kw)._chunk_eligible()
                    t = NetworkEngine(_port_spec(desc), device="cpu",
                                      **kw)._chunk_eligible()
                    assert t == j, (name, kw)
                    rows.append((name, backend, mode, fused, t))
    assert [r[:4] for r in rows if r[4]] == [
        ("one_lif", "lasana", "standalone", True)]


@pytest.mark.parametrize("path", ["megakernel", "golden"])
def test_chunk_kernel_path_equals_per_tick_path(banks, path):
    """The one-layer graph through its chunk kernel vs the same graph with
    a zero recurrent edge (per-tick path): bit for bit, and each launches
    only its own kernels."""
    from repro_torch.core.network import NetworkEngine
    from repro_torch.kernels import ops
    which, kw = PATHS[("one_layer", path)]
    sur = banks[which][1] if which else None
    (desc, x), (desc_e, _) = _one_layer(), _one_layer(edge=True)
    eng = NetworkEngine(_port_spec(desc), device="cpu", **kw)
    eng_e = NetworkEngine(_port_spec(desc_e), device="cpu", **kw)
    assert eng._chunk_eligible() == (path == "megakernel")
    assert eng._golden_chunk_eligible() == (path == "golden")
    assert not (eng_e._chunk_eligible() or eng_e._golden_chunk_eligible())
    ops.reset_launches()
    chunked = eng.run(x, surrogates=sur)
    counts = dict(ops.LAUNCHES)
    assert_identical(chunked, eng_e.run(x, surrogates=sur))
    # CPU tensors run the plain versions: no kernel launch is counted
    assert not any(counts.values())


def test_megakernel_chunk_plain_matches_reference(surrogate_pairs):
    """The plain chunk (a loop of the plain tick) against the reference's
    ``megakernel_chunk(pallas=False)`` (a ``lax.scan`` of
    ``megakernel_step``) over 9 ticks at ragged N."""
    from repro.core.wrapper import LasanaState as JaxState
    from repro.kernels import tick_megakernel as jmk
    from repro_torch.core.wrapper import LasanaState
    from repro_torch.kernels import tick_megakernel as mk
    jsur, tsur = surrogate_pairs["packable"]
    jpack, jlay = jmk.pack_heads(jsur)
    tpack, tlay = mk.pack_heads(tsur)
    n, t_steps = 37, 9
    v, o, t_last, params, _, _, _ = tick_inputs(n, seed=4)
    rng = np.random.default_rng(9)
    changed = rng.random((t_steps, n)) < 0.5
    x = np.stack([rng.uniform(-1, 1, (t_steps, n)),
                  np.full((t_steps, n), 1.5), np.full((t_steps, n), 5.0)],
                 -1).astype(np.float32)
    ts = ((np.arange(t_steps) + 6.0) * 5.0).astype(np.float32)
    jst, jo, je, jl = jmk.megakernel_chunk(
        jpack, "lif", JaxState(*(jnp.asarray(a) for a in (v, o, t_last,
                                                          params))),
        jnp.asarray(changed), jnp.asarray(x), jnp.asarray(ts), 5.0,
        layout=jlay, pallas=False)
    t = torch.as_tensor
    tst, to, te, tl = mk.megakernel_chunk(
        tpack, "lif", LasanaState(t(v), t(o), t(t_last), t(params)),
        t(changed), t(x), t(ts), 5.0, layout=tlay)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tst.t_last.numpy(), np.asarray(jst.t_last))
    assert_close(tst.v, np.asarray(jst.v), "v")
    assert_close(te, np.asarray(je), "e_seq")
    assert_close(tl, np.asarray(jl), "l_seq")
    # the chunk entry and T single plain ticks agree bit for bit
    st = LasanaState(t(v), t(o), t(t_last), t(params))
    for k in range(t_steps):
        st, e, l, _ = mk.megakernel_step(tpack, "lif", st, t(changed[k]),
                                         t(x[k]), t(ts[k]), 5.0,
                                         spiking=True, layout=tlay)
        assert torch.equal(e, te[k]) and torch.equal(l, tl[k])
    assert torch.equal(st.v, tst.v) and torch.equal(st.o, tst.o)


@pytest.mark.parametrize("n, t_steps", [(300, 6), (40, 125)])
def test_lif_chunk_plain_matches_chained_reference_steps(n, t_steps):
    """``lif_chunk`` (plain) against T chained reference
    ``LIFNeuron.step`` calls: spikes identical, state / energy / latency
    to rtol 1e-5; and against T chained port ``lif_step`` bit for bit.
    T = 125 is the golden simulation's (``TestbenchConfig``'s steps)."""
    import jax
    from repro.core.circuits import LIFNeuron as JaxLIF
    from repro_torch.kernels import ops
    rng = np.random.default_rng(21)
    state = np.stack([rng.uniform(0, 1.0, n), rng.uniform(0, 0.3, n),
                      rng.uniform(0, 3.0, n) * (rng.random(n) < 0.3)],
                     1).astype(np.float32)
    x = np.stack([rng.uniform(-1, 1, (t_steps, n)),
                  rng.uniform(0, 1.5, (t_steps, n)),
                  rng.integers(0, 6, (t_steps, n))], -1).astype(np.float32)
    params = rng.uniform(0.5, 0.8, (n, 4)).astype(np.float32)
    t = torch.as_tensor
    ns, obs = ops.lif_chunk(t(state), t(x), t(params))
    assert obs["spiked"].dtype == torch.bool
    assert obs["output"].shape == (t_steps, n)
    step = jax.jit(JaxLIF().step)
    js, s = jnp.asarray(state), t(state)
    for k in range(t_steps):
        js, wo = step(js, jnp.asarray(x[k]), jnp.asarray(params))
        np.testing.assert_array_equal(obs["spiked"][k].numpy(),
                                      np.asarray(wo["spiked"]))
        np.testing.assert_array_equal(obs["output"][k].numpy(),
                                      np.asarray(wo["output"]))
        assert_close(obs["energy"][k], np.asarray(wo["energy"]), "energy")
        assert_close(obs["latency"][k], np.asarray(wo["latency"]), "latency")
        s, so = ops.lif_step(s, t(x[k]), t(params))
        for f in ("output", "energy", "latency", "spiked"):
            assert torch.equal(so[f], obs[f][k]), f
    assert obs["spiked"].any() and not obs["spiked"].all()
    assert_close(ns, np.asarray(js), "state")
    assert torch.equal(ns, s)


@pytest.mark.parametrize("n, t_steps", [(300, 6), (37, 125), (5, 0)])
def test_lif_chunk_plain_records_v_of_each_period(n, t_steps):
    """``record_v=True``: ``v_seq[t]`` is ``new_state[:, 0]`` after t + 1
    chained ``_period_math`` periods, bit for bit; the other outputs are
    those of the call without it. T = 125 is ``TrainConfig``'s steps."""
    from repro_torch.core.circuits import LIFNeuron
    from repro_torch.kernels import lif_scan, ops
    rng = np.random.default_rng(n + t_steps)
    state = torch.as_tensor(np.stack([
        rng.uniform(0, 1.0, n), rng.uniform(0, 0.3, n),
        rng.uniform(0, 3.0, n) * (rng.random(n) < 0.3)], 1), dtype=torch.float32)
    x = torch.as_tensor(np.stack([
        rng.uniform(-1, 1, (t_steps, n)), rng.uniform(0, 1.5, (t_steps, n)),
        rng.integers(0, 6, (t_steps, n))], -1), dtype=torch.float32)
    params = torch.as_tensor(rng.uniform(0.5, 0.8, (n, 4)),
                             dtype=torch.float32)
    ns, obs = ops.lif_chunk(state, x, params, record_v=True)
    ns0, obs0 = ops.lif_chunk(state, x, params)
    assert "v_seq" not in obs0 and obs["v_seq"].shape == (t_steps, n)
    assert torch.equal(ns, ns0)
    for f in obs0:
        assert torch.equal(obs[f], obs0[f]), f
    s = state
    for k in range(t_steps):
        s, *_ = lif_scan._period_math(LIFNeuron(), s, x[k], params)
        assert torch.equal(obs["v_seq"][k], s[:, 0])
    if t_steps:
        assert (obs["v_seq"] > 0).any() and (obs["v_seq"] == 0).any()
    plain = lif_scan.chunk_plain(LIFNeuron(), state, x, params, True)
    assert len(plain) == 6 and torch.equal(plain[5], obs["v_seq"])


@pytest.mark.parametrize("n", [64, 300])
@pytest.mark.parametrize("f,h1,h2", [(41, 100, 50), (67, 100, 50),
                                     (16, 32, 16)])
def test_mlp_surrogate_plain_matches_reference(n, f, h1, h2):
    from repro.kernels import ref
    from repro_torch.kernels import ops
    rng = np.random.default_rng(n + f)
    arrays = [rng.normal(0, 1, (n, f))] + [
        rng.normal(0, 1, s) * 0.1 for s in ((f, h1), (h1,), (h1, h2), (h2,),
                                            (h2, 1), (1,))]
    arrays = [a.astype(np.float32) for a in arrays]
    got = ops.mlp_surrogate(*(torch.as_tensor(a) for a in arrays))
    want = np.asarray(ref.mlp_surrogate_ref(*(jnp.asarray(a)
                                              for a in arrays)))[:, 0]
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
def test_mlp_surrogate_plain_casts_bf16(dtype):
    """Rows of any dtype give the head on their fp32 values, as the
    reference casts whatever it is given (the kernel reads fp32 and bf16
    rows as they are; its wrapper casts the others first)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 1, (128, 41)).astype(np.float32))
    w = [torch.as_tensor((rng.normal(0, 1, s) * 0.1).astype(np.float32))
         for s in ((41, 100), (100,), (100, 50), (50,), (50, 1), (1,))]
    got = ops.mlp_surrogate(x.to(dtype), *w)
    assert got.dtype == torch.float32
    want = ops.mlp_surrogate(x.to(dtype).float(), *w)
    assert torch.equal(got, want)


# --- runners, argument errors and generator lifetime ---------------------------

def test_stream_builds_at_most_two_chunk_runners_and_one_flush(banks):
    _, eng, (_, sur), x = _engines("lif", "megakernel", banks,
                                   record_hidden=False)
    eng.run_stream(x, chunk_ticks=7, surrogates=sur)
    # compile_count counts the tick-loop runners only (the 7-tick and the
    # 2-tick one), as the reference's does; the flush is a runner apart
    assert eng.compile_count == 2 and len(eng._runners) == 3
    eng.run_stream(x[:21], chunk_ticks=7, surrogates=sur)
    eng.run_stream(np.concatenate([x, x]), chunk_ticks=7, surrogates=sur)
    assert eng.compile_count == 3          # + the 4-tick remainder (46 % 7)
    assert len(eng._runners) == 4


def test_stream_argument_errors_raise_at_call(banks):
    _, eng, (_, sur), x = _engines("lif", "megakernel", banks)
    with pytest.raises(ValueError, match="chunk_ticks must be positive"):
        eng.stream(x, chunk_ticks=0, surrogates=sur)
    with pytest.raises(ValueError, match="input width"):
        eng.stream(x[..., :5], chunk_ticks=4, surrogates=sur)
    with pytest.raises(ValueError, match="requires chunk_ticks"):
        eng.stream(x, surrogates=sur, checkpoint_every=1)
    with pytest.raises(ValueError, match="checkpoint_every must be positive"):
        eng.stream(x, chunk_ticks=4, surrogates=sur, checkpoint_every=0)
    with pytest.raises(ValueError, match="requires surrogates"):
        eng.stream(x, chunk_ticks=4)
    with pytest.raises(ValueError, match="at least one stimulus tick"):
        next(eng.stream(iter([]), chunk_ticks=4, surrogates=sur))
    gen = eng.stream(iter([x[:4], x[4:8, :2]]), chunk_ticks=4,
                     surrogates=sur)
    with pytest.raises(ValueError, match="first chunk batch"):
        list(gen)


def test_stream_generator_early_close_keeps_engine_usable(banks):
    _, eng, (_, sur), x = _engines("lif", "megakernel", banks)
    gen = eng.stream(x, chunk_ticks=5, surrogates=sur)
    first = next(gen)
    gen.close()
    assert first.energy.shape[0] == 5
    builds, runners = eng.compile_count, len(eng._runners)
    assert_identical(eng.run_stream(x, chunk_ticks=5, surrogates=sur),
                     eng.run(x, surrogates=sur))
    # the 3-tick remainder and the monolithic runner (the flush, built
    # too, is not a tick loop and does not count)
    assert eng.compile_count == builds + 2
    assert len(eng._runners) == runners + 3


def test_facade_stream_entry_points(banks):
    import repro_torch.lasana as lasana
    desc, x = _lif_net()
    spec = _port_spec(desc)
    sur = banks["packable"][1]
    mono = lasana.simulate(spec, x, surrogates=sur, device="cpu",
                           record_hidden=False)
    run = lasana.simulate_stream(spec, x, chunk_ticks=6, surrogates=sur,
                                 device="cpu")
    assert_identical(run, mono)
    assert run.layer_spikes is None
    chunks = list(lasana.stream(spec, x, chunk_ticks=6, surrogates=sur,
                                device="cpu"))
    assert len(chunks) == 4 and chunks[-1].flush_energy.sum() > 0
    assert_identical(lasana.StreamingRun().update(chunks[0]).result(),
                     chunks[0])


@pytest.mark.parametrize("name", ["simulate_stream", "stream", "resume"])
def test_facade_signatures_match_reference(name):
    """The streaming entry points take the reference's parameters, in its
    order and with its defaults (``mesh`` included), plus the port's
    ``device``."""
    import inspect

    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    want = [(p.name, p.kind, p.default) for p in inspect.signature(
        getattr(jax_lasana, name)).parameters.values()]
    got = [(p.name, p.kind, p.default) for p in inspect.signature(
        getattr(lasana, name)).parameters.values() if p.name != "device"]
    assert got == want
    assert name in lasana.__all__


def test_checkpoint_and_accumulator_surface_match_reference():
    import dataclasses

    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    fields = lambda cls: [(f.name, f.type) for f in dataclasses.fields(cls)]
    assert fields(lasana.StreamCheckpoint) == fields(
        jax_lasana.StreamCheckpoint)
    for cls in ("StreamingRun", "StreamCheckpoint"):
        want = {m for m in vars(getattr(jax_lasana, cls))
                if not m.startswith("_")}
        assert want <= set(vars(getattr(lasana, cls))), cls
