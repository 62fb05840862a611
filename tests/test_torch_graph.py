"""Port parity: crossbar and mixed graphs through the whole engine
(``repro_torch.lasana.simulate`` vs ``repro.lasana.simulate``).

Workloads: a 70-12-4 crossbar MLP (B = 3, one combinational wave), the
``mixed_net`` of ``tests/test_streaming.py`` (a 20-8 crossbar front end
feeding a 6-neuron LIF bank with lateral inhibition, 16 ticks), a lif ->
crossbar -> crossbar chain with an edge into a crossbar layer (every
adapter), and the first items of the chip-smoke crossbar and mixed
workloads against their committed JAX records. Every backend and lasana
path runs, annotation mode included.

Discrete records must be identical: events, spike trains, spike counts
and the crossbar outputs' ADC codes (an output is a sum of codes over a
row's segments divided by the gain; float rounding aside it is an
integer number of ADC steps, compared as such). Continuous records agree
to rtol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_close, surrogate_pairs  # noqa: E402,F401

# path -> (surrogate set or None, simulate keywords)
PATHS = {
    "golden": (None, dict(backend="golden")),
    "behavioral": (None, dict(backend="behavioral")),
    "megakernel": ("packable", dict(fused_kernel=True)),
    "fused": ("packable", dict(fused_kernel=False)),
    "percall": ("packable", dict(fused=False)),
    "annotation": ("packable", dict(mode="annotation", fused_kernel=True)),
    "unpackable": ("unpackable", dict(fused_kernel=True)),
}
GAIN = 40e3 * 12e-6          # |-R_f * G_unit| of the crossbar row
STEP = 2 * 2.0 / 255         # one 8-bit ADC step over [-v_sat, v_sat]


@pytest.fixture(scope="module")
def libraries(surrogate_pairs):
    """{"packable"|"unpackable": (JAX library, port library)}: the
    crossbar artifact of that kind beside the packable LIF artifact."""
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro.core.surrogate import SurrogateLibrary as JaxLibrary
    from repro_torch.core.surrogate import Surrogate, SurrogateLibrary
    jlif, tlif = surrogate_pairs["packable"]
    out = {}
    for name, path in (("packable", fx.XBAR_PACKABLE),
                       ("unpackable", fx.XBAR_UNPACKABLE)):
        out[name] = (JaxLibrary({"crossbar": JaxSurrogate.load(str(path)),
                                 "lif": jlif}),
                     SurrogateLibrary({"crossbar": Surrogate.load(
                         str(path), device="cpu"), "lif": tlif}))
    return out


def _jax_spec(desc):
    from repro.core.network import (crossbar_layer, graph_spec, lif_layer,
                                    recurrent_edge)
    layers = [crossbar_layer(jnp.asarray(d["weight"])) if d["circuit"]
              == "crossbar" else lif_layer(jnp.asarray(d["weight"]),
                                           jnp.asarray(d["params"]))
              for d in desc["layers"]]
    return graph_spec(layers, edges=[recurrent_edge(s, d, w)
                                     for s, d, w in desc["edges"]])


def _codes(y, n_seg):
    """Per output, its sum of ADC codes over the row's n_seg segments."""
    return np.rint((np.asarray(y, np.float64) * -GAIN + 2.0 * n_seg)
                   / STEP).astype(np.int64)


def _simulate_both(desc, x, path, libraries):
    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    from repro_torch.convert import graph_spec_from_numpy
    which, kw = PATHS[path]
    jkw, tkw = dict(kw), dict(kw)
    if which is not None:
        jlib, tlib = libraries[which]
        kinds = sorted({d["circuit"] for d in desc["layers"]})
        if len(kinds) == 1:          # one kind: a single Surrogate
            jlib, tlib = jlib[kinds[0]], tlib[kinds[0]]
        jkw["surrogates"], tkw["surrogates"] = jlib, tlib
    fused = jkw.pop("fused", True)
    want = jax_lasana.engine(
        _jax_spec(desc), fused=fused,
        **{k: v for k, v in jkw.items() if k != "surrogates"}
    ).run(jnp.asarray(x), surrogates=jkw.get("surrogates"))
    got = lasana.simulate(graph_spec_from_numpy(desc["layers"],
                                                desc["edges"]),
                          x, device="cpu", **tkw)
    return got, want


def _assert_graph_runs_match(got, want, desc):
    layers = desc["layers"]
    n_seg = [-(-np.shape(d["weight"])[0] // 32) for d in layers]
    np.testing.assert_array_equal(got.events, np.asarray(want.events),
                                  err_msg="events")
    for i, d in enumerate(layers):
        g, w = got.layer_spikes[i], np.asarray(want.layer_spikes[i])
        if d["circuit"] == "crossbar":
            np.testing.assert_array_equal(_codes(g, n_seg[i]),
                                          _codes(w, n_seg[i]),
                                          err_msg=f"layer {i} codes")
            assert_close(g, w, f"layer {i} outputs")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"layer {i} spikes")
    if layers[-1]["circuit"] == "lif":
        np.testing.assert_array_equal(got.outputs, np.asarray(want.outputs))
        np.testing.assert_array_equal(got.out_spikes,
                                      np.asarray(want.out_spikes))
    else:
        assert got.out_spikes is None and want.out_spikes is None
        np.testing.assert_array_equal(_codes(got.outputs, n_seg[-1]),
                                      _codes(want.outputs, n_seg[-1]))
    for f in ("energy", "latency", "flush_energy"):
        assert_close(getattr(got, f), np.asarray(getattr(want, f)), f)


def _xbar_mlp():
    rng = np.random.default_rng(12)
    ws = [rng.integers(-1, 2, (70, 12)), rng.integers(-1, 2, (12, 4))]
    x = rng.uniform(-0.8, 0.8, (3, 70)).astype(np.float32)
    return {"layers": [{"circuit": "crossbar", "weight": w} for w in ws],
            "edges": []}, x


def _mixed_net(t_steps=16, batch=3):
    """tests/test_streaming.py's mixed_net, from numpy seed 3."""
    rng = np.random.default_rng(3)
    xw = rng.integers(-1, 2, (20, 8)).astype(np.float32)
    lw = (rng.normal(0, 0.5, (8, 6)) * 2.2).astype(np.float32)
    inhib = -0.6 * (1 - np.eye(6, dtype=np.float32))
    seq = (rng.integers(-1, 2, (t_steps, batch, 20)) * 0.8
           ).astype(np.float32)
    return {"layers": [{"circuit": "crossbar", "weight": xw},
                       {"circuit": "lif", "weight": lw,
                        "params": fx.LIF_KNOBS}],
            "edges": [(1, 1, inhib)]}, seq


def _chain():
    """lif -> crossbar -> crossbar with a delayed edge from the last layer
    back into the first crossbar's DAC inputs."""
    rng = np.random.default_rng(21)
    lw = (rng.normal(0, 1, (12, 40)) * 0.9).astype(np.float32)
    edge = (rng.integers(-1, 2, (5, 40)) * 0.1).astype(np.float32)
    x = ((rng.random((10, 2, 12)) < 0.3) * 1.5).astype(np.float32)
    return {"layers": [{"circuit": "lif", "weight": lw,
                        "params": fx.LIF_KNOBS},
                       {"circuit": "crossbar",
                        "weight": rng.integers(-1, 2, (40, 9))},
                       {"circuit": "crossbar",
                        "weight": rng.integers(-1, 2, (9, 5))}],
            "edges": [(2, 1, edge)]}, x


@pytest.mark.parametrize("path", list(PATHS))
def test_crossbar_mlp_matches_reference(libraries, path):
    desc, x = _xbar_mlp()
    got, want = _simulate_both(desc, x, path, libraries)
    assert got.outputs.shape == (3, 4) and got.events.sum() > 0
    _assert_graph_runs_match(got, want, desc)


@pytest.mark.parametrize("path", [p for p in PATHS if p != "unpackable"])
def test_mixed_net_matches_reference(libraries, path):
    desc, x = _mixed_net()
    got, want = _simulate_both(desc, x, path, libraries)
    assert got.outputs.sum() > 0
    _assert_graph_runs_match(got, want, desc)


@pytest.mark.parametrize("path", ["golden", "megakernel", "annotation"])
def test_lif_crossbar_chain_matches_reference(libraries, path):
    desc, x = _chain()
    got, want = _simulate_both(desc, x, path, libraries)
    _assert_graph_runs_match(got, want, desc)


def test_adapters_match_reference():
    from repro.core.network import adapt_signal as jadapt
    from repro_torch.core.network import adapt_signal
    y = np.random.default_rng(2).normal(0, 2, (4, 7)).astype(np.float32)
    for src, dst in (("lif", "lif"), ("lif", "crossbar"),
                     ("crossbar", "lif"), ("crossbar", "crossbar"),
                     ("input", "crossbar")):
        for act in ("tanh", "none"):
            got = adapt_signal(src, dst, torch.as_tensor(y),
                               activation=act).numpy()
            want = np.asarray(jadapt(src, dst, jnp.asarray(y),
                                     activation=act))
            assert_close(got, want, f"{src}->{dst} {act}")
    with pytest.raises(ValueError, match="no adapter"):
        adapt_signal("crossbar", "bogus", torch.as_tensor(y))


def test_spec_errors_match_reference(libraries):
    """A bad edge shape, an out-of-range edge, a wrong segment width and
    a single surrogate for a mixed graph fail as the reference does."""
    from repro.core.network import NetworkEngine as JaxEngine
    from repro_torch.convert import graph_spec_from_numpy
    from repro_torch.core.network import NetworkEngine, crossbar_layer
    from repro_torch.core.network import graph_spec as tgraph
    from repro.core.network import crossbar_layer as jcrossbar
    from repro.core.network import graph_spec as jgraph
    desc, _ = _mixed_net()
    bad = [dict(desc, edges=[(1, 1, np.zeros((6, 5), np.float32))]),
           dict(desc, edges=[(2, 1, np.zeros((6, 6), np.float32))]),
           dict(desc, edges=[(1, 0, np.zeros((6, 8), np.float32))])]
    for d in bad:
        with pytest.raises(ValueError) as jerr:
            JaxEngine(_jax_spec(d), backend="golden")
        with pytest.raises(ValueError) as terr:
            NetworkEngine(graph_spec_from_numpy(d["layers"], d["edges"]),
                          backend="golden", device="cpu")
        assert str(terr.value) == str(jerr.value)
    w = np.ones((20, 3), np.float32)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jgraph([jcrossbar(jnp.asarray(w), seg_width=16)]),
                  backend="golden")
    with pytest.raises(ValueError) as terr:
        NetworkEngine(tgraph([crossbar_layer(w, seg_width=16)]),
                      backend="golden", device="cpu")
    assert str(terr.value) == str(jerr.value)
    jlib, tlib = libraries["packable"]
    with pytest.raises(ValueError, match="mixed-circuit graphs need"):
        NetworkEngine(graph_spec_from_numpy(desc["layers"], desc["edges"]),
                      surrogates=tlib["crossbar"], device="cpu")


def test_mixed_library_hot_swap_keeps_one_runner(libraries):
    """Swapping the library for one of equal structure reuses the
    runner; the records follow the new weights."""
    import repro_torch.lasana as lasana
    from repro_torch.convert import graph_spec_from_numpy
    from repro_torch.core.surrogate import Surrogate, SurrogateLibrary
    desc, x = _mixed_net()
    spec = graph_spec_from_numpy(desc["layers"], desc["edges"])
    _, tlib = libraries["packable"]
    xb = tlib["crossbar"]
    swapped = SurrogateLibrary({"lif": tlib["lif"], "crossbar": Surrogate(
        xb.manifest, {p: {k: a * 1.5 if p == "M_ED" and k == "b2" else a
                          for k, a in d.items()}
                      for p, d in xb.params.items()})})
    a = lasana.simulate(spec, x, surrogates=tlib, device="cpu")
    b = lasana.simulate(spec, x, surrogates=swapped, device="cpu")
    assert lasana.engine(spec, device="cpu").compile_count == 1
    assert not np.array_equal(a.energy, b.energy)


def test_chip_workload_records_on_first_items():
    """The port on the first items of the chip-smoke crossbar MNIST and
    mixed workloads gives the committed JAX records' per-item fields:
    crossbar output codes (golden, both lasana artifacts) and mixed-net
    spike trains (golden, behavioral, lasana)."""
    import repro_torch.lasana as lasana
    from repro_torch.convert import (crossbar_spec_from_numpy,
                                     graph_spec_from_numpy)
    from repro_torch.core.surrogate import Surrogate, SurrogateLibrary
    xb = {p: Surrogate.load(str(p), device="cpu")
          for p in (fx.XBAR_PACKABLE, fx.XBAR_UNPACKABLE)}
    ws, volts, _ = fx.xbar_workload(n_images=3)
    spec = crossbar_spec_from_numpy(ws)
    with np.load(fx.XBAR_RECORD) as rec:
        for name, (path, fused_kernel) in fx.XBAR_RECORD_RUNS.items():
            kw = {"backend": "golden"} if path is None else {
                "surrogates": xb[path], "fused_kernel": fused_kernel}
            run = lasana.simulate(spec, volts, device="cpu", **kw)
            np.testing.assert_array_equal(
                _codes(run.outputs, 3), _codes(rec[f"{name}/outputs"][:3], 3),
                err_msg=name)
    w1, w2, knobs, inhib, seq, _ = fx.mixed_workload(n_images=3, t_steps=12)
    spec = graph_spec_from_numpy(
        [{"circuit": "crossbar", "weight": w1},
         {"circuit": "lif", "weight": w2, "params": knobs}],
        edges=[(1, 1, inhib)])
    lib = SurrogateLibrary({"crossbar": xb[fx.XBAR_PACKABLE],
                            "lif": Surrogate.load(str(fx.PACKABLE),
                                                  device="cpu")})
    with np.load(fx.MIXED_RECORD) as rec:
        for name in fx.MIXED_RECORD_RUNS:
            kw = ({"surrogates": lib, "fused_kernel": True}
                  if name == "lasana" else {"backend": name})
            run = lasana.simulate(spec, seq, device="cpu", **kw)
            spikes = (run.out_spikes > 0.75).astype(np.uint8)
            np.testing.assert_array_equal(
                spikes, rec[f"{name}/out_spikes"][:12, :3], err_msg=name)
