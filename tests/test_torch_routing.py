"""Port: routes decided from shapes, and wide surrogates end to end.

``tick_megakernel.kernel_takes`` / ``chunk_takes`` are the Python copies of
the CUDA kernels' layout rules (``csrc/network_tick.cu``); they decide, on
every device alike, whether a surrogate packs for ``network_tick`` and
whether a stream takes ``network_tick_chunk``. The values here are the
kernel's own (the row tiles it ran on the card at its widest heads, which
PERF.md records; ``chip_smoke.py`` holds the copies to the compiled rule
over a sweep).
A surrogate the rule refuses runs through the stacked-dispatch tick, whose
MLP groups call ``mlp_surrogate_heads``; its records must match the
reference's, and a stream whose pack the chunk kernel refuses must still
equal its monolithic run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_runs_match  # noqa: E402

WIDTHS = {"lif": (10, 12), "crossbar": (68, 70)}   # F active, transition


@pytest.mark.parametrize("circuit,h1,h2,takes", [
    ("lif", 100, 50, True),          # the trained artifacts
    ("crossbar", 100, 50, True),
    ("lif", 128, 128, True),         # the widest heads it was run at
    ("crossbar", 128, 50, True),
    ("crossbar", 100, 64, True),
    ("lif", 200, 50, False),         # H1 above the kernel's 128
    ("crossbar", 200, 50, False),
    ("lif", 129, 8, False),
    ("crossbar", 128, 128, False),   # inside the band: no 4-row tile fits
    ("crossbar", 94, 125, False),
])
def test_kernel_takes(circuit, h1, h2, takes):
    from repro_torch.kernels import tick_megakernel as mk
    f_a, f_t = WIDTHS[circuit]
    assert mk.kernel_takes(circuit, f_a, f_t, h1, h2) is takes
    # narrower stacks than the row, or a kind without a feature row
    assert not mk.kernel_takes(circuit, f_a - 1, f_t, h1, h2)
    assert not mk.kernel_takes(circuit, f_a, f_t - 1, h1, h2)
    assert not mk.kernel_takes("adder", f_a, f_t, h1, h2)


@pytest.mark.parametrize("circuit,h1,h2,together,rows", [
    ("lif", 100, 50, True, 128),
    ("crossbar", 100, 50, False, 80),
    ("lif", 128, 128, False, 12),
    ("crossbar", 128, 50, False, 36),
    ("crossbar", 100, 64, False, 68),
])
def test_tick_layout_matches_the_kernels_tiles(circuit, h1, h2, together,
                                               rows):
    """The row tiles network_tick ran on the card at these widths (as
    PERF.md records): both stacks together or in two phases, rows per
    tile."""
    from repro_torch.kernels import tick_megakernel as mk
    assert mk._tick_layout(circuit, h1, h2) == (together, rows)


@pytest.mark.parametrize("circuit,h1,h2,takes", [
    ("lif", 100, 50, True),
    ("lif", 64, 32, True),
    ("lif", 128, 128, False),        # two phases: the stacks do not fit
    ("lif", 200, 50, False),
    ("crossbar", 100, 50, False),    # LIF rows only
])
def test_chunk_takes(circuit, h1, h2, takes):
    from repro_torch.kernels import tick_megakernel as mk
    assert mk.chunk_takes(circuit, *WIDTHS[circuit], h1, h2) is takes


def _resized(sur, h1, h2, seed):
    """``sur`` with every MLP head redrawn at MLP(h1, h2) from a seed (the
    standardizers, scales and other heads kept)."""
    from repro_torch.core.surrogate import Surrogate
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    params = {}
    for p, d in sur.params.items():
        if sur.manifest.family_of(p) != "mlp":
            params[p] = d
            continue
        f = d["w0"].shape[0]
        params[p] = {**d, "w0": f32(rng.normal(0, f ** -0.5, (f, h1))),
                     "b0": f32(rng.normal(0, 0.1, h1)),
                     "w1": f32(rng.normal(0, h1 ** -0.5, (h1, h2))),
                     "b1": f32(rng.normal(0, 0.1, h2)),
                     "w2": f32(rng.normal(0, h2 ** -0.5, (h2, 1))),
                     "b2": f32(rng.normal(0, 0.1, 1))}
    return Surrogate(sur.manifest, params, sur.fit_info)


def _base(circuit):
    from repro_torch.core.surrogate import Surrogate
    path = fx.WIDE if circuit == "lif" else fx.XBAR_PACKABLE
    return Surrogate.load(str(path), device="cpu")


@pytest.mark.parametrize("circuit,h1,h2", [
    ("lif", 100, 50), ("lif", 128, 128), ("lif", 200, 50),
    ("crossbar", 100, 64), ("crossbar", 128, 128), ("crossbar", 200, 50),
])
def test_pack_heads_refuses_exactly_where_the_rule_does(circuit, h1, h2):
    from repro_torch.kernels import tick_megakernel as mk
    pack, layout = mk.pack_heads(_resized(_base(circuit), h1, h2, h1 + h2))
    takes = mk.kernel_takes(circuit, *WIDTHS[circuit], h1, h2)
    assert (pack is not None) is takes
    if not takes:
        assert layout is None
    else:
        assert tuple(pack["a"]["w0"].shape[1:]) == (WIDTHS[circuit][0], h1)


@pytest.mark.parametrize("lif_widths,packs", [((100, 50), True),
                                              ((128, 128), False)])
def test_pack_library_refuses_at_the_library_wide_widths(lif_widths, packs):
    """{crossbar MLP(100, 50), lif MLP(h1, h2)}: the library pads both
    kinds to the widest heads, and crossbar rows at MLP(128, 128) lie in
    the band network_tick refuses, so the library does not pack; the
    engine then packs each kind on its own (both take their own widths)."""
    from repro_torch.core.network import NetworkEngine
    from repro_torch.core.surrogate import SurrogateLibrary
    from repro_torch.kernels import tick_megakernel as mk
    lib = SurrogateLibrary({
        "crossbar": _resized(_base("crossbar"), 100, 50, 1),
        "lif": _resized(_base("lif"), *lif_widths, 2)})
    pack, layouts = mk.pack_library(lib)
    assert (pack is not None) is packs
    if not packs:
        assert layouts == {}
    ws, knobs, _ = fx.small_net()
    from repro_torch.convert import graph_spec_from_numpy
    spec = graph_spec_from_numpy(
        [{"circuit": "crossbar", "weight": np.sign(ws[0])},
         {"circuit": "lif", "weight": ws[1], "params": knobs[1]}])
    eng = NetworkEngine(spec, device="cpu")
    per_kind = eng._mk_pack(lib)
    assert set(per_kind) == {"crossbar", "lif"}
    shared = per_kind["crossbar"][0] is per_kind["lif"][0]
    assert shared is packs


def test_check_pack_guards_a_pack_built_around_the_rule():
    """_check_pack still refuses a pack the kernel cannot take, for a
    caller that builds one without pack_heads."""
    from repro_torch.kernels import tick_megakernel as mk
    pack, layout = mk.pack_heads(_base("lif"))
    assert pack is None                       # MLP(200, 50): refused
    pack, layout = mk.pack_heads(_resized(_base("lif"), 100, 50, 0))
    wide = {s: mk._pad_stack(st, st["w0"].shape[1], 200, 50)
            for s, st in pack.items()}
    mk._check_pack("network_tick", pack, "lif", layout)
    with pytest.raises(ValueError, match="refuses lif stacks"):
        mk._check_pack("network_tick", wide, "lif", layout)
    lif128 = mk.pack_heads(_resized(_base("lif"), 128, 128, 0))[0]
    mk._check_pack("network_tick", lif128, "lif", layout)
    with pytest.raises(ValueError, match="LIF rows, both stacks staged"):
        mk._check_pack("network_tick_chunk", lif128, "lif", layout)


class _Spy:
    """Counts the calls of a module function it stands in for."""

    def __init__(self, monkeypatch, module, name):
        self.calls, fn = 0, getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)


def _spies(monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.kernels import tick_megakernel as mk
    return {name: _Spy(monkeypatch, mod, name) for mod, name in (
        (ops, "mlp_surrogate_heads"), (mk, "network_tick"),
        (mk, "network_tick_chunk"))}


@pytest.mark.parametrize("workload", ["small_net", "chip"])
def test_wide_surrogate_matches_reference(monkeypatch, workload):
    """Every head MLP(200, 50) (the committed wide artifact): the port's
    simulate on the CPU against ``repro.lasana.simulate`` on the same
    stimulus, discrete records identical and continuous ones within rtol
    1e-5; the engine took the stacked-dispatch tick (three head groups per
    layer per tick through mlp_surrogate_heads, no network_tick)."""
    import repro.lasana as jax_lasana
    from repro.core.network import snn_spec
    import repro_torch.lasana as lasana
    from repro_torch.convert import spec_from_numpy
    if workload == "small_net":
        ws, knobs, x = fx.small_net()
    else:
        ws, knobs = fx.snn_weights()
        x, _ = fx.chip_workload(n_images=3, t_steps=12)
    want = jax_lasana.simulate(
        snn_spec([jnp.asarray(w) for w in ws],
                 [jnp.asarray(p) for p in knobs]),
        jnp.asarray(x), surrogates=jax_lasana.load(str(fx.WIDE)))
    spies = _spies(monkeypatch)
    got = lasana.simulate(spec_from_numpy(ws, knobs), x, device="cpu",
                          surrogates=lasana.load(str(fx.WIDE), device="cpu"))
    assert_runs_match(got, want)
    assert spies["mlp_surrogate_heads"].calls == 3 * len(ws) * x.shape[0]
    assert spies["network_tick"].calls == 0


@pytest.mark.parametrize("widths", [(128, 128), (200, 50)])
def test_stream_without_the_chunk_kernel_equals_monolithic(monkeypatch,
                                                           widths):
    """A one-LIF-layer graph, the chunk kernel's graph, with heads the
    chunk kernel refuses: MLP(128, 128) packs for network_tick (one launch
    a tick), MLP(200, 50) packs for neither (the stacked-dispatch tick).
    Its stream equals its monolithic run bit for bit and never reaches
    network_tick_chunk."""
    import repro_torch.lasana as lasana
    from repro_torch.convert import graph_spec_from_numpy
    from repro_torch.core.network import NetworkEngine
    from repro_torch.kernels import tick_megakernel as mk
    ws, knobs, x = fx.small_net(t_steps=23)
    spec = graph_spec_from_numpy(
        [{"circuit": "lif", "weight": ws[0], "params": knobs[0]}])
    sur = _resized(_base("lif"), *widths, 7)
    eng = NetworkEngine(spec, device="cpu")
    packs = eng._mk_pack(eng._runtime_banks(sur))
    assert eng._chunk_eligible()
    assert ("lif" in packs) is (widths == (128, 128))
    if packs:
        assert not eng._chunk_eligible(packs["lif"])
        assert not mk.pack_chunk_takes("lif", packs["lif"][0])
    mono = lasana.simulate(spec, x, device="cpu", surrogates=sur)
    spies = _spies(monkeypatch)
    streamed = lasana.simulate_stream(spec, x, chunk_ticks=7, device="cpu",
                                      surrogates=sur)
    for f in fx.RECORD_FIELDS:
        np.testing.assert_array_equal(getattr(streamed, f),
                                      getattr(mono, f), err_msg=f)
    assert spies["network_tick_chunk"].calls == 0
    if packs:
        assert spies["network_tick"].calls == x.shape[0]
        assert spies["mlp_surrogate_heads"].calls == 0
    else:
        assert spies["network_tick"].calls == 0
        assert spies["mlp_surrogate_heads"].calls == 3 * x.shape[0]
