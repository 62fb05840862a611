"""Port parity: the crossbar row (``repro_torch`` vs ``repro``).

``CrossbarRow`` — its DC target, golden clock period, behavioral update
and derived surrogate feature — against the JAX class on the same numpy
rows at ragged N; the plain ``crossbar_target`` against the reference's
Pallas ``crossbar_target`` in interpret mode and ``ref.crossbar_target_ref``;
``pack_heads`` / ``pack_library`` for a crossbar artifact and a {crossbar,
lif} library, array for array; the plain whole-tick kernel on crossbar
rows (alone and inside the cross-kind pack) against JAX
``megakernel_step(pallas=False)``; the stacked MLP heads at the crossbar's
feature widths (68, 70).

Tolerances: continuous records to rtol 1e-5 (``assert_close``); discrete
ones (``spiked``, the settling time, a tick's output event class)
identical except on rows within ``BAND`` of their threshold, where one
ULP of ``tanh``/``exp`` (XLA and PyTorch round 58% / 20% of fp32 results
differently) may move the decision.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_close, surrogate_pairs  # noqa: E402,F401

N_CASES = [5, 256, 517]
BAND = 1e-5           # |value - threshold| within which a decision may flip
CLOCK = 4.0
T_TICK = 28.0


def _rows(n: int, seed: int):
    """(state (N, 1), v (N, 32), w (N, 33)) numpy rows: DAC volts (70%
    analog, 30% full-swing digital), ternary weights and bias, previous
    outputs in [-2, 2] V."""
    rng = np.random.default_rng(seed)
    uni = rng.uniform(-0.8, 0.8, (n, 32))
    dig = rng.integers(-1, 2, (n, 32)) * 0.8
    v = np.where(rng.random((n, 1)) < 0.3, dig, uni).astype(np.float32)
    w = rng.integers(-1, 2, (n, 33)).astype(np.float32)
    state = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    return state, v, w


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _settle_margins(state, v, w, circ=None):
    """Per row: the least distance between |v_k - v_tgt| and the 90%
    settling band over the substeps, and |v_end - v0| from 0.02, for
    ``circ`` (by default CrossbarRow())."""
    from repro_torch.core.circuits import CrossbarRow
    from repro_torch.kernels import crossbar_mvm
    circ = circ or CrossbarRow()
    s, vv, ww = _t(state, v, w)
    v_tgt, tau = crossbar_mvm.target_plain(circ, vv, ww)
    dt = circ.clock_ns / circ.n_substeps
    a = torch.exp(torch.tensor(-dt) / tau)
    v0 = s[:, 0]
    band = 0.1 * torch.abs(v_tgt - v0) + 1e-6
    x, margin = v0, torch.full_like(v0, float("inf"))
    for _ in range(circ.n_substeps):
        x = v_tgt + (x - v_tgt) * a
        margin = torch.minimum(margin, torch.abs(torch.abs(x - v_tgt) - band))
    return margin.numpy(), torch.abs(torch.abs(x - v0) - 0.02).numpy()


@pytest.mark.parametrize("n", N_CASES)
def test_crossbar_target_matches_reference(n):
    from repro.core.circuits import CrossbarRow as JaxRow
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops
    _, v, w = _rows(n, seed=n)
    got = tuple(a.numpy() for a in ops.crossbar_target(*_t(v, w)))
    wants = {
        "circuit": jax.jit(JaxRow()._target)(jnp.asarray(v), jnp.asarray(w)),
        "pallas interpret": jops.crossbar_target(
            jnp.asarray(v), jnp.asarray(w), interpret=True),
        "ref": jref.crossbar_target_ref(jnp.asarray(v), jnp.asarray(w)),
    }
    for name, (tgt, tau) in wants.items():
        assert_close(got[0], tgt, f"{name} v_tgt")
        assert_close(got[1], tau, f"{name} tau")
    assert np.abs(got[0]).max() > 1.0 and np.ptp(got[1]) > 0


@pytest.mark.parametrize("n", N_CASES)
def test_crossbar_step_matches_circuit_step(n):
    from repro.core.circuits import CrossbarRow as JaxRow
    from repro_torch.core.circuits import CrossbarRow
    state, v, w = _rows(n, seed=n + 1)
    new_state, obs = CrossbarRow().step(*_t(state, v, w))
    ws, wo = jax.jit(JaxRow().step)(jnp.asarray(state), jnp.asarray(v),
                                    jnp.asarray(w))
    margin, spike_margin = _settle_margins(state, v, w)
    for name, near in (("spiked", spike_margin <= BAND),
                       ("latency", margin <= BAND)):
        diff = obs[name].numpy() != np.asarray(wo[name])
        assert not (diff & ~near).any(), (name, np.flatnonzero(diff & ~near))
    keep = (obs["latency"].numpy() == np.asarray(wo["latency"]))
    assert keep.mean() > 0.98
    assert_close(new_state.numpy(), ws, "state")
    assert_close(obs["output"].numpy(), wo["output"], "output")
    assert_close(obs["energy"].numpy(), wo["energy"], "energy")
    lat = obs["latency"].numpy()
    assert (lat < CrossbarRow().clock_ns).any() and obs["spiked"].any()


def test_behavioral_step_and_features_match_reference():
    from repro.core.circuits import CrossbarRow as JaxRow
    from repro.core.circuits import augment_features as jaugment
    from repro_torch.core.circuits import CrossbarRow, augment_features
    state, v, w = _rows(300, seed=7)
    held = state[:, 0]
    got = CrossbarRow().behavioral_step(*_t(held, v, w))
    want = jax.jit(JaxRow().behavioral_step)(
        jnp.asarray(held), jnp.asarray(v), jnp.asarray(w))
    for g, wa, name in zip(got, want, ("v_new", "output")):
        assert_close(g.numpy(), wa, name)
    # the derived feature sums w . x in index order, as XLA does: equal
    np.testing.assert_array_equal(
        CrossbarRow().surrogate_features(*_t(v, w)).numpy(),
        np.asarray(jax.jit(JaxRow().surrogate_features)(jnp.asarray(v),
                                                        jnp.asarray(w))))
    raw = np.concatenate([v, held[:, None], np.full((300, 1), CLOCK), w],
                         axis=1).astype(np.float32)
    aug = augment_features(CrossbarRow(), torch.as_tensor(raw)).numpy()
    assert aug.shape == (300, 68)
    np.testing.assert_array_equal(
        aug, np.asarray(jax.jit(lambda f: jaugment(JaxRow(), f))(
            jnp.asarray(raw))))


def test_jitted_reference_divides_by_reciprocal():
    """A measured fact the tolerances rest on: inside a compiled JAX
    program (every ``repro.lasana.simulate`` run) XLA turns ``x / c`` for
    a Python constant ``c`` into ``x * f32(1 / f32(c))``, one rounding
    more than the true division eager JAX, the port (``ops.div``) and the
    kernels perform. The ADC's ``/ levels`` and ``/ gain`` and the
    capacitor power's ``/ (dt * 1e-9)`` therefore differ by about one ULP
    between the port and the reference records."""
    from repro_torch.kernels import ops
    x = np.random.default_rng(0).uniform(-5, 5, 4096).astype(np.float32)
    for c in (255.0, -40e3 * 12e-6, 0.0625 * 1e-9):
        jitted = np.asarray(jax.jit(lambda a: a / c)(jnp.asarray(x)))
        recip = x * (np.float32(1) / np.float32(c))
        np.testing.assert_array_equal(jitted, recip)
        port = ops.div(torch.as_tensor(x), c).numpy()
        np.testing.assert_array_equal(port, x / np.float32(c))
        assert 0 < np.mean(port != jitted) < 0.9


def test_reference_row_sums_in_index_order():
    """XLA-CPU reduces a 32-wide row in index order, one rounding per
    term, which ``circuits.row_sum`` (and every kernel) reproduces;
    ``torch.sum`` sums in another order and differs on some rows."""
    from repro_torch.core.circuits import row_sum
    a = np.random.default_rng(1).uniform(-1, 1, (2048, 32)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=-1))(jnp.asarray(a)))
    np.testing.assert_array_equal(row_sum(torch.as_tensor(a)).numpy(), want)
    assert (torch.as_tensor(a).sum(-1).numpy() != want).any()


def _library_pair(pairs):
    """The {crossbar, lif} library in both packages, and their packs."""
    from repro.core.surrogate import SurrogateLibrary as JaxLibrary
    from repro.kernels import tick_megakernel as jmk
    from repro_torch.core.surrogate import SurrogateLibrary
    from repro_torch.kernels import tick_megakernel as mk
    jlib = JaxLibrary({"crossbar": pairs["crossbar"][0],
                       "lif": pairs["lif"][0]})
    tlib = SurrogateLibrary({"crossbar": pairs["crossbar"][1],
                             "lif": pairs["lif"][1]})
    return jmk.pack_library(jlib), mk.pack_library(tlib)


@pytest.fixture(scope="module")
def pairs(surrogate_pairs):
    """{"crossbar"|"crossbar_unpackable"|"lif": (JAX, port Surrogate)}."""
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro_torch.core.surrogate import Surrogate
    out = {name: (JaxSurrogate.load(str(path)),
                  Surrogate.load(str(path), device="cpu"))
           for name, path in (("crossbar", fx.XBAR_PACKABLE),
                              ("crossbar_unpackable", fx.XBAR_UNPACKABLE))}
    out["lif"] = surrogate_pairs["packable"]
    return out


def _fields(layout):
    return (layout.a_fams, layout.t_fams, layout.a_off, layout.t_off)


def _assert_packs_equal(pack, jpack):
    for s in ("a", "t"):
        assert pack[s].keys() == jpack[s].keys()
        for k, a in jpack[s].items():
            np.testing.assert_array_equal(pack[s][k].numpy(), np.asarray(a),
                                          err_msg=f"{s}/{k}")
        assert torch.all(pack[s]["x_sd"] != 0)


def test_pack_heads_crossbar_equals_reference(pairs):
    from repro.kernels import tick_megakernel as jmk
    from repro_torch.kernels import tick_megakernel as mk
    jsur, tsur = pairs["crossbar"]
    (jpack, jlayout), (pack, layout) = jmk.pack_heads(jsur), mk.pack_heads(tsur)
    assert _fields(layout) == _fields(jlayout)
    assert pack["a"]["w0"].shape[1] == 68
    assert pack["t"]["w0"].shape[1] == 70
    _assert_packs_equal(pack, jpack)
    jun, tun = pairs["crossbar_unpackable"]
    assert dict(tun.manifest.families) == fx.UNPACKABLE_FAMILIES
    assert jmk.pack_heads(jun) == (None, None)
    assert mk.pack_heads(tun) == (None, None)


def test_pack_library_equals_reference(pairs):
    (jpack, jlayouts), (pack, layouts) = _library_pair(pairs)
    assert {k: _fields(lo) for k, lo in layouts.items()} == \
        {k: _fields(lo) for k, lo in jlayouts.items()}
    assert (layouts["crossbar"].a_off, layouts["lif"].a_off) == (0, 3)
    assert (layouts["crossbar"].t_off, layouts["lif"].t_off) == (0, 2)
    assert pack["a"]["w0"].shape[:2] == (6, 68)
    _assert_packs_equal(pack, jpack)


def _tick_rows(n, seed, circuit):
    """One tick's numpy inputs for ``circuit`` rows: (v, o, t_last,
    params, changed, x, known)."""
    if circuit == "lif":
        return fx.tick_inputs(n, seed)
    rng = np.random.default_rng(seed)
    state, x, w = _rows(n, seed)
    w[:, 32] = 0.0                       # the engine's rows carry no bias
    changed = rng.random(n) < 0.6
    o = rng.uniform(-2, 2, n).astype(np.float32)
    # annotation: 30% of the known outputs repeat the last one (no event)
    known = np.where(rng.random(n) < 0.3, o,
                     rng.uniform(-2, 2, n)).astype(np.float32)
    return (state[:, 0], o, rng.choice([0.0, 20.0, 24.0], n).astype(
        np.float32), w, changed, x, known)


def _tick_both(jpack, jlayout, pack, layout, circuit, n, seed, annotate):
    from repro.core.wrapper import LasanaState as JaxState
    from repro.kernels import tick_megakernel as jmk
    from repro_torch.convert import state_from_numpy
    from repro_torch.kernels import ops
    v, o, t_last, params, changed, x, known = _tick_rows(n, seed, circuit)
    spiking = circuit == "lif"
    clock, t_now = (5.0, 30.0) if spiking else (CLOCK, T_TICK)
    js = JaxState(v=jnp.asarray(v), o=jnp.asarray(o),
                  t_last=jnp.asarray(t_last), params=jnp.asarray(params))
    ns, e, l, _ = jmk.megakernel_step(
        jpack, circuit, js, jnp.asarray(changed), jnp.asarray(x),
        jnp.float32(t_now), clock, spiking=spiking, vdd=1.5,
        known_out=jnp.asarray(known) if annotate else None, layout=jlayout,
        pallas=False)
    want = tuple(map(np.asarray, (ns.v, ns.o, ns.t_last, e, l)))
    st = state_from_numpy(v, o, t_last, params, device="cpu")
    got = tuple(a.numpy() for a in ops.network_tick(
        pack, st.v, st.o, st.t_last, st.params, torch.as_tensor(changed),
        torch.as_tensor(x), torch.tensor(t_now),
        torch.as_tensor(known) if annotate else None, circuit=circuit,
        clock_ns=clock, layout=layout, spiking=spiking, vdd=1.5,
        annotate=annotate))
    return got, want, (changed, o)


@pytest.mark.parametrize("annotate", [False, True])
@pytest.mark.parametrize("which", ["crossbar", "crossbar in library",
                                   "lif in library"])
def test_plain_network_tick_crossbar_matches_reference(pairs, which,
                                                       annotate):
    from repro.kernels import tick_megakernel as jmk
    from repro_torch.kernels import tick_megakernel as mk
    circuit = which.split()[0]
    if which == "crossbar":
        (jpack, jlayout) = jmk.pack_heads(pairs["crossbar"][0])
        (pack, layout) = mk.pack_heads(pairs["crossbar"][1])
    else:
        (jpack, jlayouts), (pack, layouts) = _library_pair(pairs)
        jlayout, layout = jlayouts[circuit], layouts[circuit]
    got, want, (changed, o) = _tick_both(jpack, jlayout, pack, layout,
                                         circuit, 263, 5 + annotate, annotate)
    v, o_new, tl, e, l = got
    np.testing.assert_array_equal(tl, want[2], err_msg="t_last")
    if circuit == "lif":
        np.testing.assert_array_equal(o_new, want[1], err_msg="o")
        flip = np.zeros_like(changed)
    else:
        assert_close(o_new, want[1], "o")
        # the event class (|o_hat - o| > out_eps) decides which head the
        # energy record reads: identical away from the threshold
        ev_g = changed & (np.abs(o_new - o) > 0.02)
        ev_w = changed & (np.abs(want[1] - o) > 0.02)
        flip = ev_g != ev_w
        assert not (flip & (np.abs(np.abs(want[1] - o) - 0.02) > BAND)).any()
        assert ev_w.sum() > 0
        assert (changed & ~ev_w).sum() > 0 or not annotate
    keep = ~flip
    assert_close(v[keep], want[0][keep], "v")
    assert_close(e[keep], want[3][keep], "e")
    assert_close(l[keep], want[4][keep], "l")


@pytest.mark.parametrize("n", [7, 300])
def test_mlp_heads_crossbar_widths_match_reference(pairs, n):
    """The unpackable crossbar artifact's stacked groups, (M_O, M_V) at
    F = 68 and (M_ED, M_L) at F = 70, against the reference's Pallas
    ``mlp_surrogate_heads`` in interpret mode."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    _, tsur = pairs["crossbar_unpackable"]
    keys = ("x_mu", "x_sd", "y_mu", "y_sd", "w0", "b0", "w1", "b1", "w2",
            "b2")
    for pnames, f in ((("M_O", "M_V"), 68), (("M_ED", "M_L"), 70)):
        s = tsur._stacked(pnames)
        assert s["w0"].shape[1] == f
        x = np.random.default_rng(n + f).normal(0, 1, (n, f)).astype(
            np.float32)
        got = ops.mlp_surrogate_heads(torch.as_tensor(x),
                                      *(s[k] for k in keys)).numpy()
        want = jops.mlp_surrogate_heads(
            jnp.asarray(x), *(jnp.asarray(s[k].numpy()) for k in keys),
            interpret=True)
        assert got.shape == (2, n)
        assert_close(got, want, f"{pnames}")
