"""Port parity: head packing and the whole-tick megakernel's plain version.

``pack_heads`` must build exactly the reference's stacks; the plain
``network_tick`` (``_tick_arrays`` with no skips) must agree with JAX
``megakernel_step(pallas=False)`` and with the JAX Pallas ``network_tick``
in interpret mode, standalone and in annotation mode, at ragged N:
discrete o and t_last identical, v / e / l to rtol 1e-5. Inside the port,
the megakernel, fused 3-dispatch, per-call and per-circuit reference
ticks agree with each other.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import (UNPACKABLE_FAMILIES,  # noqa: E402,F401
                                 assert_close, surrogate_pairs, tick_inputs)

CLOCK = 5.0
T_TICK = 30.0


def _port_surrogate(jsur):
    from repro_torch.convert import surrogate_from_numpy
    meta = {"format_version": jsur.manifest.format_version,
            "circuit": jsur.manifest.circuit,
            "families": dict(jsur.manifest.families),
            "scales": dict(jsur.manifest.scales),
            "features": list(jsur.manifest.features), "fit_info": None}
    arrays = {p: {k: np.asarray(a) for k, a in d.items()}
              for p, d in jsur.params.items()}
    return surrogate_from_numpy(meta, arrays, device="cpu")


@pytest.fixture(scope="module")
def mean_linear_pair(lif_bank):
    """The conftest mean+linear bank in both packages (packs with mean
    and linear heads)."""
    jsur = lif_bank.to_surrogate()
    return jsur, _port_surrogate(jsur)


@pytest.mark.parametrize("which", ["packable", "mean_linear"])
def test_pack_heads_equals_reference(surrogate_pairs, mean_linear_pair,
                                     which):
    from repro.kernels import tick_megakernel as jmk
    from repro_torch.kernels import tick_megakernel as mk
    jsur, tsur = (surrogate_pairs["packable"] if which == "packable"
                  else mean_linear_pair)
    jpack, jlayout = jmk.pack_heads(jsur)
    pack, layout = mk.pack_heads(tsur)
    assert (layout.a_fams, layout.t_fams) == (jlayout.a_fams, jlayout.t_fams)
    for s in ("a", "t"):
        assert pack[s].keys() == jpack[s].keys()
        for k, a in jpack[s].items():
            np.testing.assert_array_equal(pack[s][k].numpy(), np.asarray(a),
                                          err_msg=f"{s}/{k}")
    # unused canonical slots divide by ones, never by zero
    for s in ("a", "t"):
        assert torch.all(pack[s]["x_sd"] != 0)


def test_unpackable_artifact_refuses_to_pack(surrogate_pairs):
    from repro.kernels import tick_megakernel as jmk
    from repro_torch.kernels import tick_megakernel as mk
    jsur, tsur = surrogate_pairs["unpackable"]
    assert dict(tsur.manifest.families) == UNPACKABLE_FAMILIES
    assert jmk.pack_heads(jsur) == (None, None)
    assert mk.pack_heads(tsur) == (None, None)
    mlp3 = [p for p, f in UNPACKABLE_FAMILIES.items() if f == "mlp"
            and sum(k.startswith("w") for k in tsur.params[p]) == 3]
    assert len(mlp3) >= 2


def _both_ticks(jsur, tsur, n, seed, annotate):
    from repro.core.wrapper import LasanaState as JaxState
    from repro.kernels import tick_megakernel as jmk
    from repro_torch.convert import state_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.kernels import tick_megakernel as mk
    v, o, t_last, params, changed, x, known = tick_inputs(n, seed)
    jpack, jlayout = jmk.pack_heads(jsur)
    pack, layout = mk.pack_heads(tsur)
    js = JaxState(v=jnp.asarray(v), o=jnp.asarray(o),
                  t_last=jnp.asarray(t_last), params=jnp.asarray(params))
    jknown = jnp.asarray(known) if annotate else None
    ns, e, l, _ = jmk.megakernel_step(
        jpack, "lif", js, jnp.asarray(changed), jnp.asarray(x),
        jnp.float32(T_TICK), CLOCK, spiking=True, vdd=1.5,
        known_out=jknown, layout=jlayout, pallas=False)
    want_jnp = tuple(map(np.asarray, (ns.v, ns.o, ns.t_last, e, l)))
    want_pallas = tuple(map(np.asarray, jmk.network_tick(
        jpack, js.v, js.o, js.t_last, js.params, jnp.asarray(changed),
        jnp.asarray(x), jnp.float32(T_TICK),
        jknown if annotate else jnp.zeros_like(js.v), circuit="lif",
        clock_ns=CLOCK, layout=jlayout, spiking=True, vdd=1.5,
        annotate=annotate, interpret=True)))
    st = state_from_numpy(v, o, t_last, params, device="cpu")
    got = tuple(a.numpy() for a in ops.network_tick(
        pack, st.v, st.o, st.t_last, st.params, torch.as_tensor(changed),
        torch.as_tensor(x), torch.tensor(T_TICK),
        torch.as_tensor(known) if annotate else None, circuit="lif",
        clock_ns=CLOCK, layout=layout, spiking=True, vdd=1.5,
        annotate=annotate))
    return got, want_jnp, want_pallas


def _assert_tick_match(got, want, tag):
    v, o, tl, e, l = got
    wv, wo, wtl, we, wl = want
    np.testing.assert_array_equal(o, wo, err_msg=f"{tag} o")
    np.testing.assert_array_equal(tl, wtl, err_msg=f"{tag} t_last")
    assert_close(v, wv, f"{tag} v")
    assert_close(e, we, f"{tag} e")
    assert_close(l, wl, f"{tag} l")


@pytest.mark.parametrize("annotate", [False, True])
@pytest.mark.parametrize("n", [5, 300])
def test_plain_network_tick_matches_reference(surrogate_pairs, n, annotate):
    jsur, tsur = surrogate_pairs["packable"]
    got, want_jnp, want_pallas = _both_ticks(jsur, tsur, n, seed=n,
                                             annotate=annotate)
    assert 0 < got[3].astype(bool).sum() < n       # some rows idle
    _assert_tick_match(got, want_jnp, "megakernel_step")
    _assert_tick_match(got, want_pallas, "pallas interpret")


def test_plain_network_tick_mean_linear_heads(mean_linear_pair):
    """Native-cost mean and linear heads through the same plain body."""
    jsur, tsur = mean_linear_pair
    got, want_jnp, _ = _both_ticks(jsur, tsur, 37, seed=9, annotate=False)
    _assert_tick_match(got, want_jnp, "mean/linear")


@pytest.mark.parametrize("annotate", [False, True])
def test_port_tick_paths_agree(surrogate_pairs, annotate):
    """megakernel == fused 3-dispatch == per-call inside the port, and
    all equal the per-circuit numpy transcription (standalone)."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.wrapper import lasana_step, lasana_step_reference
    _, tsur = surrogate_pairs["packable"]
    v, o, t_last, params, changed, x, known = tick_inputs(41, seed=4)
    st = state_from_numpy(v, o, t_last, params, device="cpu")
    args = (tsur, st, torch.as_tensor(changed), torch.as_tensor(x),
            torch.tensor(T_TICK), CLOCK)
    kw = dict(spiking=True, vdd=1.5,
              known_out=torch.as_tensor(known) if annotate else None)
    runs = {name: lasana_step(*args, **kw, **extra) for name, extra in (
        ("mega", dict(fused_kernel=True)), ("fused", dict(fused_kernel=False)),
        ("percall", dict(fused=False)))}
    if not annotate:
        ns, e, l, o_ref = lasana_step_reference(
            tsur, st, changed, x, T_TICK, CLOCK, spiking=True, vdd=1.5)
        runs["reference"] = (ns, torch.as_tensor(e), torch.as_tensor(l),
                             torch.as_tensor(o_ref))
    ref = runs.pop("fused")
    for name, (ns, e, l, o_) in runs.items():
        _assert_tick_match(
            tuple(a.numpy() for a in (ns.v, ns.o, ns.t_last, e, l)),
            tuple(a.numpy() for a in (ref[0].v, ref[0].o, ref[0].t_last,
                                      ref[1], ref[2])), name)
