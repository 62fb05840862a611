"""The layer runners (``repro_torch.core.simulate``) against the reference's
(``repro.core.simulate``).

Both packages run on the reference's own stimulus (``make_stimulus``'s
``jax.random`` draws, as numpy): LIF at N = 96 x T = 40, crossbar rows at
N = 32 x T = 12. Discrete records (LIF spikes) are identical, continuous
ones (states, energy, latency, crossbar outputs) within rtol 1e-5, in
every mode (golden, behavioral, LASANA-P, LASANA-O, annotation), with the
fused and per-call tick bodies and with the kernel path on and off. The
port's own ``make_stimulus`` draws from a ``torch.Generator`` and is held
to the reference's rules. The committed layer record
(``layer_ref_record.npz``) is checked at the chip phase's shapes, and its
first neurons rerun in the port.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_close  # noqa: E402

SHAPES = {"lif": (96, 40), "crossbar": (32, 12)}
ARTIFACT = {"lif_packable": ("lif", fx.PACKABLE),
            "lif_unpackable": ("lif", fx.UNPACKABLE),
            "crossbar_packable": ("crossbar", fx.XBAR_PACKABLE)}
FLAGS = {"fused": dict(fused=True, fused_kernel=True),
         "stacked": dict(fused=True, fused_kernel=False),
         "percall": dict(fused=False)}


@functools.cache
def _stimulus(circuit):
    from repro.core.simulate import make_stimulus
    n, t_steps = SHAPES[circuit]
    return tuple(np.asarray(a) for a in make_stimulus(circuit, n, t_steps,
                                                      seed=3))


@functools.cache
def _reference(circuit, backend):
    from repro.core.simulate import run_behavioral, run_golden
    fn = run_golden if backend == "golden" else run_behavioral
    return fn(circuit, *_stimulus(circuit))


@functools.cache
def _surrogates(name):
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro_torch.core.surrogate import Surrogate
    path = str(ARTIFACT[name][1])
    return JaxSurrogate.load(path), Surrogate.load(path, device="cpu")


def _mode_kw(circuit, mode):
    if mode == "p":
        return {}
    if mode == "o":
        return {"oracle_states": _reference(circuit, "golden").states}
    beh = _reference(circuit, "behavioral")
    return {"oracle_states": beh.states, "annotate_outputs": beh.outputs}


@functools.cache
def _reference_lasana(name, mode):
    from repro.core.simulate import run_lasana
    circuit = ARTIFACT[name][0]
    return run_lasana(_surrogates(name)[0], circuit, *_stimulus(circuit),
                      **_mode_kw(circuit, mode))


# A state LASANA predicts is the M_V head's output fed back each tick: one
# that cancels to near zero differs by the rounding of the head's
# unit-scale sums, compounded over the ticks (1.4e-6 V at 0.036 V, 3.6e-6
# V at 0.71 V on LIF), not by 1e-5 of itself; it compares with an atol at
# 1e-5 of the field's scale, as the reference's kernel tests compare head
# outputs (tests/test_kernels.py: atol 1e-5 at unit scale)
HEAD_ATOL = 1e-5


def assert_layer_match(got, want, circuit, head_states=False):
    """LIF spikes identical; every continuous record within rtol 1e-5
    (``head_states``: the states are M_V's predictions)."""
    fields = ("states", "energy", "latency")
    if circuit == "lif":
        np.testing.assert_array_equal(got.outputs, want.outputs)
    else:
        fields = ("outputs",) + fields
    for f in fields:
        atol = HEAD_ATOL if head_states and f == "states" else 1e-6
        assert_close(getattr(got, f), np.asarray(getattr(want, f)), f,
                     atol_scale=atol)
    assert got.outputs.shape == np.asarray(want.outputs).shape
    assert got.wall_seconds >= 0.0 and got.compile_seconds >= 0.0


# --- the port's stimulus --------------------------------------------------------

@pytest.mark.parametrize("circuit", ["lif", "crossbar"])
def test_make_stimulus_rules(circuit):
    """Tick 0 active, the active share at alpha, LIF zero drive on idle
    ticks, crossbar rows holding their last active tick's voltages; the
    same seed draws the same stimulus."""
    from repro_torch.core.simulate import make_stimulus
    n, t_steps, alpha = 2000, 40, 0.7
    active, x, params = make_stimulus(circuit, n, t_steps, alpha=alpha,
                                      seed=11, device="cpu")
    n_in, n_p = (3, 4) if circuit == "lif" else (32, 33)
    assert active.shape == (t_steps, n) and active.dtype == torch.bool
    assert x.shape == (t_steps, n, n_in) and params.shape == (n, n_p)
    assert bool(active[0].all())
    share = float(active[1:].float().mean())
    assert abs(share - alpha) < 0.01, share
    idle = ~active
    if circuit == "lif":
        assert bool((x[idle] == 0).all())
        assert bool((x[active] != 0).any(dim=-1).float().mean() > 0.5)
    else:
        prev = torch.cat([x[:1], x[:-1]])
        assert bool((x[idle] == prev[idle]).all())
        assert bool(((params == -1) | (params == 0) | (params == 1)).all())
    again = make_stimulus(circuit, n, t_steps, alpha=alpha, seed=11,
                          device="cpu")
    other = make_stimulus(circuit, n, t_steps, alpha=alpha, seed=12,
                          device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((active, x, params), again))
    assert not torch.equal(x, other[1])


@pytest.mark.parametrize("circuit", ["lif", "crossbar"])
def test_hold_rule_equals_reference_on_its_own_draws(circuit):
    """The port's hold rule applied to the reference's fresh draws gives
    the reference's ``make_stimulus`` inputs bit for bit."""
    import jax

    from repro.core.circuits import get_circuit
    from repro.core.simulate import make_stimulus
    from repro_torch.core.circuits import get_circuit as port_circuit
    from repro_torch.core.simulate import _held
    n, t_steps = 64, 25
    active, x, _ = make_stimulus(circuit, n, t_steps, seed=5)
    _, kx, _ = jax.random.split(jax.random.PRNGKey(5), 3)
    fresh = get_circuit(circuit).sample_inputs(kx, (t_steps, n))
    got = _held(port_circuit(circuit), torch.as_tensor(np.array(active)),
                torch.as_tensor(np.array(fresh)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(x))


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    from repro_torch.core import simulate
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate.make_stimulus("lif", 4, 3)
    active, x, params = _stimulus("lif")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate.run_golden("lif", active, x, params)


# --- golden and behavioral ------------------------------------------------------

@pytest.mark.parametrize("backend", ["golden", "behavioral"])
@pytest.mark.parametrize("circuit", ["lif", "crossbar"])
def test_golden_and_behavioral_match_reference(circuit, backend):
    from repro_torch.core import simulate
    fn = simulate.run_golden if backend == "golden" else \
        simulate.run_behavioral
    got = fn(circuit, *_stimulus(circuit), device="cpu")
    assert_layer_match(got, _reference(circuit, backend), circuit)
    if backend == "behavioral":
        assert not got.energy.any() and not got.latency.any()


# --- LASANA ---------------------------------------------------------------------

@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("mode", ["p", "o", "annotate"])
@pytest.mark.parametrize("name", sorted(ARTIFACT))
def test_lasana_matches_reference(name, mode, flags):
    """LASANA-P, LASANA-O and annotation, through the whole-tick kernel
    path, the stacked-dispatch tick and the per-call tick."""
    from repro_torch.core.simulate import run_lasana
    circuit = ARTIFACT[name][0]
    got = run_lasana(_surrogates(name)[1], circuit, *_stimulus(circuit),
                     device="cpu", **_mode_kw(circuit, mode), **FLAGS[flags])
    assert_layer_match(got, _reference_lasana(name, mode), circuit,
                       head_states=mode != "annotate")


def test_annotation_requires_oracle_states():
    from repro_torch.core.simulate import run_lasana
    beh = _reference("lif", "behavioral")
    with pytest.raises(ValueError, match="oracle_states"):
        run_lasana(_surrogates("lif_packable")[1], "lif", *_stimulus("lif"),
                   annotate_outputs=beh.outputs, device="cpu")


@pytest.mark.parametrize("annotate", [False, True])
def test_oracle_state_is_the_boundary_state_before_each_tick(monkeypatch,
                                                              annotate):
    """LASANA-O: tick t starts from the oracle's state at boundary t —
    zeros at tick 0, then the record of tick t - 1 — and annotation
    publishes the given outputs with that state."""
    from repro_torch.core import simulate
    seen = []
    real = simulate.lasana_step

    def spy(sur, state, *args, **kw):
        seen.append(state.v.clone())
        return real(sur, state, *args, **kw)

    monkeypatch.setattr(simulate, "lasana_step", spy)
    active, x, params = _stimulus("lif")
    oracle = np.random.default_rng(0).uniform(
        0, 1, active.shape).astype(np.float32)
    kw = {"oracle_states": oracle}
    if annotate:
        kw["annotate_outputs"] = (np.random.default_rng(1).random(
            active.shape) < 0.2).astype(np.float32) * 1.5
    run = simulate.run_lasana(_surrogates("lif_packable")[1], "lif", active,
                              x, params, device="cpu", **kw)
    fed = torch.stack(seen).numpy()
    np.testing.assert_array_equal(fed[0], 0.0)
    np.testing.assert_array_equal(fed[1:], oracle[:-1])
    if annotate:
        np.testing.assert_array_equal(run.outputs, kw["annotate_outputs"])
        np.testing.assert_array_equal(run.states, fed)


def test_the_head_pack_is_built_once_per_run(monkeypatch):
    """A packable surrogate is packed once per ``run_lasana`` call and
    every tick takes that pack; an unpackable one takes the stacked
    dispatch tick."""
    from repro_torch.core import simulate
    from repro_torch.kernels import tick_megakernel as mk
    packs, ticks = [], []
    real_pack, real_step = mk.pack_heads, simulate.lasana_step

    def pack_spy(sur):
        packs.append(sur)
        return real_pack(sur)

    def step_spy(*args, **kw):
        ticks.append(kw["megakernel_pack"] is not None)
        return real_step(*args, **kw)

    monkeypatch.setattr(mk, "pack_heads", pack_spy)
    monkeypatch.setattr(simulate, "lasana_step", step_spy)
    active, x, params = _stimulus("lif")
    simulate.run_lasana(_surrogates("lif_packable")[1], "lif", active, x,
                        params, device="cpu")
    assert len(packs) == 1 and len(ticks) == active.shape[0] and all(ticks)
    simulate.run_lasana(_surrogates("lif_packable")[1], "lif", active, x,
                        params, device="cpu", fused_kernel=False)
    assert len(packs) == 1


def test_bank_values_are_frozen_to_surrogates():
    """A fitted ``PredictorBank`` runs as the surrogate it freezes to."""
    from repro_torch.core.dataset import (CircuitDataset, TestbenchConfig,
                                          generate_testbench,
                                          simulate_golden)
    from repro_torch.core.events import extract_events, split_runwise
    from repro_torch.core.predictors import PredictorBank
    from repro_torch.core.simulate import run_lasana
    cfg = TestbenchConfig(n_runs=40, n_steps=30, seed=0)
    trace = simulate_golden("lif", *generate_testbench("lif", cfg, "cpu"))
    tr, te, va = split_runwise(extract_events(trace), cfg.n_runs, seed=0)
    bank = PredictorBank("lif", families=("mean", "linear"),
                         device="cpu").fit(CircuitDataset(
                             "lif", tr, te, va, 0.0, cfg.n_runs))
    stim = _stimulus("lif")
    a = run_lasana(bank, "lif", *stim, device="cpu")
    b = run_lasana(bank.to_surrogate(), "lif", *stim, device="cpu")
    np.testing.assert_array_equal(a.outputs, b.outputs)
    np.testing.assert_array_equal(a.energy, b.energy)


# --- the deprecation shims ------------------------------------------------------

def test_drive_to_circuit_inputs_equals_reference():
    from repro.core.simulate import drive_to_circuit_inputs as ref
    from repro_torch.core.simulate import drive_to_circuit_inputs
    drive = np.random.default_rng(2).normal(0, 1, (5, 7)).astype(np.float32)
    np.testing.assert_array_equal(drive_to_circuit_inputs(drive).numpy(),
                                  np.asarray(ref(drive)))


def test_snn_shims_equal_simulate_and_warn():
    import repro_torch.lasana as lasana
    from repro_torch.core.network import snn_spec
    from repro_torch.core.simulate import run_snn_golden, run_snn_lasana
    ws, knobs, x = fx.small_net(seed=4, t_steps=12, batch=2)
    sur = _surrogates("lif_packable")[1]
    spec = snn_spec(ws, knobs)
    with pytest.deprecated_call():
        counts, energy = run_snn_lasana(sur, ws, x, knobs, device="cpu")
    run = lasana.simulate(spec, x, surrogates=sur, record_hidden=False,
                          device="cpu")
    np.testing.assert_array_equal(counts, run.outputs)
    assert energy == run.energy.sum() + run.flush_energy.sum()
    with pytest.deprecated_call():
        counts, energy = run_snn_golden("lif", ws, x, knobs, device="cpu")
    run = lasana.simulate(spec, x, backend="golden", record_hidden=False,
                          device="cpu")
    np.testing.assert_array_equal(counts, run.outputs)
    assert energy == run.energy.sum()


# --- the committed layer record -----------------------------------------------------

@functools.cache
def _record():
    with np.load(fx.LAYER_RECORD) as z:
        return {k: z[k] for k in z.files}


def test_layer_record_loads_at_the_chip_shapes():
    """The JAX record of the quickstart's layers: LIF N = 1,000 x T = 100
    (seed 123) and crossbar N = 128 x T = 30 (seed 1), every run the chip
    phase reads, the stimulus following make_stimulus's rules."""
    rec = _record()
    for kind, (n, t_steps, _), runs, n_in in (
            ("lif", fx.LAYER_LIF, fx.LAYER_LIF_RUNS, 3),
            ("xbar", fx.LAYER_XBAR, fx.LAYER_XBAR_RUNS, 32)):
        active, x, params = fx.layer_stimulus(rec, kind)
        assert active.shape == (t_steps, n) and active[0].all()
        assert x.shape == (t_steps, n, n_in) and x.dtype == np.float32
        idle = ~active
        if kind == "lif":
            assert params.shape == (n, 4) and (x[idle] == 0).all()
        else:
            assert params.shape == (n, 33)
            assert (x[1:][idle[1:]] == x[:-1][idle[1:]]).all()
        for name in runs:
            if kind == "xbar":
                for f in ("outputs", "states", "energy", "latency"):
                    a = rec[f"xbar/{name}/{f}"]
                    assert a.shape == (t_steps, n) and np.isfinite(a).all()
                continue
            spikes = np.unpackbits(rec[f"lif/{name}/spikes"], axis=-1,
                                   count=n)
            assert spikes.shape == (t_steps, n)
            for f in ("states", "energy", "latency"):
                assert rec[f"lif/{name}/{f}_by_neuron"].shape == (n,)
                assert rec[f"lif/{name}/{f}_by_tick"].shape == (t_steps,)
                assert rec[f"lif/{name}/sub/{f}"].shape == (t_steps,
                                                            fx.LAYER_SUB)
    golden = np.unpackbits(rec["lif/golden/spikes"], axis=-1)
    assert 0.005 < golden.mean() < 0.5
    assert rec["lif/behavioral/energy_by_neuron"].sum() == 0.0


@pytest.mark.parametrize("kind", ["lif", "xbar"])
def test_layer_record_reruns_in_the_port(kind):
    """Every run of the record in the port on the CPU: the LIF runs on the
    record's first 64 neurons (each neuron runs alone), the crossbar runs
    whole; spikes identical, continuous records within rtol 1e-5."""
    import repro_torch.lasana as lasana
    from repro_torch.core import simulate
    rec = _record()
    active, x, params = fx.layer_stimulus(rec, kind)
    circuit = "lif" if kind == "lif" else "crossbar"
    runs = fx.LAYER_LIF_RUNS if kind == "lif" else fx.LAYER_XBAR_RUNS
    k = fx.LAYER_SUB if kind == "lif" else active.shape[1]
    active, x, params = active[:, :k], x[:, :k], params[:k]
    golden = simulate.run_golden(circuit, active, x, params, device="cpu")
    beh = simulate.run_behavioral(circuit, active, x, params, device="cpu")
    for name, (path, mode) in runs.items():
        if mode == "golden":
            run = golden
        elif mode == "behavioral":
            run = beh
        else:
            kw = {"p": {}, "o": {"oracle_states": golden.states},
                  "annotate": {"oracle_states": beh.states,
                               "annotate_outputs": beh.outputs}}[mode]
            run = simulate.run_lasana(lasana.load(str(path), device="cpu"),
                                      circuit, active, x, params,
                                      device="cpu", **kw)
        if kind == "xbar":
            for f in ("outputs", "states", "energy", "latency"):
                assert_close(getattr(run, f), rec[f"xbar/{name}/{f}"],
                             f"{name} {f}")
            continue
        want = np.unpackbits(rec[f"lif/{name}/spikes"], axis=-1)[:, :k]
        np.testing.assert_array_equal(run.outputs > 0.75, want.astype(bool),
                                      err_msg=name)
        for f in ("states", "energy", "latency"):
            head = f == "states" and mode in ("p", "o")
            assert_close(getattr(run, f), rec[f"lif/{name}/sub/{f}"],
                         f"{name} {f}", atol_scale=HEAD_ATOL if head
                         else 1e-6)
