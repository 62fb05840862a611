"""The training pipeline's data stages against the reference: the
testbench's hold rule, the golden simulation of all runs, and event
extraction and the run-wise split.

``jax.random`` cannot be replayed in torch, so the testbench is compared
through :func:`hold_inputs` fed the reference's own fresh draws (the same
key splits as ``repro.core.dataset.generate_testbench``), and the golden
simulation and event extraction run on the reference's arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from test_torch_fixtures import assert_close  # noqa: E402

N_RUNS, N_STEPS = 24, 40


def _ref_testbench(circuit, seed, n_runs=N_RUNS, n_steps=N_STEPS, alpha=0.8):
    """The reference's testbench and the fresh draws behind it."""
    from repro.core.circuits import get_circuit
    from repro.core.dataset import TestbenchConfig, generate_testbench
    circ = get_circuit(circuit)
    cfg = TestbenchConfig(n_runs=n_runs, n_steps=n_steps, alpha=alpha,
                          seed=seed)
    active, inputs, params = generate_testbench(circ, cfg)
    # dataset.py:36-41: the same key splits
    _, k_in, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    fresh = circ.sample_inputs(k_in, (n_runs, n_steps))
    return (np.array(active), np.array(fresh), np.array(inputs),
            np.array(params))


@pytest.mark.parametrize("circuit", ["lif", "crossbar"])
@pytest.mark.parametrize("seed", [0, 3])
def test_hold_inputs_equals_reference_testbench(circuit, seed):
    from repro_torch.core.dataset import hold_inputs
    active, fresh, inputs, _ = _ref_testbench(circuit, seed)
    got = hold_inputs(torch.as_tensor(active), torch.as_tensor(fresh),
                      circuit == "lif")
    np.testing.assert_array_equal(got.numpy(), inputs)


def test_hold_inputs_holds_step_zero_before_any_active_step():
    """Crossbar rows idle from step 0 hold step 0's draw (the reference's
    scan starts from ``fresh[:, 0]``); LIF rows idle get zeros."""
    from repro_torch.core.dataset import hold_inputs
    active = torch.tensor([[False, False, True, False]])
    fresh = torch.arange(4, dtype=torch.float32).reshape(1, 4, 1) + 1
    held = hold_inputs(active, fresh, False)[0, :, 0].tolist()
    zeroed = hold_inputs(active, fresh, True)[0, :, 0].tolist()
    assert held == [1.0, 1.0, 3.0, 3.0]
    assert zeroed == [0.0, 0.0, 3.0, 0.0]


@pytest.mark.parametrize("circuit", ["lif", "crossbar"])
def test_generate_testbench_distribution(circuit):
    """The port's own draws: shapes, the first step active, the active
    share near alpha, LIF idle inputs zero, crossbar idle inputs held,
    params in range."""
    from repro_torch.core.circuits import get_circuit
    from repro_torch.core.dataset import TestbenchConfig, generate_testbench
    cfg = TestbenchConfig(n_runs=200, n_steps=50, alpha=0.8, seed=1)
    circ = get_circuit(circuit)
    active, inputs, params = generate_testbench(circ, cfg, device="cpu")
    assert active.shape == (200, 50) and active[:, 0].all()
    assert inputs.shape == (200, 50, circ.n_inputs)
    assert params.shape == (200, circ.n_params)
    assert abs(float(active[:, 1:].float().mean()) - 0.8) < 0.02
    idle = ~active
    if circuit == "lif":
        assert (inputs[idle] == 0).all()
        assert float(params.min()) >= 0.5 and float(params.max()) <= 0.8
        # 30% aggregated drives (x = V_dd, n = 5)
        act = inputs[active]
        agg = (act[:, 1] == 1.5) & (act[:, 2] == 5.0)
        assert 0.25 < float(agg.float().mean()) < 0.36
    else:
        prev = inputs[:, :-1]
        assert torch.equal(inputs[:, 1:][idle[:, 1:]], prev[idle[:, 1:]])
        assert set(params.unique().tolist()) == {-1.0, 0.0, 1.0}
        assert float(inputs.abs().max()) <= np.float32(0.8)


def test_generate_testbench_needs_a_card_unless_asked_for_the_cpu():
    from repro_torch.core.dataset import TestbenchConfig, generate_testbench
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_testbench("lif", TestbenchConfig(n_runs=2, n_steps=3))


def _ref_trace(circuit, seed):
    from repro.core.circuits import get_circuit
    from repro.core.dataset import simulate_golden
    active, _, inputs, params = _ref_testbench(circuit, seed)
    return simulate_golden(get_circuit(circuit), active, inputs, params)


@pytest.mark.parametrize("circuit", ["lif", "crossbar"])
def test_simulate_golden_matches_reference(circuit):
    """The port's golden simulation on the reference's arrays: spikes and
    out_changed identical (a crossbar flip only within 1e-5 of its 0.02
    threshold), state / output / energy within rtol 1e-5, latency equal
    to rtol 1e-5 where the step's spike agrees."""
    from repro_torch.core.dataset import simulate_golden
    want = _ref_trace(circuit, seed=2)
    got = simulate_golden(circuit, want.active, want.inputs, want.params,
                          device="cpu")
    for f in ("active", "inputs", "params"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.clock_ns == want.clock_ns
    assert got.idle_x_is_zero == want.idle_x_is_zero
    for f, dtype in (("state", np.float32), ("output", np.float32),
                     ("energy", np.float64), ("latency", np.float32),
                     ("out_changed", bool)):
        assert getattr(got, f).dtype == dtype
        assert getattr(got, f).shape == getattr(want, f).shape
    flip = got.out_changed != want.out_changed
    if flip.any():
        assert circuit == "crossbar"
        step = np.abs(want.output[:, 1:] - want.output[:, :-1])
        assert (np.abs(step[flip] - 0.02) <= 1e-5).all()
    assert want.out_changed.any() and not want.out_changed.all()
    assert_close(got.state, want.state, "state")
    assert_close(got.output, want.output, "output")
    assert_close(got.energy, want.energy, "energy")
    same = ~flip
    assert_close(got.latency[same], want.latency[same], "latency")


def test_simulate_golden_state_is_the_chained_steps_v_mem():
    """LIF's exposed state at every step boundary is V_mem of the
    chained period, as the reference records it (``states[..., 0]``)."""
    from repro_torch.core.circuits import LIFNeuron
    from repro_torch.core.dataset import simulate_golden
    from repro_torch.kernels import lif_scan
    trace = _ref_trace("lif", seed=4)
    got = simulate_golden("lif", trace.active, trace.inputs, trace.params,
                          device="cpu")
    state = torch.zeros((N_RUNS, 3))
    p = torch.as_tensor(trace.params)
    for t in range(N_STEPS):
        state, *_ = lif_scan._period_math(
            LIFNeuron(), state, torch.as_tensor(trace.inputs[:, t]), p)
        np.testing.assert_array_equal(got.state[:, t + 1], state[:, 0].numpy())
    np.testing.assert_array_equal(got.state[:, 0], 0.0)


def _event_sets_equal(got, want):
    from repro_torch.core.events import EventSet
    for f in dataclasses.fields(EventSet):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def _port_trace(ref):
    from repro_torch.core.events import Trace
    return Trace(**{f.name: getattr(ref, f.name)
                    for f in dataclasses.fields(ref)})


@pytest.mark.parametrize("circuit", ["lif", "crossbar"])
def test_extract_events_and_split_equal_reference(circuit):
    from repro.core import events as ref_events
    from repro_torch.core import events
    trace = _ref_trace(circuit, seed=5)
    want = ref_events.extract_events(trace)
    got = events.extract_events(_port_trace(trace))
    _event_sets_equal(got, want)
    for g, w in zip(events.split_runwise(got, N_RUNS, seed=7),
                    ref_events.split_runwise(want, N_RUNS, seed=7)):
        _event_sets_equal(g, w)


def _hand_trace(active, out_changed=None, n_in=3, n_p=4, clock_ns=5.0):
    """A Trace with unit per-step energy, as tests/test_events.py builds."""
    from repro.core.events import Trace
    r, t = active.shape
    rng = np.random.default_rng(0)
    return Trace(
        active=active, inputs=rng.uniform(0, 1, (r, t, n_in)).astype(
            np.float32),
        state=rng.uniform(0, 1, (r, t + 1)).astype(np.float32),
        output=rng.uniform(0, 1, (r, t + 1)).astype(np.float32),
        energy=np.full((r, t), 1e-12), latency=np.full((r, t), clock_ns,
                                                       np.float32),
        out_changed=np.zeros((r, t), bool) if out_changed is None
        else np.asarray(out_changed, bool),
        params=rng.uniform(0, 1, (r, n_p)).astype(np.float32),
        clock_ns=clock_ns, idle_x_is_zero=True)


def _edge_active(case):
    if case == "all_idle":
        return np.zeros((3, 12), bool)
    if case == "one_step":
        return np.array([[True]])
    if case == "one_idle_step":
        return np.array([[False]])
    a = np.zeros((1, 10), bool)
    if case == "leading_idle":
        a[0, 4] = True
    elif case == "trailing_idle":
        a[0, 2] = True
    elif case == "long_gap":
        a[0, 0] = a[0, 9] = True
    elif case == "back_to_back":
        a = np.ones((2, 6), bool)
    return a


@pytest.mark.parametrize("case", ["all_idle", "one_step", "one_idle_step",
                                  "leading_idle", "trailing_idle",
                                  "long_gap", "back_to_back"])
@pytest.mark.parametrize("idle_zero", [True, False])
def test_extract_events_edge_cases_equal_reference(case, idle_zero):
    from repro.core import events as ref_events
    from repro_torch.core import events
    active = _edge_active(case)
    trace = dataclasses.replace(_hand_trace(
        active, out_changed=np.random.default_rng(1).random(active.shape)
        < 0.5), idle_x_is_zero=idle_zero)
    _event_sets_equal(events.extract_events(_port_trace(trace)),
                      ref_events.extract_events(trace))
