"""Event-driven simulation of single circuit banks (layer-level runners).

Port of ``repro.core.simulate``: three simulation backends over identical
stimuli (the paper's comparison set), unified at network level by
:func:`repro_torch.lasana.simulate`:

  golden      — sub-step ODE integration (the SPICE stand-in): one
                ``lif_chunk`` launch for all T ticks of a LIF bank, one
                fused ``crossbar_step`` launch a tick for crossbar rows
  behavioral  — SV-RNM-style ideal discrete update (plain PyTorch for LIF,
                ``crossbar_target`` for crossbar rows; no energy/latency)
  lasana      — Algorithm 1 over a trained :class:`Surrogate`; standalone
                or annotation mode, LASANA-P (predicted state feedback) or
                LASANA-O (oracle state from golden, for Table III); a
                packable surrogate runs one ``network_tick`` launch a tick
                from a pack built once per run

Every runner enqueues its T ticks into preallocated (T, N) device tensors
with no host synchronisation inside the loop and fetches the records once
at the end. ``LayerRun.wall_seconds`` is a run between two device
synchronisations that builds no kernel and no pack; the head pack's
construction and, where a call built a kernel, the first run's excess go
into ``compile_seconds`` (the call then runs again and reports that run,
as the reference's ``_timed_cached`` does).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.circuits import LIFNeuron, get_circuit
from repro_torch.core.dataset import hold_inputs
from repro_torch.core.surrogate import as_surrogate
from repro_torch.core.wrapper import init_state, lasana_step
from repro_torch.kernels import _build, ops


@dataclasses.dataclass
class LayerRun:
    """Per-tick record of one simulated bank of N circuits."""

    outputs: np.ndarray    # (T, N)
    states: np.ndarray     # (T, N)
    energy: np.ndarray     # (T, N) joules
    latency: np.ndarray    # (T, N) ns (0 when no output event)
    wall_seconds: float    # steady-state execution time (build excluded)
    compile_seconds: float = 0.0   # kernel builds + head pack (0 when warm)


def make_stimulus(circuit, n: int, t_steps: int, *, alpha=0.8, seed=0,
                  device=None):
    """Random per-tick stimulus on ``device`` (default ``cuda``):
    ``(active (T, N) bool, x (T, N, n_in), params (N, n_p))``.

    Drawn from a ``torch.Generator`` seeded with ``seed`` (the reference's
    distributions; ``jax.random`` streams cannot be replayed). Tick 0 is
    active; a LIF neuron gets zero drive on idle ticks, a crossbar row
    holds its last active tick's voltages."""
    circuit = get_circuit(circuit)
    dev = ops.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    active = torch.rand((t_steps, n), generator=gen, device=dev) < alpha
    active[0] = True
    fresh = circuit.sample_inputs(gen, (t_steps, n), dev)
    params = circuit.sample_params(gen, n, dev)
    return active, _held(circuit, active, fresh), params


def _held(circuit, active, fresh):
    """The inputs each tick applies, (T, N, n_in), from the fresh draws:
    ``dataset.hold_inputs``'s rule (LIF zeros on idle ticks, crossbar rows
    hold the last active tick's voltages), which works on (runs, steps,
    n_in) — here a run is a circuit."""
    x = hold_inputs(active.T, fresh.transpose(0, 1),
                    isinstance(circuit, LIFNeuron))
    return x.transpose(0, 1).contiguous()


def _tensors(device, *arrays):
    """``arrays`` as tensors on the run's device: ``device`` if given, else
    the first tensor's own, else ``cuda``."""
    if device is None:
        device = next((a.device for a in arrays
                       if isinstance(a, torch.Tensor)), None)
    dev = ops.resolve_device(device)
    return dev, [torch.as_tensor(a if isinstance(a, torch.Tensor)
                                 else np.array(a), device=dev)
                 for a in arrays]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """``fn()`` between two device synchronisations: ``(records,
    compile_s, wall_s)``. A call that built a kernel is run again and
    reports that second run; the first run's excess is compile time."""
    n_built = _build.n_loaded()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    first = time.perf_counter() - t0
    if _build.n_loaded() == n_built:
        return out, 0.0, first
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    return out, max(first - wall, 0.0), wall


def _host(*tensors):
    """One fetch of the (T, N) device records."""
    return [t.cpu().numpy() for t in tensors]


def _records(t_steps, n, dev, k=4):
    return [torch.empty((t_steps, n), dtype=torch.float32, device=dev)
            for _ in range(k)]


# --- golden -------------------------------------------------------------------

def run_golden(circuit, active, x, params, *, device=None) -> LayerRun:
    """Golden transient simulation of N circuits over T ticks. ``active``
    is unused: ``x`` already carries the idle ticks' inputs."""
    circuit = get_circuit(circuit)
    dev, (x, params) = _tensors(device, x, params)
    x = x.float().contiguous()
    params = params.float().contiguous()
    t_steps, n = x.shape[:2]

    if isinstance(circuit, LIFNeuron):
        def sim():
            _, obs = ops.lif_chunk(circuit.init_state(n, device=dev), x,
                                   params, circ=circuit, record_v=True)
            lat = torch.where(obs["spiked"], obs["latency"], 0.0)
            return obs["output"], obs["v_seq"], obs["energy"], lat
    else:
        def sim():
            outs, states, energy, lat = _records(t_steps, n, dev)
            state = circuit.init_state(n, device=dev)
            for t in range(t_steps):
                state, obs = ops.crossbar_step(state, x[t], params,
                                               circ=circuit)
                outs[t] = obs["output"]
                states[t] = state[:, 0]
                energy[t] = obs["energy"]
                lat[t] = torch.where(obs["spiked"], obs["latency"], 0.0)
            return outs, states, energy, lat

    out, compile_s, wall = _timed(dev, sim)
    outputs, states, energy, latency = _host(*out)
    return LayerRun(outputs=outputs, states=states, energy=energy,
                    latency=latency, wall_seconds=wall,
                    compile_seconds=compile_s)


# --- behavioral (SV-RNM stand-in) ------------------------------------------------

def run_behavioral(circuit, active, x, params, *, device=None) -> LayerRun:
    """Ideal discrete update; no energy/latency (requires ML annotation)."""
    circuit = get_circuit(circuit)
    dev, (active, x, params) = _tensors(device, active, x, params)
    active = active.bool()
    x = x.float().contiguous()
    params = params.float().contiguous()
    t_steps, n = x.shape[:2]
    is_lif = isinstance(circuit, LIFNeuron)

    def sim():
        outs, states = _records(t_steps, n, dev, 2)
        v = x.new_zeros((n,))
        for t in range(t_steps):
            xi = x[t]
            if is_lif:                  # no drive on idle ticks, leak stays
                xi = torch.where(active[t][:, None], xi, 0.0)
            v, out = circuit.behavioral_step(v, xi, params)
            outs[t] = out
            states[t] = v
        return outs, states

    out, compile_s, wall = _timed(dev, sim)
    outs, states = _host(*out)
    z = np.zeros_like(outs)
    return LayerRun(outputs=outs, states=states, energy=z, latency=z,
                    wall_seconds=wall, compile_seconds=compile_s)


# --- LASANA -----------------------------------------------------------------------

def run_lasana(surrogate, circuit, active, x, params, *,
               oracle_states: Optional[np.ndarray] = None,
               annotate_outputs: Optional[np.ndarray] = None,
               fused: bool = True,
               fused_kernel: Optional[bool] = None,
               device=None) -> LayerRun:
    """Algorithm 1 over T ticks.

    surrogate        — a trained :class:`Surrogate` (legacy ``PredictorBank``
                       values are frozen with ``Surrogate.from_bank``); it
                       runs on the run's device
    oracle_states    — LASANA-O (Table III): feed golden state as v' each tick
    annotate_outputs — annotation mode: a behavioral model supplies outputs,
                       LASANA adds energy/latency estimates. The matching
                       behavioral states MUST be passed via
                       ``oracle_states`` (running it at v=0 would silently
                       corrupt the energy/latency features, so that is an
                       error).
    fused            — fused ``predict_heads`` tick body (default) vs the
                       per-``predict``-call baseline (A/B benchmarks).
    fused_kernel     — tri-state fused-kernel override, resolved once
                       through ``kernels.ops.fused_kernel_enabled``; when
                       on, a packable surrogate's tick is one
                       ``network_tick`` launch (the pack is built once per
                       call), other stacked MLP heads launch
                       ``mlp_surrogate_heads``.
    device           — default: the inputs' device if they are tensors,
                       else ``cuda``
    """
    sim, dev, pack_s = _lasana_program(
        surrogate, circuit, active, x, params, oracle_states=oracle_states,
        annotate_outputs=annotate_outputs, fused=fused,
        fused_kernel=fused_kernel, device=device)
    out, compile_s, wall = _timed(dev, sim)
    outs, states, energy, latency = _host(*out)
    return LayerRun(outputs=outs, states=states, energy=energy,
                    latency=latency, wall_seconds=wall,
                    compile_seconds=compile_s + pack_s)


def _lasana_program(surrogate, circuit, active, x, params, *, oracle_states,
                    annotate_outputs, fused, fused_kernel, device):
    """:func:`run_lasana`'s inputs on the device, its head pack built, and
    ``sim``: a call that enqueues the T ticks — no host synchronisation
    inside — and returns the (T, N) device records. Returns ``(sim,
    device, seconds spent packing)``."""
    if annotate_outputs is not None and oracle_states is None:
        raise ValueError(
            "annotate_outputs requires the behavioral states as "
            "oracle_states= (annotation mode predicts energy/latency at "
            "the externally supplied state, not at v=0)")
    circuit = get_circuit(circuit)
    dev, (active, x, params) = _tensors(device, active, x, params)
    active = active.bool()
    x = x.float().contiguous()
    params = params.float().contiguous()
    sur = as_surrogate(surrogate).to(dev)
    t_steps, n = active.shape
    spiking = isinstance(circuit, LIFNeuron)
    clock = circuit.clock_ns
    vdd = float(getattr(circuit, "vdd", 1.5))
    times = (torch.arange(t_steps, dtype=torch.float32, device=dev)
             + 1.0) * clock

    oracle = oracle_states is not None
    annotate = annotate_outputs is not None
    if oracle:
        # state BEFORE tick t = golden state at boundary t (prepend 0)
        v_oracle = torch.as_tensor(np.concatenate(
            [np.zeros((1, n), np.float32),
             np.asarray(oracle_states, np.float32)[:-1]], axis=0),
            device=dev)
    known = (torch.as_tensor(np.array(annotate_outputs, np.float32),
                             device=dev) if annotate else None)

    fused_kernel = ops.fused_kernel_enabled(fused_kernel)
    t0 = time.perf_counter()
    pack = layout = None
    if fused and fused_kernel:
        from repro_torch.kernels import tick_megakernel as mk
        pack, layout = mk.pack_heads(sur)
    _sync(dev)
    pack_s = time.perf_counter() - t0

    def sim():
        outs, states, energy, latency = _records(t_steps, n, dev)
        state = init_state(n, params)
        for t in range(t_steps):
            if oracle:
                state = state._replace(v=v_oracle[t])
            k_o = known[t] if annotate else None
            new_state, e, l, o = lasana_step(
                sur, state, active[t], x[t], times[t], clock,
                spiking=spiking, vdd=vdd, known_out=k_o, fused=fused,
                fused_kernel=fused_kernel, megakernel_pack=pack,
                megakernel_layout=layout)
            if annotate:
                # the behavioral model owns outputs AND state; LASANA only
                # annotates energy/latency
                new_state = new_state._replace(o=k_o)
                o = k_o
            outs[t] = o
            states[t] = new_state.v
            energy[t] = e
            latency[t] = l
            state = new_state
        return outs, states, energy, latency

    return sim, dev, pack_s




# --- SNN network (deprecation shims over the repro_torch.lasana facade) -------

def drive_to_circuit_inputs(drive, *, spike_amp: float = 1.5,
                            n_spk: float = 5.0):
    """Aggregate synaptic drive -> (w, x, n) circuit inputs."""
    from repro_torch.core.network import drive_to_circuit_inputs as _impl
    return _impl(torch.as_tensor(drive, dtype=torch.float32),
                 spike_amp=spike_amp, n_spk=n_spk)


def run_snn_lasana(surrogate, weights: list, spike_seq, params_per_layer, *,
                   clock_ns=5.0, mode="standalone", edges=(), device=None):
    """Deprecated shim: feed-forward SNN via ``repro_torch.lasana.simulate``.

    weights[i]: (n_in_i, n_out_i); ``edges`` are optional one-tick-delayed
    recurrent connections (network.EdgeSpec / network.recurrent_edge).
    Returns (spike counts (B, n_cls), total energy incl. the end-of-run
    idle flush). Prefer ``repro_torch.lasana.simulate`` for new code.
    """
    import warnings

    import repro_torch.lasana as lasana
    from repro_torch.core.network import snn_spec
    warnings.warn("run_snn_lasana is deprecated; use repro_torch.lasana."
                  "simulate(snn_spec(...), x, surrogates=...)",
                  DeprecationWarning, stacklevel=2)
    spec = snn_spec(weights, params_per_layer, edges=edges)
    run = lasana.simulate(spec, spike_seq, backend="lasana", mode=mode,
                          surrogates=as_surrogate(surrogate),
                          record_hidden=False, device=device)
    return run.outputs, run.energy.sum() + run.flush_energy.sum()


def run_snn_golden(circuit, weights: list, spike_seq, params_per_layer, *,
                   edges=(), device=None):
    """Deprecated shim: same network through the golden integrator.

    Prefer ``repro_torch.lasana.simulate(spec, x, backend="golden")``."""
    import warnings

    import repro_torch.lasana as lasana
    from repro_torch.core.network import snn_spec
    warnings.warn("run_snn_golden is deprecated; use repro_torch.lasana."
                  "simulate(snn_spec(...), x, backend='golden')",
                  DeprecationWarning, stacklevel=2)
    spec = snn_spec(weights, params_per_layer, edges=edges)
    run = lasana.simulate(spec, spike_seq, backend="golden",
                          record_hidden=False, device=device)
    return run.outputs, run.energy.sum()
