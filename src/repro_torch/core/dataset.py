"""Automated dataset generation (paper §IV-A): randomized testbenches ->
golden transient simulation -> event processing -> circuit dataset.

Port of ``repro.core.dataset``. The testbench is drawn on the device from
a ``torch.Generator`` seeded with ``TestbenchConfig.seed`` (the same
mixtures as the reference, equal in distribution only: ``jax.random``
streams cannot be replayed); :func:`hold_inputs` applies the reference's
hold rule, so the reference's own fresh draws give its inputs bit for
bit. The golden simulation of all runs is one ``lif_chunk`` launch over
(T, runs) for LIF, recording each tick's V_mem, and T ``crossbar_step``
launches for crossbar rows; the records are fetched to the host once, as
the same :class:`~repro_torch.core.events.Trace` the reference builds.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.circuits import LIFNeuron, get_circuit
from repro_torch.core.events import (EventKind, EventSet, Trace,
                                     extract_events, split_runwise)
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class TestbenchConfig:
    n_runs: int = 1000
    n_steps: int = 125              # 500 ns at 250 MHz
    alpha: float = 0.8              # P(timestep is active)
    seed: int = 0


def hold_inputs(active, fresh, is_lif: bool):
    """The inputs each step applies, (R, T, n_in), from the fresh draws
    ``fresh`` (R, T, n_in) and the active mask ``active`` (R, T): an active
    step takes its fresh draw; an idle one applies zeros (LIF: no spikes)
    or holds the last active step's draw (crossbar voltages; before any
    active step, step 0's draw)."""
    if is_lif:
        return torch.where(active[..., None], fresh, torch.zeros_like(fresh))
    t = torch.arange(active.shape[1], device=active.device)
    last = torch.where(active, t, torch.zeros_like(t)).cummax(dim=1).values
    return torch.gather(fresh, 1, last[..., None].expand_as(fresh))


def generate_testbench(circuit, cfg: TestbenchConfig, device=None):
    """Random inputs and params for all runs, on ``device`` (default
    ``cuda``). Returns ``(active (R, T) bool, inputs (R, T, n_in), params
    (R, n_p))``; the first step of every run is active."""
    circuit = get_circuit(circuit)
    dev = ops.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    active = torch.rand((cfg.n_runs, cfg.n_steps), generator=gen,
                        device=dev) < cfg.alpha
    active[:, 0] = True                           # first step always drives
    fresh = circuit.sample_inputs(gen, (cfg.n_runs, cfg.n_steps), dev)
    params = circuit.sample_params(gen, cfg.n_runs, dev)
    is_lif = isinstance(circuit, LIFNeuron)
    return active, hold_inputs(active, fresh, is_lif), params


def simulate_golden(circuit, active, inputs, params, device=None):
    """Golden transient simulation of all runs. Returns the host-side
    :class:`Trace`.

    ``active`` (R, T), ``inputs`` (R, T, n_in) and ``params`` (R, n_p) are
    arrays or tensors; they run on ``device`` (default: the tensors' own,
    else ``cuda``). The inputs are transposed once on the device to the
    kernels' (T, R, n_in); nothing is fetched until the last tick."""
    circuit = get_circuit(circuit)
    if device is None and isinstance(inputs, torch.Tensor):
        device = inputs.device
    dev = ops.resolve_device(device)
    x = torch.as_tensor(inputs, dtype=torch.float32, device=dev)
    p = torch.as_tensor(params, dtype=torch.float32, device=dev).contiguous()
    n_runs = x.shape[0]
    x_seq = x.transpose(0, 1).contiguous()              # (T, R, n_in)
    state = circuit.init_state(n_runs, device=dev)
    if isinstance(circuit, LIFNeuron):
        _, obs = ops.lif_chunk(state, x_seq, p, circ=circuit, record_v=True)
        v_seq = obs["v_seq"]
    else:
        cols = []
        for x_t in x_seq:
            state, o = ops.crossbar_step(state, x_t, p, circ=circuit)
            cols.append(o)
        obs = {k: torch.stack([o[k] for o in cols]) if cols
               else x_seq.new_zeros((0, n_runs))
               for k in ("output", "energy", "latency")}
        v_seq = obs["output"]              # the row's state is its output
    # exposed state and output at step boundaries, t = 0 included
    zero = np.zeros((1, n_runs), np.float32)
    st = np.concatenate([zero, v_seq.cpu().numpy()], axis=0).T
    out = np.concatenate([zero, obs["output"].cpu().numpy()], axis=0).T
    energy = obs["energy"].cpu().numpy().T                # (R, T)
    latency = obs["latency"].cpu().numpy().T

    if isinstance(circuit, LIFNeuron):
        out_changed = obs["spiked"].cpu().numpy().T
    else:
        out_changed = np.abs(out[:, 1:] - out[:, :-1]) > 0.02

    def host(a, dtype):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        return np.asarray(a, dtype)

    return Trace(
        active=host(active, bool),
        inputs=host(inputs, np.float32),
        state=st.astype(np.float32),
        output=out.astype(np.float32),
        energy=energy.astype(np.float64),
        latency=latency.astype(np.float32),
        out_changed=np.asarray(out_changed, bool),
        params=host(params, np.float32),
        clock_ns=circuit.clock_ns,
        idle_x_is_zero=isinstance(circuit, LIFNeuron),
    )


@dataclasses.dataclass
class CircuitDataset:
    circuit_name: str
    train: EventSet
    test: EventSet
    val: EventSet
    gen_seconds: float
    n_runs: int

    def counts(self) -> dict:
        full = EventSet.concat([self.train, self.test, self.val])
        return {k.name: int(np.sum(full.kind == int(k))) for k in EventKind}


def build_dataset(circuit_name: str, cfg: TestbenchConfig | None = None,
                  circuit=None, device=None) -> CircuitDataset:
    """End-to-end §IV-A flow: testbench -> golden sim -> events -> split,
    on ``device`` (default ``cuda``)."""
    circuit = get_circuit(circuit or circuit_name)
    if cfg is None:
        cfg = TestbenchConfig(
            n_runs=1000 if circuit_name == "crossbar" else 2000)
    t0 = time.time()
    active, inputs, params = generate_testbench(circuit, cfg, device)
    trace = simulate_golden(circuit, active, inputs, params)
    events = extract_events(trace)
    train, test, val = split_runwise(events, cfg.n_runs, seed=cfg.seed)
    return CircuitDataset(circuit_name=circuit_name, train=train, test=test,
                          val=val, gen_seconds=time.time() - t0,
                          n_runs=cfg.n_runs)
