"""Event processing: split transient traces into E1/E2/E3 events (paper §IV-A3).

The port's own copy of ``repro.core.events`` (pure numpy, the same code):
the same ``Trace`` gives the same ``EventSet``, bit for bit.

  E1 — one timestep, input changed, output changed  (dynamic energy, latency)
  E3 — one timestep, input changed, output did NOT change (static energy)
  E2 — variable-length idle period before an active timestep (static
       energy), including the idle span before a run's FIRST active step
       (start boundary = the run's initial state/output)

Events start and end on timestep boundaries; energy is integrated over
the event, and event-set energy sums to the trace energy over [0, last
active step]. :func:`extract_events` builds the flat struct-of-arrays
:class:`EventSet`; :func:`split_runwise` is the paper's run-wise
70/15/15 train/test/val split.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class EventKind(enum.IntEnum):
    E1 = 1
    E2 = 2
    E3 = 3


@dataclasses.dataclass
class EventSet:
    """Flat struct-of-arrays event table (one per event kind is sliceable)."""

    kind: np.ndarray        # (M,) EventKind
    x: np.ndarray           # (M, n_inputs) inputs during the event (0 if none)
    v_start: np.ndarray     # (M,) exposed state at event start
    v_end: np.ndarray       # (M,)
    o_prev: np.ndarray      # (M,) output before the event
    o_end: np.ndarray       # (M,) output at event end
    tau: np.ndarray         # (M,) event length (ns)
    params: np.ndarray      # (M, n_params)
    energy: np.ndarray      # (M,) joules over the event
    latency: np.ndarray     # (M,) ns (E1 only; else clock period)
    run_id: np.ndarray      # (M,) originating run (for run-wise splits)

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    def select(self, mask: np.ndarray) -> "EventSet":
        return EventSet(**{f.name: getattr(self, f.name)[mask]
                           for f in dataclasses.fields(self)})

    def of_kind(self, *kinds: EventKind) -> "EventSet":
        mask = np.isin(self.kind, [int(k) for k in kinds])
        return self.select(mask)

    @staticmethod
    def concat(sets: list["EventSet"]) -> "EventSet":
        return EventSet(**{
            f.name: np.concatenate([getattr(s, f.name) for s in sets])
            for f in dataclasses.fields(EventSet)})


@dataclasses.dataclass
class Trace:
    """(R runs, T timesteps) golden-simulation record."""

    active: np.ndarray      # (R,T) bool: input changed at t
    inputs: np.ndarray      # (R,T,n_in) input applied during step t
    state: np.ndarray       # (R,T+1) exposed state at step boundaries
    output: np.ndarray      # (R,T+1) output at step boundaries
    energy: np.ndarray      # (R,T) energy in step t
    latency: np.ndarray     # (R,T) 90%-settle / spike latency in step t
    out_changed: np.ndarray # (R,T) bool
    params: np.ndarray      # (R,n_p)
    clock_ns: float
    idle_x_is_zero: bool    # LIF: no input between spikes; crossbar: held


def extract_events(trace: Trace) -> EventSet:
    r, t = trace.active.shape
    kinds, xs, v0s, v1s, ops, oes, taus, ps, es, ls, rids = (
        [], [], [], [], [], [], [], [], [], [], [])
    ck = trace.clock_ns

    e_cum = np.concatenate([np.zeros((r, 1)), np.cumsum(trace.energy, axis=1)],
                           axis=1)                      # (R, T+1)

    act = trace.active
    for run in range(r):
        idx = np.flatnonzero(act[run])
        for j, t0 in enumerate(idx):
            # idle gap before this active step -> one merged E2 event.
            # j == 0 covers a trace-LEADING gap: its start boundary is the
            # run's initial state/output (prev_end == 0), so static energy
            # before the first active step is still emitted and event-set
            # energy sums to the trace energy over [0, last active step].
            prev_end = idx[j - 1] + 1 if j > 0 else 0
            gap = t0 - prev_end
            if gap > 0:
                xs.append(np.zeros_like(trace.inputs[run, t0])
                          if trace.idle_x_is_zero else trace.inputs[run, t0 - 1])
                kinds.append(int(EventKind.E2))
                v0s.append(trace.state[run, prev_end])
                v1s.append(trace.state[run, t0])
                ops.append(trace.output[run, prev_end])
                oes.append(trace.output[run, t0])
                taus.append(gap * ck)
                ps.append(trace.params[run])
                es.append(e_cum[run, t0] - e_cum[run, prev_end])
                ls.append(ck)
                rids.append(run)
            # the active step itself: E1 or E3
            changed = bool(trace.out_changed[run, t0])
            kinds.append(int(EventKind.E1 if changed else EventKind.E3))
            xs.append(trace.inputs[run, t0])
            v0s.append(trace.state[run, t0])
            v1s.append(trace.state[run, t0 + 1])
            ops.append(trace.output[run, t0])
            oes.append(trace.output[run, t0 + 1])
            taus.append(ck)
            ps.append(trace.params[run])
            es.append(trace.energy[run, t0])
            ls.append(trace.latency[run, t0])
            rids.append(run)

    if not kinds:
        # keep the column shapes of the 2-D fields so feature building on
        # an empty event set (all-idle traces) stays well-formed
        return EventSet(
            kind=np.zeros((0,), np.int32),
            x=np.zeros((0, trace.inputs.shape[-1]), np.float32),
            v_start=np.zeros((0,), np.float32),
            v_end=np.zeros((0,), np.float32),
            o_prev=np.zeros((0,), np.float32),
            o_end=np.zeros((0,), np.float32),
            tau=np.zeros((0,), np.float32),
            params=np.zeros((0, trace.params.shape[-1]), np.float32),
            energy=np.zeros((0,), np.float64),
            latency=np.zeros((0,), np.float32),
            run_id=np.zeros((0,), np.int32),
        )
    return EventSet(
        kind=np.asarray(kinds, np.int32),
        x=np.asarray(xs, np.float32),
        v_start=np.asarray(v0s, np.float32),
        v_end=np.asarray(v1s, np.float32),
        o_prev=np.asarray(ops, np.float32),
        o_end=np.asarray(oes, np.float32),
        tau=np.asarray(taus, np.float32),
        params=np.asarray(ps, np.float32),
        energy=np.asarray(es, np.float64),
        latency=np.asarray(ls, np.float32),
        run_id=np.asarray(rids, np.int32),
    )


def split_runwise(events: EventSet, n_runs: int, *, train=0.7, test=0.15,
                  seed=0):
    """Paper's run-wise 70/15/15 split."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_runs)
    n_tr = int(train * n_runs)
    n_te = int(test * n_runs)
    tr = set(perm[:n_tr].tolist())
    te = set(perm[n_tr:n_tr + n_te].tolist())
    is_tr = np.isin(events.run_id, list(tr))
    is_te = np.isin(events.run_id, list(te))
    is_va = ~(is_tr | is_te)
    return events.select(is_tr), events.select(is_te), events.select(is_va)
