"""A whole run with the timed path broken underneath comes out not
correct, for each fault these cells can have: a step that returns its
state unchanged, half of the batch left out with the records scaled up
from the rest, and an answer altered where it is produced. (Every cell
runs on one chip, so no exchange between chips exists to leave out.)
The harness's look for a chip is skipped: the program runs its plain
versions on the CPU at a tiny size."""

import numpy as np
import pytest
import torch

from lasana_bench.test_bench_reference import cells, run_tiny
from lasana_bench.traffic import stream


def state_unchanged(monkeypatch):
    import repro_torch.core.network as network

    def step(bank, carry, changed, x, t, clock, **kw):
        z = torch.zeros_like(carry.v)
        return carry, z, z, carry.o
    monkeypatch.setattr(network, "lasana_step", step)


def _doubled(run, b):
    """A run of the first half of a batch, posing as the whole batch:
    its per-digit records repeated, its sums doubled."""
    rep = lambda a, axis: np.concatenate([a, a], axis=axis).take(
        range(b), axis=axis)
    run.outputs = rep(run.outputs, 0)
    if run.out_spikes is not None:
        run.out_spikes = rep(run.out_spikes, 1)
    if run.layer_spikes is not None:
        run.layer_spikes = [rep(s, 1) for s in run.layer_spikes]
    run.energy = run.energy * 2
    run.events = run.events * 2
    run.flush_energy = run.flush_energy * 2
    return run


def half_batch(monkeypatch):
    import repro_torch.lasana as lasana
    from repro_torch.core.network import NetworkEngine
    dispatch = NetworkEngine.dispatch

    def half(self, inputs, surrogates=None):
        b = inputs.shape[-2]
        pend = dispatch(self, inputs[..., :b // 2, :], surrogates=surrogates)
        result = pend.result
        pend.result = lambda: _doubled(result(), b)
        return pend
    monkeypatch.setattr(NetworkEngine, "dispatch", half)
    streamed = lasana.stream

    def half_stream(spec, stimulus, **kw):
        b = stimulus.shape[1]
        part = stream.CyclicBlocks([p[:, :b // 2] for p in stimulus.pool],
                                   stimulus.shape[0] // stimulus.tc)
        for chunk in streamed(spec, part, **kw):
            yield _doubled(chunk, b)
    monkeypatch.setattr(lasana, "stream", half_stream)


def answer_altered(monkeypatch):
    from repro_torch.core.network import NetworkEngine
    primary = NetworkEngine._primary

    def altered(self, out_seq):
        if self.spec.circuits[-1] == "lif":
            out_seq[:, 0] = self.spec.spike_amp    # one digit fires always
            return primary(self, out_seq)
        return primary(self, out_seq) + 0.5        # one wave, 15 ADC steps
    monkeypatch.setattr(NetworkEngine, "_primary", altered)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", cells())
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res, lines = run_tiny(cell)
    assert not res["correct"], lines
    assert res["failed"] >= 1
