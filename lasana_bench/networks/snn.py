"""The spiking case study: a feed-forward network of LIF banks, Poisson
rate-coded digits in, spike counts out (paper §V-E, second half).

The program's side builds the spec through ``repro_torch``; the
reference's side is ``reference.lasana_ref.SNN``. Both read the same
weight and surrogate files and take the same stimulus tensor.
"""

from __future__ import annotations

import numpy as np

from lasana_bench.reference import compare, lasana_ref
from lasana_bench.traffic import digits

CIRCUIT = "lif"


def weights(cfg: dict) -> list:
    with np.load(cfg["weights_path"]) as z:
        return [z[f"w{i}"].astype(np.float32)
                for i in range(len(cfg["layers"]) - 1)]


def program(cfg: dict, surrogate_path: str, device):
    """``(spec, surrogate)`` of the program, on ``device``."""
    import repro_torch.lasana as lasana
    from repro_torch.core.network import snn_spec
    ws = weights(cfg)
    knobs = [np.asarray(cfg["knobs"], np.float32)] * len(ws)
    spec = snn_spec(ws, knobs, spike_amp=cfg["spike_amp"])
    return spec, lasana.load(surrogate_path, device=device)


def reference(cfg: dict, surrogate_path: str, device,
              precision: str = "fp32") -> lasana_ref.SNN:
    mm = lasana_ref.Matmul(precision)
    heads = lasana_ref.Heads(surrogate_path, device, mm)
    ws = weights(cfg)
    return lasana_ref.SNN(ws, [cfg["knobs"]] * len(ws), heads, device, mm)


def images(cfg: dict, batch: int, gen):
    inp = cfg["input"]
    return digits.make_digits(batch, inp["size"], gen)[0]


def encode(cfg: dict, imgs, ticks: int, gen):
    """(ticks, B, 784) spikes of V_dd on the images' device."""
    inp = cfg["input"]
    return digits.poisson_spikes(imgs, ticks, gen, max_rate=inp["max_rate"],
                                 amplitude=cfg["spike_amp"])


def stimulus(cfg: dict, batch: int, gen):
    """One call's stimulus: ``cfg["ticks"]`` ticks over ``batch`` digits."""
    return encode(cfg, images(cfg, batch, gen), cfg["ticks"], gen)


def program_records(run, spikes: bool) -> dict:
    """A ``NetworkRun``'s records, with every recorded layer's spikes
    (as fired / not fired) when ``spikes``: the hidden layers' from
    ``layer_spikes``, the output layer's from ``out_spikes``."""
    rec = {"counts": run.outputs, "energy": run.energy,
           "latency": run.latency, "events": run.events,
           "flush": run.flush_energy}
    if spikes:
        # the hidden layers' records, and the output layer's as published
        hidden = (run.layer_spikes or [None])[:-1]
        rec["spikes"] = [np.asarray(s) > 0.75
                         for s in [*hidden, run.out_spikes]]
    return rec


def reference_records(ref, x, *, start: bool = True, flush: bool = True,
                      hidden: bool = True) -> dict:
    """The reference over ticks ``x``: from a fresh state when ``start``,
    with the end-of-run flush when ``flush``."""
    if start:
        ref.start(x.shape[1])
    r = ref.advance(x, keep_hidden=hidden)
    spikes = [s for s in r.pop("spikes") if s is not None]
    r["spikes"] = spikes
    r["counts"] = spikes[-1].sum(0)
    if flush:
        r["flush"] = ref.flush()
    return r


def gaps(prog: dict, ref: dict) -> dict:
    return compare.snn_gaps(prog, ref)


def layer_sizes(cfg: dict, batch: int) -> list:
    """Circuits per layer for a batch."""
    return [batch * n for n in cfg["layers"][1:]]


def drive_flops(cfg: dict, batch: int) -> list:
    """Per layer and tick: the drive product and the event product."""
    l = cfg["layers"]
    return [4 * batch * l[i] * l[i + 1] for i in range(len(l) - 1)]
