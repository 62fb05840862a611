"""The crossbar case study: a ternary MLP tiled onto 32-input PCM crossbar
rows behind an 8-bit ADC, one combinational wave of DAC volts per image
(paper §V-E, first half).

The program's side builds the spec through ``repro_torch``; the
reference's side is ``reference.lasana_ref.Crossbar``. Both read the same
weight and surrogate files and take the same stimulus tensor.
"""

from __future__ import annotations

import hashlib

import numpy as np

from lasana_bench.reference import compare, lasana_ref
from lasana_bench.traffic import digits

CIRCUIT = "crossbar"
# one ADC step of a row in the outputs' gain-compensated units
STEP = (2 * lasana_ref.XBAR["v_sat"] / 255
        / (lasana_ref.XBAR["r_f"] * lasana_ref.XBAR["g_unit"]))


def weights(cfg: dict) -> list:
    with np.load(cfg["weights_path"]) as z:
        return [z[f"w{i}"].astype(np.float32)
                for i in range(len(cfg["layers"]) - 1)]


def program(cfg: dict, surrogate_path: str, device):
    """``(spec, surrogate)`` of the program, on ``device``."""
    import repro_torch.lasana as lasana
    from repro_torch.core.network import crossbar_mlp_spec
    spec = crossbar_mlp_spec(weights(cfg), seg_width=cfg["seg_width"],
                             adc_bits=cfg["adc_bits"],
                             activation=cfg["activation"])
    return spec, lasana.load(surrogate_path, device=device)


def reference(cfg: dict, surrogate_path: str, device,
              precision: str = "fp32") -> lasana_ref.Crossbar:
    mm = lasana_ref.Matmul(precision)
    heads = lasana_ref.Heads(surrogate_path, device, mm)
    return lasana_ref.Crossbar(weights(cfg), heads, device, mm,
                               adc_bits=cfg["adc_bits"])


def stimulus(cfg: dict, batch: int, gen):
    """One wave: ``batch`` digits as DAC volts (B, 400)."""
    inp = cfg["input"]
    imgs = digits.make_digits(batch, inp["size"], gen)[0]
    return imgs * inp["volts_scale"] + inp["volts_offset"]


def program_records(run, spikes: bool) -> dict:
    """A ``NetworkRun``'s records with every layer's outputs (one wave:
    a few MB, kept for every call)."""
    return {"outputs": run.outputs, "energy": run.energy,
            "latency": run.latency, "events": run.events,
            "flush": run.flush_energy,
            "layers": [np.asarray(s)[-1] for s in run.layer_spikes]}


def reference_records(ref, x, **_) -> dict:
    r = ref.wave(x)
    r["flush"] = np.zeros(len(ref.w))
    r["ref"], r["x"], r["forced"] = ref, x, {}
    return r


def gaps(prog: dict, ref: dict) -> dict:
    """End to end against the reference's own wave, and the answers: each
    digit's outputs as the program produced them against the reference's
    last layer driven by the program's own outputs of the layer before it
    (``answers``: the most outputs of one digit that differ by half an
    ADC step or more), so that a half-step flip upstream does not spread
    into every answer downstream of it."""
    out = compare.xbar_gaps(prog, ref, STEP)
    # calls whose layers are equal drive the reference alike: run it once
    key = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes()
                                  for a in prog["layers"])).hexdigest()
    forced = ref["forced"].get(key)
    if forced is None:
        forced = ref["forced"][key] = ref["ref"].wave(
            ref["x"], forced=prog["layers"])
    d = np.abs(np.asarray(prog["outputs"], np.float64)
               - np.asarray(forced["layers"][-1], np.float64))
    out["answers"] = float((d >= 0.5 * STEP).sum(-1).max())
    return out


def layer_sizes(cfg: dict, batch: int) -> list:
    """Crossbar rows per layer for a batch: outputs x 32-wide segments."""
    l, seg = cfg["layers"], cfg["seg_width"]
    return [batch * l[i + 1] * -(-l[i] // seg) for i in range(len(l) - 1)]


def drive_flops(cfg: dict, batch: int) -> list:
    """Per layer: each row's weighted input sum (its derived feature)."""
    return [2 * n * cfg["seg_width"] for n in layer_sizes(cfg, batch)]
