"""Convert the JAX package's parameters, as numpy arrays, into the port's.

The two packages meet only through numpy: a test (or a user moving an
experiment across) takes the reference's arrays with ``np.asarray`` and
hands them here. Nothing is reinterpreted — layouts are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import (crossbar_layer, crossbar_mlp_spec,
                                      graph_spec, lif_layer, recurrent_edge,
                                      snn_spec)
from repro_torch.core.surrogate import from_manifest
from repro_torch.core.wrapper import LasanaState
from repro_torch.kernels import ops


def surrogate_from_numpy(manifest: dict, arrays: dict, device=None):
    """A :class:`~repro_torch.core.surrogate.Surrogate` from the reference's
    manifest dict (the ``.npz`` ``__manifest__`` schema: ``format_version``,
    ``circuit``, ``families``, ``scales``, ``features``, ``fit_info``) and
    its ``{pname: {key: ndarray}}`` arrays."""
    return from_manifest(manifest, arrays, ops.resolve_device(device),
                         source="numpy arrays")


def spec_from_numpy(weights, params_per_layer, spike_amp: float = 1.5):
    """A feed-forward LIF :class:`NetworkSpec` from (fan_in, n_out) weight
    arrays and per-layer knob arrays."""
    return snn_spec([np.asarray(w, np.float32) for w in weights],
                    [np.asarray(p, np.float32) for p in params_per_layer],
                    spike_amp=spike_amp)


def crossbar_spec_from_numpy(weights, seg_width: int = 32,
                             adc_bits: int = 8, activation: str = "tanh"):
    """A crossbar-MLP :class:`NetworkSpec` from (fan_in, n_out) ternary
    weight arrays and the reference's crossbar knobs."""
    return crossbar_mlp_spec([np.asarray(w, np.float32) for w in weights],
                             seg_width=seg_width, adc_bits=adc_bits,
                             activation=activation)


def graph_spec_from_numpy(layers, edges=(), spike_amp: float = 1.5):
    """A mixed-circuit :class:`NetworkSpec` from plain descriptions.

    layers  ``{"circuit": "lif", "weight": w, "params": p}`` or
            ``{"circuit": "crossbar", "weight": w[, "seg_width", "adc_bits",
            "activation"]}`` per layer, in order
    edges   ``(src, dst, weight)`` triples, one-tick-delayed
    """
    built = []
    for layer in layers:
        kw = dict(layer)
        kind = kw.pop("circuit")
        w = np.asarray(kw.pop("weight"), np.float32)
        if kind == "lif":
            built.append(lif_layer(w, np.asarray(kw.pop("params"),
                                                 np.float32)))
        elif kind == "crossbar":
            built.append(crossbar_layer(w, **kw))
        else:
            raise ValueError(f"unknown circuit kind {kind!r}")
    return graph_spec(built, edges=[recurrent_edge(s, d, np.asarray(w))
                                    for s, d, w in edges],
                      spike_amp=spike_amp)


def state_from_numpy(v, o, t_last, params, device=None) -> LasanaState:
    """A :class:`LasanaState` from (N,) v / o / t_last and (N, n_p) params."""
    dev = ops.resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return LasanaState(v=t(v), o=t(o), t_last=t(t_last), params=t(params))
