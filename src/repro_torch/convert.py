"""Convert the JAX package's parameters, as numpy arrays, into the port's.

The two packages meet only through numpy: a test (or a user moving an
experiment across) takes the reference's arrays with ``np.asarray`` and
hands them here. Nothing is reinterpreted — layouts are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import snn_spec
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


def state_from_numpy(v, o, t_last, params, device=None) -> LasanaState:
    """A :class:`LasanaState` from (N,) v / o / t_last and (N, n_p) params."""
    dev = ops.resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return LasanaState(v=t(v), o=t(o), t_last=t(t_last), params=t(params))
