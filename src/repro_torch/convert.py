"""Convert the JAX package's parameters, as numpy arrays, into the port's.

The two packages meet only through numpy: a test (or a user moving an
experiment across) takes the reference's arrays with ``np.asarray`` and
hands them here. Nothing is reinterpreted — layouts are the reference's.
"""

from __future__ import annotations

import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.network import (crossbar_layer, crossbar_mlp_spec,
                                      graph_spec, lif_layer, recurrent_edge,
                                      snn_spec)
from repro_torch.core.surrogate import from_manifest
from repro_torch.core.wrapper import LasanaState
from repro_torch.kernels import ops
from repro_torch.models import params as prm
from repro_torch.models.model import Model


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


# --- LM zoo -------------------------------------------------------------------

def _lm_std(cfg, name: str):
    """Std of a parity weight: 1/sqrt(its contracted size); None = ones."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    std = {"wq": d, "wk": d, "wv": d, "wo": h * dh, "up": d, "gate": d,
           "down": cfg.d_ff, "lm_head": d}
    if name in std:
        return 1.0 / math.sqrt(std[name])
    if name == "embedding":
        return 0.02
    if name in ("ln1", "ln2", "final_norm"):
        return None
    raise NotImplementedError(f"no parity weights for {name!r} yet")


def lm_numpy_params(cfg, seed: int = 0) -> dict:
    """Well-conditioned float32 weights for ``Model(cfg)``, in the JAX
    ``Model``'s tree (stacked layers), drawn with numpy from ``seed``.

    Each leaf, and each layer of a stacked leaf, has its own generator,
    ``np.random.default_rng([seed, crc32(path), layer])``, so the draws
    run in parallel threads (numpy fills without the GIL) with the same
    result, and a model cut to fewer layers gets the first layers of the
    full one. Std is 1/sqrt(contracted size) (d for wq / wk / wv / up /
    gate / lm_head, H * Dh for wo, d_ff for down), 0.02 for the
    embedding, ones for norms. Both packages round these to bf16 with
    round-to-nearest-even."""
    jobs = []

    def alloc(path, spec):
        std = _lm_std(cfg, path.rsplit("/", 1)[-1])
        if std is None:
            return np.ones(spec.shape, np.float32)
        out = np.empty(spec.shape, np.float32)
        key = zlib.crc32(path.encode())
        if spec.logical[0] == "layers":
            jobs.extend((out[i], [seed, key, i], std) for i in range(len(out)))
        else:
            jobs.append((out, [seed, key], std))
        return out

    def draw(job):
        out, entropy, std = job
        np.random.default_rng(entropy).standard_normal(dtype=np.float32,
                                                       out=out)
        out *= np.float32(std)

    tree = prm.map_with_path(alloc, Model(cfg).param_specs())
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(draw, jobs))
    return tree


def _host_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:             # JAX's arrays are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":        # ml_dtypes, as JAX hands it over
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(cfg, arrays: dict, device=None) -> dict:
    """The port's parameter tree of ``Model(cfg)`` from the JAX ``Model``'s
    (numpy leaves, stacked layers; bf16 or float32). Each leaf becomes its
    spec's dtype on ``device`` (float32 rounds to bf16 to nearest even),
    one layer at a time for a stacked leaf."""
    dev = ops.resolve_device(device)
    flat = dict(prm.leaves(arrays))

    def convert(path, spec):
        src = _host_tensor(flat[path])
        if tuple(src.shape) != spec.shape:
            raise ValueError(f"{path}: shape {tuple(src.shape)}, the model "
                             f"takes {spec.shape}")
        out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
        parts = zip(out, src) if spec.logical[0] == "layers" else [(out, src)]
        for dst, part in parts:
            dst.copy_(part.to(dev))
        return out

    return prm.map_with_path(convert, Model(cfg).param_specs())
