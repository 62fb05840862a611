"""Convert the JAX package's parameters, as numpy arrays, into the port's.

The two packages meet only through numpy: a test (or a user moving an
experiment across) takes the reference's arrays with ``np.asarray`` and
hands them here. Nothing is reinterpreted — layouts are the reference's.
"""

from __future__ import annotations

import dataclasses
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

_SLICED_AXES = ("layers", "experts")


def _lead(spec) -> int:
    """How many leading axes of ``spec`` enumerate independent slices (a
    layer stack, an expert bank), each drawn on its own generator."""
    n = 0
    while n < len(spec.shape) - 1 and spec.logical[n] in _SLICED_AXES:
        n += 1
    return n


def _lm_std(name: str, spec) -> float:
    """Std of a parity weight: 0.02 for the embedding, else 1/sqrt(its
    contracted size) — the first axis past the stack / expert axes, both
    (heads x head dim) for an output projection ``wo``."""
    if spec.init == "embed":
        return 0.02
    shape = spec.shape[_lead(spec):]
    fan = shape[0] * shape[1] if name == "wo" else shape[0]
    return 1.0 / math.sqrt(fan)


def _lm_uniform(init: str, out: np.ndarray, rng) -> None:
    """The recurrent initializers' draws in float32 numpy, the
    reference's formulas (``repro/models/params.py:56-75``) on a uniform
    draw in [0, 1)."""
    u = rng.random(dtype=np.float32, out=out)
    f32 = np.float32
    if init == "lambda_lru":
        u *= f32(0.999 - 0.9)
        u += f32(0.9)
        out[...] = np.log(np.expm1(-np.log(u) * f32(8.0)) + f32(1e-8))
    elif init == "dt_bias":
        lo, hi = f32(math.log(1e-3)), f32(math.log(1e-1))
        dt = np.exp(u * (hi - lo) + lo)
        out[...] = dt + np.log(-np.expm1(-dt))
    elif init == "a_log":
        out[...] = np.log(u * f32(15.0) + f32(1.0))
    else:
        raise ValueError(f"no parity draw for initializer {init!r}")


def lm_numpy_params(cfg, seed: int = 0) -> dict:
    """Well-conditioned float32 weights for ``Model(cfg)``, in the JAX
    ``Model``'s tree (stacked layers, a list for the Griffin interleave),
    drawn with numpy from ``seed``.

    Each leaf, and each layer (and expert) of a stacked leaf, has its own
    generator, ``np.random.default_rng([seed, crc32(path), layer,
    expert])``, so the draws run in parallel threads (numpy fills without
    the GIL) with the same result, and a model cut to fewer layers gets
    the first layers of the full one. A matrix is normal with std
    1/sqrt(contracted size) (d for wq / wk / wv / up / gate / lm_head,
    H * Dh for wo, d_ff for down, and so on), the embedding 0.02; zeros
    and ones stay the spec's; A_log, dt_bias and Lambda are the
    reference's uniform draws. Both packages round these to each leaf's
    dtype (bf16 with round-to-nearest-even, or fp32 as it is)."""
    jobs = []

    def alloc(path, spec):
        if spec.init in ("zeros", "ones"):
            return getattr(np, spec.init)(spec.shape, np.float32)
        out = np.empty(spec.shape, np.float32)
        key = zlib.crc32(path.encode())
        lead = _lead(spec)
        std = None if spec.init in ("lambda_lru", "dt_bias", "a_log") \
            else _lm_std(path.rsplit("/", 1)[-1], spec)
        for idx in np.ndindex(*spec.shape[:lead]):
            jobs.append((out[idx], [seed, key, *idx], spec.init, std))
        return out

    def draw(job):
        out, entropy, init, std = job
        rng = np.random.default_rng(entropy)
        if std is None:
            _lm_uniform(init, out, rng)
            return
        rng.standard_normal(dtype=np.float32, out=out)
        out *= np.float32(std)

    tree = prm.map_with_path(alloc, Model(cfg).param_specs())
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(draw, jobs))
    return tree


def lm_parity_specs(cfg) -> dict:
    """``Model(cfg).param_specs()`` with each normal leaf's scale set so
    that :func:`~repro_torch.models.params.materialize` draws it with
    :func:`lm_numpy_params`' std: the parity weights' distribution (not
    their values), drawn by ``torch`` on any device — a model too large
    for host draws gets well-conditioned weights on the card."""
    def one(path, spec):
        if spec.init != "normal":
            return spec
        fan = max(prm._fan_in(spec.shape), 1)
        return dataclasses.replace(spec, scale=_lm_std(
            path.rsplit("/", 1)[-1], spec) * math.sqrt(fan))
    return prm.map_with_path(one, Model(cfg).param_specs())


def _host_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:             # JAX's arrays are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":        # ml_dtypes, as JAX hands it over
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(cfg, arrays: dict, device=None) -> dict:
    """The port's parameter tree of ``Model(cfg)`` from the JAX ``Model``'s
    (numpy leaves, stacked layers, a list for the Griffin interleave; bf16
    or float32). Each leaf becomes its spec's dtype on ``device`` (float32
    rounds to bf16 to nearest even; the fp32 leaves — the router, A_log,
    Lambda, ... — stay fp32), one layer at a time for a stacked leaf."""
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
