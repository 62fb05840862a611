"""Abstract parameter specifications, materialized with ``torch``.

Models declare their parameters as a nested dict of ``ParamSpec`` (shape,
dtype, logical sharding axes, initializer), the JAX package's layout leaf
for leaf. :func:`materialize` draws real tensors from an explicit
``torch.Generator`` on a given device; :func:`param_count` and
:func:`param_bytes` read the specs without allocating anything.
:func:`shardings` resolves each leaf's logical axes to a
``sharding.Placement`` on a mesh, and ``materialize`` under a mesh draws
each whole leaf exactly as the unsharded init does, then splits it: a
sharded init holds the unsharded one's numbers.

Each element gets the reference's distribution, not its bits:
``jax.random`` cannot be replayed in ``torch``. Tests that compare the
two packages draw their weights with numpy instead
(``repro_torch.convert.lm_numpy_params``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"   # normal | zeros | ones | embed | lambda_lru | dt_bias | a_log
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16
    # sizes of the segments packed side by side in the last dim (Mamba-2's
    # in_proj z | x | B | C | dt); a split cuts each segment alike
    segments: tuple[int, ...] | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"spec rank mismatch: shape {self.shape} vs logical {self.logical}"
            )


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated (a cache leaf)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    segments: tuple[int, ...] | None = None


def leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict / list, depth first in key
    order, paths joined with "/" (``"layers/attn/wq"``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_map(fn, tree):
    """``fn`` applied to every leaf (a ``ParamSpec`` is a leaf)."""
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` applied to every leaf, paths as in :func:`leaves`."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _fan_in(shape: tuple[int, ...]) -> int:
    # The reference's rule, kept as it is: the second-to-last dim. For the
    # attention weights (d, h, dh) that is the head axis, not the
    # contraction over d (ROADMAP "Known reference caveats", _fan_in).
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1][-2:][-1:])) or shape[-2]


def _draw(generator: torch.Generator, spec: ParamSpec, shape,
          device: torch.device) -> torch.Tensor:
    """One fp32 draw of ``spec``'s initializer at ``shape`` (a slice of the
    leaf). The three recurrent initializers are the reference's
    (``repro/models/params.py:56-75``): Griffin's Lambda from a in [0.9,
    0.999), Mamba-2's dt bias as the inverse softplus of a log-uniform dt
    in [1e-3, 1e-1), and its A_log as the log of uniform [1, 16)."""
    def uniform(lo, hi):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return u * (hi - lo) + lo
    if spec.init == "lambda_lru":
        u = uniform(0.9, 0.999)
        return torch.log(torch.expm1(-torch.log(u) * 8.0) + 1e-8)
    if spec.init == "dt_bias":
        dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
        return dt + torch.log(-torch.expm1(-dt))
    if spec.init == "a_log":
        return torch.log(uniform(1.0, 16.0))
    if spec.init not in ("normal", "embed"):
        raise ValueError(f"unknown initializer {spec.init!r}")
    std = spec.scale if spec.init == "embed" else \
        spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * std


_SLICED_AXES = ("layers", "experts")


def _init_one(generator: torch.Generator, spec: ParamSpec,
              device: torch.device) -> torch.Tensor:
    shape, dtype = spec.shape, spec.dtype
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    # one layer (and one expert) at a time: a stacked leaf's fp32 draw never
    # exists whole ((30, 3072, 12288) is 4.5 GB in fp32, one layer of
    # DeepSeek-V3's w_gate 15 GB)
    lead = 0
    while lead < len(shape) - 1 and spec.logical[lead] in _SLICED_AXES:
        lead += 1
    parts = out.reshape(-1, *shape[lead:]) if lead else out[None]
    for part in parts:
        part.copy_(_draw(generator, spec, part.shape, device))
    return out


def materialize(generator: torch.Generator, spec_tree, device=None, *,
                placements=None):
    """Seeded init of the full parameter tree on ``device`` (the
    generator's own device by default). With ``placements`` (a matching
    tree of ``sharding.Placement``, :func:`shardings`) each leaf is drawn
    whole, in the same order and from the same generator as without, then
    placed: split onto its mesh entries' devices and freed."""
    dev = torch.device(device) if device is not None else generator.device
    if placements is None:
        return tree_map(lambda s: _init_one(generator, s, dev), spec_tree)
    flat = list(leaves(placements))
    it = iter(flat)
    return tree_map(lambda s: next(it)[1].place(_init_one(generator, s,
                                                           dev)),
                    spec_tree)


def shardings(spec_tree, mesh, rules):
    """Each leaf's ``sharding.Placement`` on ``mesh`` under ``rules``."""
    return tree_map(lambda s: rules.sharding(mesh, s.logical, s.shape,
                                             segments=s.segments),
                    spec_tree)


def logical_specs(spec_tree):
    return tree_map(lambda s: s.logical, spec_tree)


def shard_bytes(spec_tree, mesh, rules) -> list:
    """Bytes of parameters each mesh entry holds, from the specs' shapes
    and placements alone (no allocation), in mesh order."""
    per = [0] * mesh.size
    for (_, s), (_, pl) in zip(leaves(spec_tree),
                               leaves(shardings(spec_tree, mesh, rules))):
        n = int(np.prod(pl.shard_shape)) * s.dtype.itemsize
        per = [b + n for b in per]
    return per


def param_bytes(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for _, s in leaves(spec_tree))


def param_count(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in leaves(spec_tree))


def stacked(spec: ParamSpec, n: int) -> ParamSpec:
    """Prepend a layers dim (logical axis 'layers', never sharded)."""
    return ParamSpec(
        shape=(n, *spec.shape),
        logical=("layers", *spec.logical),
        init=spec.init,
        scale=spec.scale,
        dtype=spec.dtype,
        segments=spec.segments,
    )


def map_stacked(tree, n: int):
    return tree_map(lambda s: stacked(s, n), tree)

