"""Logical-axis sharding rules, the JAX package's ``sharding.py``
(``:47-181``, ``:223``) in PyTorch: the rule tables only.

Parameters and activations carry *logical* axis names ("embed", "heads",
"mlp", "batch", ...). A :class:`ShardingRules` table maps each logical
axis onto zero or more mesh axes, and :meth:`ShardingRules.spec` turns a
logical spec into a partition spec — here a tuple, one entry per dim
(``None``, a mesh axis name or a tuple of them), in place of the
reference's ``PartitionSpec`` — with the reference's rules: a mesh axis is
used at most once per spec, trailing ``None``s are trimmed, and
:meth:`ShardingRules.spec_for_shape` drops mesh axes that do not divide
their dim.

The port places whole tensors: :func:`sharding` resolves a spec to the
one device a tensor lives on, and raises where the spec would split a
tensor across devices — tensor-parallel placement (``--model-parallel >
1``, ``--kv-seq``) is a later slice (ROADMAP §A). The batch is split by
the train step and the network engine themselves (data parallelism).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh

LogicalAxis = str | None

TENSOR_PARALLEL = ("tensor-parallel placement (a tensor split over more "
                   "than one device: --model-parallel > 1, --kv-seq) is not "
                   "ported yet (ROADMAP §A)")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis name -> mesh axis (or tuple of axes)."""

    rules: Mapping[str, Any]

    def mesh_axes(self, logical: LogicalAxis):
        if logical is None:
            return None
        return self.rules.get(logical, None)

    def spec(self, logical_spec: Sequence[LogicalAxis]) -> tuple:
        """A logical spec as a partition spec: a mesh axis appears at most
        once (a later logical axis that would reuse one degrades to
        replicated), trailing Nones trimmed."""
        used: set = set()
        out = []
        for logical in logical_spec:
            axes = self.mesh_axes(logical)
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            keep = tuple(a for a in axes if a not in used)
            if not keep:
                out.append(None)
                continue
            used.update(keep)
            out.append(keep if len(keep) > 1 else keep[0])
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def spec_for_shape(self, mesh: Mesh, logical_spec: Sequence[LogicalAxis],
                       shape: Sequence[int]) -> tuple:
        """Like :meth:`spec`, but a mesh axis that does not divide its dim
        (times the axes already kept for that dim) is dropped."""
        sizes = mesh.shape
        used: set = set()
        out = []
        for logical, dim in zip(logical_spec, shape):
            axes = self.mesh_axes(logical)
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            keep: list = []
            prod = 1
            for a in axes:
                if a in used:
                    continue
                if dim % (prod * sizes[a]) == 0:
                    keep.append(a)
                    prod *= sizes[a]
            if not keep:
                out.append(None)
                continue
            used.update(keep)
            out.append(tuple(keep) if len(keep) > 1 else keep[0])
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def sharding(self, mesh: Mesh, logical_spec: Sequence[LogicalAxis],
                 shape: Sequence[int] | None = None) -> torch.device:
        """The device a tensor of this logical spec lives on: the mesh's
        first device, where the spec splits it over no mesh axis larger
        than one device. A spec that would split it raises (tensor
        parallelism is a later slice)."""
        spec = (self.spec_for_shape(mesh, logical_spec, shape)
                if shape is not None else self.spec(logical_spec))
        split = [a for entry in spec if entry is not None
                 for a in ((entry,) if isinstance(entry, str) else entry)
                 if mesh.shape[a] > 1]
        if split:
            raise NotImplementedError(
                f"spec {spec} splits a tensor over mesh axes {split}: "
                + TENSOR_PARALLEL)
        return mesh.flat()[0]


def train_rules(mesh: Mesh, *, fsdp: bool = True, shard_seq: bool = False,
                qk_dim_fallback: bool = False,
                seq_parallel_attn: bool = False,
                kv_seq_sharding: bool = False) -> ShardingRules:
    """The reference's training table on a ('pod', 'data', 'model') or
    ('data', 'model') mesh: activations' batch over (pod, data); params
    tensor-parallel over 'model' on heads / mlp / experts / vocab and
    FSDP over (pod, data) on embed when ``fsdp``; the switches as the
    reference documents them."""
    axes = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    rules: dict = {
        "batch": dp,
        "seq": dp if shard_seq else None,
        "embed": dp if fsdp else None,
        "heads": tp,
        "kv_heads": tp,
        "qk_dim": tp if qk_dim_fallback else None,
        "attn_q_seq": tp if seq_parallel_attn else None,
        "kv_seq": tp if kv_seq_sharding else None,
        "mlp": tp,
        "experts": tp,
        "vocab": tp,
        "ssm_inner": tp,
        "circuits": dp + ((tp,) if tp else ()),
        "features": None,
    }
    return ShardingRules(rules=rules)


def serve_rules(mesh: Mesh, *, kv_seq_sharding: bool = False) -> ShardingRules:
    """Decode rules: caches shard batch over dp; optionally seq over tp."""
    return train_rules(mesh, fsdp=True, shard_seq=False,
                       kv_seq_sharding=kv_seq_sharding)


def logical_to_sharding(tree_of_logical, mesh: Mesh, rules: ShardingRules):
    """A tree of logical specs (tuples of names) -> a tree of devices."""
    if isinstance(tree_of_logical, dict):
        return {k: logical_to_sharding(v, mesh, rules)
                for k, v in tree_of_logical.items()}
    if isinstance(tree_of_logical, list):
        return [logical_to_sharding(v, mesh, rules) for v in tree_of_logical]
    return rules.sharding(mesh, tree_of_logical)


def constraint(x, mesh: Mesh, rules: ShardingRules,
               logical_spec: Sequence[LogicalAxis]):
    """``x`` placed as the logical spec says: on the mesh's first device
    (no-op there); raises where the spec would split it."""
    return x.to(rules.sharding(mesh, logical_spec, tuple(x.shape)))


def num_devices(mesh: Mesh) -> int:
    return int(np.prod(mesh.devices.shape))
