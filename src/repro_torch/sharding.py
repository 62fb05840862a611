"""Logical-axis sharding, the JAX package's ``sharding.py`` (``:47-181``,
``:223``) in PyTorch.

Parameters and activations carry *logical* axis names ("embed", "heads",
"mlp", "batch", ...). A :class:`ShardingRules` table maps each logical
axis onto zero or more mesh axes, and :meth:`ShardingRules.spec` turns a
logical spec into a partition spec — here a tuple, one entry per dim
(``None``, a mesh axis name or a tuple of them), in place of the
reference's ``PartitionSpec`` — with the reference's rules: a mesh axis is
used at most once per spec, trailing ``None``s are trimmed, and
:meth:`ShardingRules.spec_for_shape` drops mesh axes that do not divide
their dim.

:meth:`ShardingRules.sharding` resolves a spec to a :class:`Placement`,
the counterpart of ``NamedSharding``: the mesh, the resolved spec, each
mesh entry's block of the tensor and its shard shape, ``split`` (a whole
tensor -> one block per mesh entry, on that entry's device) and
``gather`` (the blocks -> the whole). A dim split over several mesh axes
is cut major axis first, as ``PartitionSpec`` cuts it. A dim that packs
segments side by side (Mamba-2's ``in_proj`` columns z | x | B | C | dt)
is split segment by segment: each shard holds its block of every segment,
so that it holds its own channels of each. A placed tensor is a
:class:`Sharded` (its placement and one tensor per mesh entry, in
row-major mesh order); on a mesh of one entry it is the plain tensor.

The two switches of ``train_rules`` that the dry run's ``--rule-opt``
reaches (reference ``:138-146``): ``qk_dim_fallback`` maps ``qk_dim``
(``head_dim``) onto the model axis, which a weight takes where its head
count does not divide the axis; ``seq_parallel_attn`` maps
``attn_q_seq``, the rows of attention's query chunks. How attention runs
under each is in ``models/attention.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.core import collectives
from repro_torch.launch.mesh import Mesh

LogicalAxis = str | None


@functools.lru_cache(maxsize=64)
def _coords(shape: tuple, names: tuple) -> tuple:
    """Every mesh entry's ``{axis: index}``, in row-major order."""
    return tuple(dict(zip(names, (int(x) for x in idx)))
                 for idx in np.ndindex(*shape))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Placement:
    """Where the blocks of a tensor of ``shape`` live on ``mesh`` under the
    resolved partition ``spec``; ``segments`` (sizes summing to the last
    dim) makes the last dim split segment by segment."""

    def __init__(self, mesh: Mesh, spec: tuple, shape=None, *,
                 segments=None, logical=None):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = None if shape is None else tuple(int(s) for s in shape)
        self.segments = None if segments is None else tuple(segments)
        self.logical = logical
        if self.shape is None:
            return
        if len(self.spec) > len(self.shape):
            raise ValueError(f"spec {self.spec} longer than shape "
                             f"{self.shape}")
        for k, dim in enumerate(self.shape):
            n = self.parts(k)
            cuts = self._cut_sizes(k)
            if any(c % n for c in cuts):
                raise ValueError(f"dim {k} of {self.shape} (segments "
                                 f"{cuts}) does not split into {n} blocks")

    # --- the partition -----------------------------------------------------

    def dim_axes(self, k: int) -> tuple:
        return _entry_axes(self.spec[k]) if k < len(self.spec) else ()

    def parts(self, k: int) -> int:
        sizes = self.mesh.shape
        return int(np.prod([sizes[a] for a in self.dim_axes(k)] or [1]))

    def _cut_sizes(self, k: int) -> tuple:
        last = len(self.shape) - 1
        if self.segments is not None and k == last:
            if sum(self.segments) != self.shape[k]:
                raise ValueError(f"segments {self.segments} do not sum to "
                                 f"dim {k} of {self.shape}")
            return self.segments
        return (self.shape[k],)

    def split_dims(self, axis: str) -> list:
        """The dims a mesh axis of more than one entry cuts."""
        if self.mesh.shape.get(axis, 1) == 1:
            return []
        return [k for k in range(len(self.spec)) if axis in self.dim_axes(k)]

    def splits(self, axis: str) -> bool:
        return bool(self.split_dims(axis))

    @property
    def shard_shape(self) -> tuple:
        return tuple(d // self.parts(k) for k, d in enumerate(self.shape))

    @property
    def devices(self) -> list:
        return self.mesh.flat()

    def coords(self, i: int) -> dict:
        """Mesh entry ``i``'s index along each axis (a shared dict: read
        it, do not change it)."""
        return _coords(self.mesh.devices.shape, self.mesh.axis_names)[i]

    def block(self, i: int) -> tuple:
        """Mesh entry ``i``'s block index along each dim."""
        c, sizes = self.coords(i), self.mesh.shape
        out = []
        for k in range(len(self.shape)):
            b = 0
            for a in self.dim_axes(k):
                b = b * sizes[a] + c[a]
            out.append(b)
        return tuple(out)

    def ranges(self, k: int, b: int) -> list:
        """``[(global start, local start, length)]`` of block ``b`` of dim
        ``k``: one range, or one per segment."""
        n, out, g0, l0 = self.parts(k), [], 0, 0
        for size in self._cut_sizes(k):
            w = size // n
            out.append((g0 + b * w, l0, w))
            g0, l0 = g0 + size, l0 + w
        return out

    def boxes(self, i: int) -> list:
        """``[(global slices, local slices)]`` whose copies make up mesh
        entry ``i``'s block."""
        per_dim = [self.ranges(k, b) for k, b in enumerate(self.block(i))]
        out = []
        for combo in itertools.product(*per_dim):
            out.append((tuple(slice(g, g + w) for g, _, w in combo),
                        tuple(slice(l, l + w) for _, l, w in combo)))
        return out

    def replicas(self) -> list:
        """Mesh entries grouped by the block they hold, each group in
        shard order, groups in order of their first entry."""
        groups: dict = {}
        for i in range(self.mesh.size):
            groups.setdefault(self.block(i), []).append(i)
        return list(groups.values())

    # --- moving tensors ---------------------------------------------------------

    def local(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Mesh entry ``i``'s block of the whole tensor ``t`` (where ``t``
        lies)."""
        boxes = self.boxes(i)
        if len(boxes) == 1:
            return t[boxes[0][0]]
        out = t.new_empty(self.shard_shape)
        for g, loc in boxes:
            out[loc] = t[g]
        return out

    def split(self, t: torch.Tensor) -> list:
        """The whole tensor ``t`` -> each mesh entry's block, a tensor of
        its own on that entry's device."""
        if tuple(t.shape) != self.shape:
            raise ValueError(f"tensor of shape {tuple(t.shape)} placed as "
                             f"{self.shape}")
        return [self.local(t, i).to(dev, copy=True).contiguous()
                for i, dev in enumerate(self.devices)]

    def place(self, t: torch.Tensor):
        """``t`` placed: a :class:`Sharded`, or on a mesh of one entry the
        tensor on that entry's device."""
        if self.mesh.size == 1:
            return t.to(self.devices[0])
        return Sharded(self, self.split(t))

    def gather(self, shards: Sequence[torch.Tensor], device=None):
        """The whole tensor from one block per mesh entry (the first
        holder of each block is read), on ``device`` (the first entry's by
        default)."""
        dev = shards[0].device if device is None else torch.device(device)
        pieces = [(shards[g[0]], self.boxes(g[0])) for g in self.replicas()]
        return collectives.assemble(pieces, self.shape, shards[0].dtype, dev)

    def __repr__(self):
        return (f"Placement(spec={self.spec}, shape={self.shape}, "
                f"shard_shape={self.shard_shape if self.shape else None}, "
                f"mesh={dict(self.mesh.shape)})")


class Sharded:
    """A placed tensor: its :class:`Placement` and one tensor per mesh
    entry, in row-major mesh order (entries that hold the same block hold
    equal copies)."""

    __slots__ = ("placement", "shards")

    def __init__(self, placement: Placement, shards: Sequence[torch.Tensor]):
        if len(shards) != placement.mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{placement.mesh.size} entries")
        want = placement.shard_shape
        for i, t in enumerate(shards):
            if tuple(t.shape) != want:
                raise ValueError(f"shard {i} of shape {tuple(t.shape)}, "
                                 f"placement {placement}")
        self.placement = placement
        self.shards = list(shards)

    @property
    def shape(self) -> tuple:
        return self.placement.shape

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    def gather(self, device=None) -> torch.Tensor:
        return self.placement.gather(self.shards, device)

    def __repr__(self):
        return f"Sharded({self.placement}, dtype={self.dtype})"


def place_tree(tree, placements):
    """A tree of whole tensors placed leaf by leaf (``placements`` a
    matching tree of :class:`Placement` s, or of devices)."""
    def one(t, pl):
        return pl.place(t) if isinstance(pl, Placement) else t.to(pl)
    return tr.tree_map(one, tree, placements)


def gather_tree(tree, device=None):
    """A placed tree's leaves whole (plain tensors as they are)."""
    return tr.tree_map(lambda t: whole(t, device), tree)


def map_tensors(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the matching leaves of
    ``rest``): a plain leaf maps to ``fn(leaf, ...)``, a :class:`Sharded`
    one shard by shard to a :class:`Sharded` of the same placement."""
    def one(x, *ys):
        if isinstance(x, Sharded):
            return Sharded(x.placement, [fn(*ts) for ts in zip(
                x.shards, *[y.shards for y in ys])])
        return fn(x, *ys)
    return tr.tree_map(one, tree, *rest)


class _Through:
    """A placement seen through the mesh entries of some data rows
    (``keep``, whole rows in mesh order, the ``model`` axis last): a mesh
    of ``len(keep)`` entries. Its replica groups are the placement's,
    renumbered, an entry of another row seen as the first kept row's
    entry of the same model shard (whose block has the same shape): the
    groups keep their number, and a block outside the kept rows is seen
    as a kept one."""

    def __init__(self, pl: Placement, keep):
        self._pl, self._pos = pl, {e: i for i, e in enumerate(keep)}
        self.mesh = type("Through", (), {"size": len(keep)})()

    def replicas(self) -> list:
        m = self._pl.mesh.shape.get("model", 1)
        out = []
        for g in self._pl.replicas():
            seen: list = []
            for i in g:
                j = self._pos.get(i, i % m)
                if j not in seen:
                    seen.append(j)
            out.append(seen)
        return out

    def __getattr__(self, name):
        return getattr(self._pl, name)


def through(tree, keep):
    """``tree`` with each placed leaf cut to the shards of the mesh
    entries ``keep`` (the same tensors): what the entries of the data
    rows that compute (``Model.rows.live``) update. ``keep`` None leaves
    the tree as it is."""
    if keep is None:
        return tree
    return tr.tree_map(lambda x: Sharded(_Through(x.placement, keep),
                                         [x.shards[i] for i in keep])
                       if isinstance(x, Sharded) else x, tree)


def tensors(leaf) -> list:
    """A leaf's tensors: its shards, or the plain tensor."""
    return leaf.shards if isinstance(leaf, Sharded) else [leaf]


def whole(t, device=None):
    """A placed tensor's whole value (a plain tensor as it is)."""
    if isinstance(t, Sharded):
        return t.gather(device)
    return t if device is None else t.to(device)


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
                 shape: Sequence[int] | None = None, *,
                 segments=None) -> Placement:
        """The :class:`Placement` of a tensor of this logical spec (and
        ``shape``: mesh axes that do not divide a dim are dropped)."""
        spec = (self.spec_for_shape(mesh, logical_spec, shape)
                if shape is not None else self.spec(logical_spec))
        return Placement(mesh, spec, shape, segments=segments,
                         logical=tuple(logical_spec))


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
    """A tree of logical specs (tuples of names) -> a tree of
    :class:`Placement` s (without shapes: the unresolved specs)."""
    if isinstance(tree_of_logical, dict):
        return {k: logical_to_sharding(v, mesh, rules)
                for k, v in tree_of_logical.items()}
    if isinstance(tree_of_logical, list):
        return [logical_to_sharding(v, mesh, rules) for v in tree_of_logical]
    return rules.sharding(mesh, tree_of_logical)


def constraint(x, mesh: Mesh, rules: ShardingRules,
               logical_spec: Sequence[LogicalAxis]):
    """The whole tensor ``x`` placed as the logical spec says (a
    :class:`Sharded`; on a mesh of one entry ``x`` on that entry's
    device, ``x`` itself where it already lies there)."""
    if isinstance(x, Sharded):
        x = x.gather()
    return rules.sharding(mesh, logical_spec, tuple(x.shape)).place(x)


def num_devices(mesh: Mesh) -> int:
    return int(np.prod(mesh.devices.shape))
