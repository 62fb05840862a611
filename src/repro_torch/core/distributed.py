"""Batch-parallel LASANA simulation over a device mesh, the JAX package's
``core/distributed.py`` (``:34-169``) in PyTorch.

Circuits are embarrassingly parallel: Algorithm 1 has no cross-circuit
communication, so the batch-major flattened ``(B*n, ...)`` state and
stimulus shard over every mesh axis flattened, in contiguous slices. The
reference writes that as ``shard_map``; here :func:`shard_over_batch`
runs the batch-local body once per shard, on the shard's slice and on the
shard's device (shards that share a device run one after another), and
combines the diagnostics — the reference's ``psum`` / ``pmax`` — by sum
or max onto the first shard's device, in shard order. Summed shard by
shard, energies change their order of addition: they agree with the
unsharded run to rounding (the reference's tests hold them to rtol 1e-5),
while spikes, outputs and event counts are batch-local and identical.

The surrogate is an argument of the step, replicated on every shard's
device, so retrained surrogates of equal structure reuse the step.
:func:`abstract_sim_inputs` / :func:`lower_distributed_step` are the dry
run of one tick (``launch/dryrun_lasana.py``): the tick's body run on
meta tensors, one mesh entry after another, under ``launch/hlo_cost.py``.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.core.surrogate import as_surrogate
from repro_torch.tree import tree_map
from repro_torch.core.wrapper import LasanaState, lasana_step
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh


def circuit_spec(mesh: Mesh) -> tuple:
    """The circuit axis's spec: sharded over every mesh axis (the
    reference's ``P(tuple(mesh.axis_names))``)."""
    return (tuple(mesh.axis_names),)


def batch_spec(mesh: Mesh, ndim: int = 1, axis: int = 0) -> tuple:
    """Dim ``axis`` of an ``ndim`` array sharded over all mesh axes
    flattened, the other dims whole (the reference's PartitionSpec as a
    tuple; trailing ``None``s kept)."""
    spec = [None] * ndim
    spec[axis] = tuple(mesh.axis_names)
    return tuple(spec)


def shard_bounds(n: int, mesh: Mesh) -> list:
    """``[(start, stop)]`` of each shard's contiguous slice of ``n`` rows,
    in shard order; raises when the mesh does not divide ``n``."""
    k = mesh.size
    if n % k:
        raise ValueError(f"batch {n} not divisible by mesh size {k}")
    m = n // k
    return [(i * m, (i + 1) * m) for i in range(k)]


def _is_node(x) -> bool:
    return isinstance(x, (list, tuple, dict))


def _replicate(leaf, dev):
    if isinstance(leaf, torch.Tensor):
        return leaf.to(dev, non_blocking=True)
    if hasattr(leaf, "to") and not isinstance(leaf, (int, float)):
        return leaf.to(dev)                  # a Surrogate or a library
    return leaf


def _split(leaf, axis: int, lo: int, hi: int, dev):
    if not isinstance(leaf, torch.Tensor):
        return leaf
    return leaf.narrow(axis, lo, hi - lo).to(dev, non_blocking=True)


def _shard_args(args, in_specs, mesh: Mesh, i: int, dev):
    out = []
    for a, spec in zip(args, in_specs):
        if spec is None:
            out.append(tree_map(lambda t: _replicate(t, dev), a))
            continue

        def part(t, spec=spec):
            if not isinstance(t, torch.Tensor):
                return t
            lo, hi = shard_bounds(t.shape[spec], mesh)[i]
            return _split(t, spec, lo, hi, dev)
        out.append(tree_map(part, a))
    return out


def _combine(parts, spec, dev):
    """One output from its shards' values: concatenated along axis
    ``spec``, or reduced by ``"sum"`` / ``"max"`` in shard order, on
    ``dev``; a non-tensor leaf (None, a number) is taken from shard 0."""
    first = parts[0]
    if not isinstance(first, torch.Tensor):
        return first
    parts = [p.to(dev, non_blocking=True) for p in parts]
    if isinstance(spec, int):
        return torch.cat(parts, dim=spec)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p if spec == "sum" else torch.maximum(acc, p)
    return acc


def shard_over_batch(fn, mesh: Mesh, in_specs, out_specs):
    """The batch-parallel wrapper: ``wrapped(*args)`` runs ``fn`` on each
    shard's contiguous slice, on that shard's device, and combines.

    ``in_specs`` holds one entry per positional argument: an int splits
    every tensor of that argument (a tensor or a tree of them) along that
    axis; ``None`` replicates it onto each shard's device (a Surrogate or
    library is moved with its ``.to``). ``out_specs`` is a tree matching
    ``fn``'s output whose leaves say how each output joins: an int
    concatenates the shards' tensors along that axis, ``"sum"`` / ``"max"``
    reduce them — the reference's ``psum`` / ``pmax`` — in shard order.
    Everything lands on the first shard's device.

    ``fn`` may be a mapping from ``str(device)`` to the body for that
    device (a network engine has one replica per device)."""
    devices = [ops.resolve_device(d) for d in mesh.flat()]

    def body(dev):
        return fn[str(dev)] if isinstance(fn, dict) else fn

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} arguments, {len(in_specs)} "
                            "in_specs")
        outs = [body(dev)(*_shard_args(args, in_specs, mesh, i, dev))
                for i, dev in enumerate(devices)]
        return _join(outs, out_specs, devices[0])

    return wrapped


def _join(outs, spec, dev):
    """Combine a list of shard outputs by the tree ``spec``; a leaf spec
    standing for a subtree (a list of carries) applies to all of it."""
    if not _is_node(spec) and _is_node(outs[0]):
        spec = tree_map(lambda _: spec, outs[0])
    if isinstance(spec, dict):
        return {k: _join([o[k] for o in outs], s, dev)
                for k, s in spec.items()}
    if isinstance(spec, (list, tuple)):
        first = outs[0]
        vals = [_join([o[i] for o in outs], s, dev)
                for i, s in enumerate(spec)]
        if isinstance(first, list):
            return vals
        if hasattr(first, "_fields"):
            return type(first)(*vals)
        return tuple(vals)
    return _combine(outs, spec, dev)


# --- the sharded Algorithm-1 tick -----------------------------------------------

def _tick_body(*, clock_ns: float, spiking: bool = False, vdd: float = 1.5,
               fused: bool = True, fused_kernel: bool | None = None):
    """One shard's tick: ``lasana_step`` on its circuits -> (state, its
    energy sum, its spike count)."""

    def body(surrogate, state, changed, x, t):
        if isinstance(t, torch.Tensor) and t.dim() == 1:
            t = t[0]
        new_state, e, _, o = lasana_step(surrogate, state, changed, x, t,
                                         clock_ns, spiking=spiking, vdd=vdd,
                                         fused=fused,
                                         fused_kernel=fused_kernel)
        # spike counts are integers: an fp32 sum loses whole events past
        # 2^24 a tick
        return new_state, e.sum(), (o > 0.5 * vdd).sum(dtype=torch.int32)
    return body


def _sharded_step(mesh: Mesh, *, clock_ns: float, spiking: bool = False,
                  vdd: float = 1.5, fused: bool = True,
                  fused_kernel: bool | None = None):
    """One Algorithm-1 tick over the mesh; the surrogate is argument 0,
    replicated. The per-shard body is exactly ``lasana_step``, so on the
    card ``network_tick`` launches shard-local on N / shards circuits."""
    body = _tick_body(clock_ns=clock_ns, spiking=spiking, vdd=vdd,
                      fused=fused, fused_kernel=fused_kernel)
    state_spec = LasanaState(v=0, o=0, t_last=0, params=0)
    return shard_over_batch(body, mesh,
                            in_specs=(None, 0, 0, 0, None),
                            out_specs=(state_spec, "sum", "sum"))


def make_distributed_step(mesh, _legacy_mesh=None, *, clock_ns: float,
                          spiking: bool = False, vdd: float = 1.5,
                          fused: bool = True,
                          fused_kernel: bool | None = None):
    """``step(surrogate, state, changed, x, t) -> (state, e_total,
    spikes_total)``: one tick sharded over ``mesh``. ``t`` is the tick's
    time (a (1,) tensor as the reference passes it, a 0-d tensor or a
    float); ``e_total`` is the summed energy and ``spikes_total`` an exact
    int32 count, both on the first shard's device. ``fused`` and
    ``fused_kernel`` are :func:`lasana_step`'s.

    The legacy call ``make_distributed_step(bank, mesh, ...)`` (the
    surrogate closed over; the returned step takes ``(state, changed, x,
    t)``) is still accepted with a DeprecationWarning."""
    if _legacy_mesh is None and not isinstance(mesh, Mesh):
        raise TypeError(
            "make_distributed_step expects a repro_torch Mesh as its first "
            f"argument, got {type(mesh).__name__}; the surrogate is passed "
            "to the returned step, not here")
    kw = dict(clock_ns=clock_ns, spiking=spiking, vdd=vdd, fused=fused,
              fused_kernel=fused_kernel)
    if _legacy_mesh is not None:
        if not isinstance(_legacy_mesh, Mesh):
            raise TypeError("legacy make_distributed_step(bank, mesh, ...) "
                            "call: second argument must be a repro_torch "
                            f"Mesh, got {type(_legacy_mesh).__name__}")
        warnings.warn(
            "make_distributed_step(bank, mesh, ...) is deprecated; call "
            "make_distributed_step(mesh, ...) and pass the Surrogate as "
            "the step's first argument", DeprecationWarning, stacklevel=2)
        surrogate = as_surrogate(mesh)
        fn = _sharded_step(_legacy_mesh, **kw)
        return lambda state, changed, x, t: fn(surrogate, state, changed,
                                               x, t)
    fn = _sharded_step(mesh, **kw)

    def step(surrogate, state, changed, x, t):
        return fn(as_surrogate(surrogate), state, changed, x, t)

    return step


# --- the dry run ----------------------------------------------------------------

def abstract_sim_inputs(n_circuits: int, n_in: int, n_params: int):
    """One tick's inputs as meta tensors (the reference's ``:172-183``):
    ``(state, changed, x, t)`` for ``n_circuits`` circuits."""
    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    state = LasanaState(v=meta((n_circuits,)), o=meta((n_circuits,)),
                        t_last=meta((n_circuits,)),
                        params=meta((n_circuits, n_params)))
    return (state, meta((n_circuits,), torch.bool),
            meta((n_circuits, n_in)), meta((1,)))


def _meta_copy(surrogate):
    """The surrogate's arrays on the meta device, tensors of their own."""
    from repro_torch.core.surrogate import Surrogate
    return Surrogate(surrogate.manifest,
                     {p: {k: torch.empty(a.shape, dtype=a.dtype,
                                         device="meta")
                          for k, a in d.items()}
                      for p, d in surrogate.params.items()},
                     surrogate.fit_info)


def lower_distributed_step(surrogate, mesh: Mesh, n_circuits: int,
                           n_in: int, n_params: int, *, clock_ns: float,
                           spiking: bool = False, vdd: float = 1.5,
                           fused: bool = True,
                           fused_kernel: bool | None = None):
    """The dry run of one sharded tick (the reference's ``:186-203``,
    where ``.lower()`` + ``.compile()`` and their analyses stand): each
    mesh entry's block of :func:`abstract_sim_inputs` and its own meta
    copy of the surrogate (the reference's replicated weights) are its
    arguments, ``_tick_body`` runs on them entry by entry under
    ``hlo_cost.counting`` (the kernels' dry-run route: ``network_tick``
    records its work and launches nothing), and the energy and spike sums
    are all-reduced over the mesh, the reference's ``psum``. Returns
    ``{entry: hlo_cost.EntryStats}``; ``hlo_cost.per_device`` gives the
    device's figures. ``mesh`` may hold any devices: the run is on meta
    tensors whatever they are."""
    from repro_torch.core import collectives
    from repro_torch.launch import hlo_cost
    surrogate = as_surrogate(surrogate)
    body = _tick_body(clock_ns=clock_ns, spiking=spiking, vdd=vdd,
                      fused=fused, fused_kernel=fused_kernel)
    n_dev = mesh.size
    if n_circuits % n_dev:
        raise ValueError(f"{n_circuits} circuits not divisible by mesh size "
                         f"{n_dev}")
    per = n_circuits // n_dev
    args = [(_meta_copy(surrogate), *abstract_sim_inputs(per, n_in,
                                                         n_params))
            for _ in range(n_dev)]
    counter = hlo_cost.Counter()
    for e, (sur, state, changed, x, t) in enumerate(args):
        counter.arguments((a, e) for a in [*state, changed, x, t] + [
            a for d in sur.params.values() for a in d.values()])
    outs = []
    with hlo_cost.counting(counter), torch.no_grad():
        for e, a in enumerate(args):
            with counter.at(e):
                outs.append(body(*a))
        energy = collectives.all_reduce_sum([o[1] for o in outs],
                                            ["meta"] * n_dev,
                                            at=list(range(n_dev)))
        spikes = collectives.all_reduce_sum([o[2] for o in outs],
                                            ["meta"] * n_dev,
                                            at=list(range(n_dev)))
    result = [(t, e) for e, o in enumerate(outs) for t in o[0]] + [
        (t, e) for e, t in enumerate(energy)] + [
        (t, e) for e, t in enumerate(spikes)]
    return counter.stats(result)
