"""Collectives over the shards of a mesh: the one place where tensors move
from one shard to another.

Each collective takes a list of per-shard tensors, one per participant in
shard order, and returns a list with one result per participant, on that
participant's device (``devices=`` names other destinations). Sums and
maxima are taken in shard order on the first participant's device, then
copied out; participants that share a device share one result tensor, so
a card that holds several shards of a mesh computes and stores each
result once.

They are built from differentiable ``torch`` operations, so autograd's
backward of each is its adjoint collective: the gradient of an
:func:`all_gather` is a :func:`reduce_scatter` of the output gradients,
that of an :func:`all_reduce_sum` an all-reduce of them.

The dry run counts here (:func:`counting`). While a counter is active,
each collective hands it its kind — the reference's HLO names, whose
ring traffic ``launch/roofline.py:wire_bytes`` reckons —, its number of
participants and each destination's output, and the arithmetic it does
to simulate the exchange on one host (the adds in shard order, the
copies) is not counted as the devices' work. ``all_max`` moves what an
all-reduce moves and counts as ``"all-reduce"``; ``broadcast`` delivers
the whole tensor once to each device and counts as
``"collective-permute"``; :func:`assemble` (a whole tensor from the
shards' blocks, on one device) counts as ``"all-gather"`` at that
device. On the meta device every participant stands for a device of its
own, so each gets a tensor of its own.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

_COUNTERS: list = []


@contextlib.contextmanager
def counting(counter):
    """Report every collective to ``counter`` inside: ``counter.begin()``
    before its arithmetic, ``counter.end(kind, n, parts, outs)`` after."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


@contextlib.contextmanager
def _counted(kind: str, n: int, parts, result: list, owners=None):
    for c in _COUNTERS:
        c.begin()
    try:
        yield
    finally:
        for c in reversed(_COUNTERS):
            c.end(kind, n, parts, result, owners)


def _owners(parts) -> list | None:
    """The mesh entries the innermost counter gives ``parts`` (None when
    nothing counts)."""
    if not _COUNTERS:
        return None
    return [_COUNTERS[-1].entry_of(p) for p in parts]


def _devices(parts, devices):
    return [p.device for p in parts] if devices is None else [
        torch.device(d) for d in devices]


def _out(result: torch.Tensor, devices) -> list:
    """``result`` on each of ``devices``: one copy per distinct device
    (per participant on the meta device)."""
    copies: dict = {}
    out = []
    for dev in devices:
        key = str(dev) if dev.type != "meta" else len(out)
        if key not in copies:
            copies[key] = result.to(dev) if dev.type != "meta" or not out \
                else result.clone()
        out.append(copies[key])
    return out


class _OnMeta(torch.autograd.Function):
    """A collective on meta tensors as one autograd node whose backward is
    its adjoint collective, counted as such, each participant's gradient
    a tensor of its own. (On devices the collectives' own differentiable
    operations give the same adjoints; on meta every participant shares
    one device, and those operations would hand them one shared tensor.)"""

    @staticmethod
    def forward(ctx, impl, adjoint, n_in, *args):
        parts, rest = list(args[:n_in]), args[n_in:]
        ctx.adjoint, ctx.rest = adjoint, rest
        ctx.owners = _owners(parts)
        ctx.sizes = [p.shape for p in parts]
        return tuple(impl(parts, *rest))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None,
                *ctx.adjoint(list(grads), ctx, *ctx.rest),
                *(None,) * len(ctx.rest))


def _differentiated(parts) -> bool:
    return parts[0].device.type == "meta" and torch.is_grad_enabled() \
        and any(p.requires_grad for p in parts)


def _meta_devices(n):
    return [torch.device("meta")] * n


def broadcast(t: torch.Tensor, devices: Sequence, at=None) -> list:
    """``t`` (one shard's value) to every participant's device."""
    devices = [torch.device(d) for d in devices]
    if _differentiated([t]):
        return list(_OnMeta.apply(_broadcast, _broadcast_adj, 1, t,
                                  tuple(devices), at))
    return _broadcast([t], devices, at)


def _broadcast(parts, devices, owners=None) -> list:
    out: list = []
    with _counted("collective-permute", len(devices), parts, out, owners):
        out[:] = _out(parts[0], devices)
    return out


def _broadcast_adj(grads, ctx, devices, at):
    return _reduce_impl(torch.add, grads, _meta_devices(1), ctx.owners)


def _reduce_impl(fn, parts, devices, owners=None) -> list:
    out: list = []
    with _counted("all-reduce", len(parts), parts, out, owners):
        acc = parts[0]
        for p in parts[1:]:
            acc = fn(acc, p.to(acc.device))
        out[:] = _out(acc, _devices(parts, devices))
    return out


def _sum_adj(grads, ctx, devices, at):
    return _reduce_impl(torch.add, grads, _meta_devices(len(ctx.sizes)),
                        ctx.owners)


def all_reduce_sum(parts: Sequence[torch.Tensor], devices=None,
                   at=None) -> list:
    """The elementwise sum of ``parts``, added in shard order. ``at``
    (here and below) names the destinations' mesh entries for a counter,
    where their devices cannot (meta entries share one device)."""
    if _differentiated(parts):
        devs = tuple(_devices(parts, devices))
        return list(_OnMeta.apply(
            lambda ps, d, a: _reduce_impl(torch.add, ps, d, a), _sum_adj,
            len(parts), *parts, devs, at))
    return _reduce_impl(torch.add, parts, devices, at)


def all_max(parts: Sequence[torch.Tensor], devices=None) -> list:
    """The elementwise maximum of ``parts``."""
    return _reduce_impl(torch.maximum, parts, devices)


def _gather_impl(parts, dim, devices, owners=None) -> list:
    out: list = []
    with _counted("all-gather", len(parts), parts, out, owners):
        if len(parts) == 1:
            out[:] = _out(parts[0], _devices(parts, devices))
        else:
            first = parts[0].device
            whole = torch.cat([p.to(first) for p in parts], dim=dim)
            out[:] = _out(whole, _devices(parts, devices))
    return out


def _gather_adj(grads, ctx, dim, devices, at):
    """The sum of the outputs' gradients, each participant its block."""
    out: list = []
    with _counted("reduce-scatter", len(ctx.sizes), grads, out, ctx.owners):
        acc = grads[0]
        for g in grads[1:]:
            acc = acc + g
        out[:] = [b.clone() for b in torch.split(
            acc, [s[dim] for s in ctx.sizes], dim=dim)]
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               devices=None, at=None) -> list:
    """``parts`` concatenated along ``dim`` in shard order."""
    if _differentiated(parts):
        return list(_OnMeta.apply(_gather_impl, _gather_adj, len(parts),
                                  *parts, dim,
                                  tuple(_devices(parts, devices)), at))
    return _gather_impl(parts, dim, devices, at)


def _scatter_impl(parts, dim, devs, owners=None) -> list:
    out: list = []
    with _counted("reduce-scatter", len(devs), parts, out, owners):
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p.to(acc.device)
        blocks = torch.chunk(acc, len(devs), dim=dim)
        if len(blocks) != len(devs) or acc.shape[dim] % len(devs):
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(acc.shape)} does not split into "
                             f"{len(devs)} blocks")
        out[:] = [b.clone() if d.type == "meta" else b.to(d)
                  for b, d in zip(blocks, devs)]
    return out


def _scatter_adj(grads, ctx, dim, devs, at):
    """Every destination's gradient block, gathered onto each
    participant."""
    out: list = []
    with _counted("all-gather", len(grads), grads, out, ctx.owners):
        whole = torch.cat(list(grads), dim=dim)
        out[:] = _out(whole, _meta_devices(len(ctx.sizes)))
    return out


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int,
                   devices=None, at=None) -> list:
    """The sum of ``parts`` (in shard order), cut along ``dim`` into as
    many equal blocks as there are participants: participant ``i`` gets
    block ``i``."""
    devs = _devices(parts, devices)
    if _differentiated(parts):
        return list(_OnMeta.apply(_scatter_impl, _scatter_adj, len(parts),
                                  *parts, dim, tuple(devs), at))
    return _scatter_impl(parts, dim, devs, at)


def assemble(pieces, shape, dtype, device) -> torch.Tensor:
    """A whole tensor of ``shape`` on ``device`` from shards' blocks:
    ``pieces`` is a list of ``(shard tensor, [(global slices, local
    slices), ...])``, each pair copying one box of the shard into the
    whole."""
    out: list = []
    with _counted("all-gather", len(pieces), [t for t, _ in pieces], out):
        whole = torch.empty(shape, dtype=dtype, device=device)
        for t, boxes in pieces:
            for g, loc in boxes:
                whole[g] = t[loc].to(device)
        out.append(whole)
    return out[0]


class Group:
    """The participants of the collectives of one data row's model
    shards, by device in shard order; ``q_seq`` whether attention splits
    its queries over them (``seq_parallel_attn``)."""

    def __init__(self, devices: Sequence, q_seq: bool = False):
        self.devices = [torch.device(d) for d in devices]
        self.q_seq = q_seq

    @property
    def size(self) -> int:
        return len(self.devices)

    def sum(self, parts) -> list:
        return all_reduce_sum(parts, self.devices)

    def max(self, parts) -> list:
        return all_max(parts, self.devices)

    def gather(self, parts, dim: int) -> list:
        return all_gather(parts, dim, self.devices)

    def scatter_sum(self, parts, dim: int) -> list:
        return reduce_scatter(parts, dim, self.devices)

    def reduce(self, parts, split: bool) -> list:
        """Row-parallel outputs: partial sums (``split``) all-reduced, or
        full outputs computed on every shard alike, kept as they are."""
        return self.sum(parts) if split and self.size > 1 else list(parts)
