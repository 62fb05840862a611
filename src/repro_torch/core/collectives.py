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
that of an :func:`all_reduce_sum` an all-reduce of them. The dry-run
slice counts the bytes that cross shards here.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _devices(parts, devices):
    return [p.device for p in parts] if devices is None else [
        torch.device(d) for d in devices]


def _out(result: torch.Tensor, devices) -> list:
    """``result`` on each of ``devices``: one copy per distinct device."""
    copies: dict = {}
    out = []
    for dev in devices:
        key = str(dev)
        if key not in copies:
            copies[key] = result.to(dev)
        out.append(copies[key])
    return out


def broadcast(t: torch.Tensor, devices: Sequence) -> list:
    """``t`` (one shard's value) to every participant's device."""
    return _out(t, [torch.device(d) for d in devices])


def all_reduce_sum(parts: Sequence[torch.Tensor], devices=None) -> list:
    """The elementwise sum of ``parts``, added in shard order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return _out(acc, _devices(parts, devices))


def all_max(parts: Sequence[torch.Tensor], devices=None) -> list:
    """The elementwise maximum of ``parts``."""
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(acc.device))
    return _out(acc, _devices(parts, devices))


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               devices=None) -> list:
    """``parts`` concatenated along ``dim`` in shard order."""
    if len(parts) == 1:
        return _out(parts[0], _devices(parts, devices))
    first = parts[0].device
    whole = torch.cat([p.to(first) for p in parts], dim=dim)
    return _out(whole, _devices(parts, devices))


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int,
                   devices=None) -> list:
    """The sum of ``parts`` (in shard order), cut along ``dim`` into as
    many equal blocks as there are participants: participant ``i`` gets
    block ``i``."""
    devs = _devices(parts, devices)
    acc = all_reduce_sum(parts, devices=[parts[0].device])[0]
    blocks = torch.chunk(acc, len(devs), dim=dim)
    if len(blocks) != len(devs) or acc.shape[dim] % len(devs):
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(acc.shape)} "
                         f"does not split into {len(devs)} blocks")
    return [b.to(d) for b, d in zip(blocks, devs)]


def assemble(pieces, shape, dtype, device) -> torch.Tensor:
    """A whole tensor of ``shape`` on ``device`` from shards' blocks:
    ``pieces`` is a list of ``(shard tensor, [(global slices, local
    slices), ...])``, each pair copying one box of the shard into the
    whole."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for t, boxes in pieces:
        for g, loc in boxes:
            out[g] = t[loc].to(device)
    return out


class Group:
    """The participants of the collectives of one data row's model
    shards, by device in shard order."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]

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
