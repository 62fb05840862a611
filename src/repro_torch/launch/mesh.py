"""Device meshes, the JAX package's ``launch/mesh.py`` in PyTorch.

A :class:`Mesh` is an ndarray of ``torch.device``s with named axes — the
``shape``, ``devices`` and ``axis_names`` a ``jax.sharding.Mesh`` has.
The network engine shards the batch over a mesh's entries, flattened in
row-major order (``core/distributed.py``); the LM places its parameters,
caches and batches on a ``(data, model)`` mesh by the logical rules of
``sharding.py``, tensor parallel over ``model``.

A device may be listed more than once. Each entry is a shard of its own,
and shards on the same device run one after another. This is the port's
counterpart of ``--xla_force_host_platform_device_count``, with which the
reference's tests give one CPU eight devices: it lets the CPU tests and a
single card run 2-8 shards through the sharded code paths.
:func:`shard_devices` and :func:`mesh_devices` list the launchers' entries
that way: the visible cards in turn (or the CPU), repeated as needed.

Meshes are hashed and compared by value (device strings, shape, axis
names), so the engine cache keys on them as the reference's does: two
meshes over the same devices share engines, and a mesh that is gone can
never be mistaken for a new one.

:func:`make_production_mesh` is the reference's production mesh with
every entry on torch's meta device: the dry run (``launch/dryrun.py``)
runs its steps there and allocates nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


class Mesh:
    """An ndarray of ``torch.device``s with one name per axis."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        arr.ravel()[:] = flat
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError(f"{arr.ndim}-d devices with axis names "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as the reference's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """The shards' devices in row-major (shard) order."""
        return list(self.devices.ravel())

    def _key(self):
        return (self.devices.shape, self.axis_names,
                tuple(str(d) for d in self.flat()))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.flat()]})")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's ``make_production_mesh`` (``launch/mesh.py:16``):
    (16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, every entry on the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, ["meta"] * int(np.prod(shape)))


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``: over ``devices``
    (repeats allowed: each entry is a shard) or else the first
    ``prod(shape)`` CUDA devices."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = int(np.prod(shape))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes CUDA devices unless devices= is given and "
                "no CUDA device is available; pass devices=['cpu'] * n for "
                "CPU shards")
        if torch.cuda.device_count() < n:
            raise ValueError(f"mesh {shape} needs {n} CUDA devices, "
                             f"{torch.cuda.device_count()} visible; list "
                             "devices= (a device may repeat)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"mesh {shape} needs {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)


def shard_devices(device, n_shards) -> list:
    """The data shards' devices: ``n_shards`` entries over the visible
    CUDA devices in turn (or the CPU), by default one per CUDA device."""
    dev = ops.resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (n_shards or 1)
    n_cards = torch.cuda.device_count()
    n = n_shards or n_cards
    return [torch.device("cuda", i % n_cards) for i in range(n)]


def mesh_devices(device, data_shards, model_parallel: int) -> list:
    """The mesh's entries: ``data_shards * model_parallel`` of them (by
    default one per CUDA device, or one data shard on the CPU), at least
    ``model_parallel``."""
    n = data_shards * model_parallel if data_shards else None
    devices = shard_devices(device, n)
    if len(devices) < model_parallel:
        devices = shard_devices(device, model_parallel)
    return devices


def make_host_mesh(*, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh over every visible CUDA device (or over
    ``devices``: the CPU only when passed), the data axis taking what the
    model axis leaves; remainder devices are dropped."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_host_mesh runs on CUDA devices unless devices= is "
                "given, and no CUDA device is available")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    model = max(1, min(model, len(devices)))
    data = len(devices) // model
    return make_mesh((data, model), ("data", "model"),
                     devices[:data * model])


def mesh_info(mesh: Mesh) -> dict:
    return {
        "shape": dict(mesh.shape),
        "n_devices": mesh.size,
        "axis_names": list(mesh.axis_names),
    }
