"""Elastic re-meshing: resume training on a different device count, the
JAX package's ``ft/elastic.py`` (``:24-68``) in PyTorch.

Checkpoints hold whole tensors, never device layouts, so elastic resume
is: rebuild a ``(data, model)`` mesh over the surviving devices (shrunk
along the data axis — the model axis stays whole), re-derive the
placements from the same rules, and restore onto them: each leaf is
split onto the new mesh (``tests/test_torch_lm_train.py`` resumes a
four-shard run on two, ``tests/test_torch_tp_train.py`` a ``(2, 2)``
tensor-parallel run on ``(1, 2)``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import sharding as shd
from repro_torch.launch.mesh import Mesh, make_mesh


@dataclasses.dataclass
class ElasticPlan:
    mesh: Mesh
    rules: shd.ShardingRules
    n_devices: int
    data_size: int
    model_size: int


def plan_mesh(devices=None, *, model_size: int = 1) -> ElasticPlan:
    """The largest ``(data, model)`` mesh over ``devices`` — every visible
    CUDA device by default (the CPU only when passed; a device may repeat,
    each entry a shard). ``model_size`` is fixed by the checkpointed
    layout; the data axis absorbs whatever survives, remainder devices
    are dropped."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "plan_mesh runs on CUDA devices unless devices= is given, "
                "and no CUDA device is available")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n < model_size:
        raise RuntimeError(
            f"cannot re-mesh: {n} devices < model_size {model_size}")
    data = n // model_size
    mesh = make_mesh((data, model_size), ("data", "model"),
                     devices[:data * model_size])
    return ElasticPlan(mesh=mesh, rules=shd.train_rules(mesh), n_devices=n,
                       data_size=data, model_size=model_size)


def resume_state(ckpt_manager, abstract_state, plan: ElasticPlan,
                 shardings_fn):
    """Restore the latest checkpoint onto the (possibly shrunk) mesh.

    ``shardings_fn(mesh, rules)`` -> a tree of placements (or devices)
    matching the state.
    Returns ``(step, state)``, or None when no checkpoint exists."""
    sh = shardings_fn(plan.mesh, plan.rules)
    got = ckpt_manager.restore_latest(abstract_state, shardings=sh)
    if got is None:
        return None
    step, state, _ = got
    return step, state


def simulate_failure(devices, n_lost: int):
    """Test helper: pretend the last ``n_lost`` devices died."""
    return devices[: len(devices) - n_lost]
