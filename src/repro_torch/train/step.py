"""The LM train step and the serve steps, the JAX package's
``train/step.py`` (``:30-125``) in PyTorch.

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``: the loss's gradient by autograd, microbatches accumulated in
fp32 and cast to bf16 (the reference's ``:74-91``), then
:meth:`AdamW.update` in place. Only 0-d metrics are returned.

``jit_train_step`` is the step on a ``(data, model)`` mesh — data
parallel. Each data shard computes its slice's share of the global loss
on its device (its NLL sum over the global valid count, its MoE groups,
its share of the aux loss), the shards' gradients are summed onto the
first device in shard order, and the update runs there; the shards' next
step reads replicas of the updated parameters. The result is the
single-device step up to the order of the summations, except the MoE
aux loss: a product of two batch means, it is computed per shard over
the shard's tokens and averaged (the reference's sharded program
computes it over the whole batch). A model axis larger than one device
(tensor parallelism) is a later slice and raises.
"""

from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch import tree as tr
from repro_torch.core.distributed import shard_bounds
from repro_torch.data.lm_data import to_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import params as prm
from repro_torch.models.model import Model
from repro_torch.optim import AdamW


# --- train state -------------------------------------------------------------

def init_train_state(model: Model, optimizer: AdamW,
                     generator: torch.Generator, device=None, specs=None):
    """``{"step", "params", "opt"}``: params drawn from ``generator`` on
    ``device`` (the generator's own by default) by ``model.init``, or by
    another tree of ParamSpecs (``specs``), and zero optimizer state."""
    params = (model.init(generator, device) if specs is None
              else prm.materialize(generator, specs, device))
    dev = next(iter(tr.leaves(params))).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "params": params, "opt": optimizer.init(params)}


def abstract_train_state(model: Model, optimizer: AdamW):
    """The train state as meta tensors (a checkpoint's ``like``)."""
    ap = model.abstract_params()
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "params": ap, "opt": optimizer.init_abstract(ap)}


def train_state_shardings(model: Model, optimizer: AdamW, mesh: Mesh,
                          rules: shd.ShardingRules):
    """Where each leaf of the train state lives: the mesh's first device
    (data parallelism keeps one copy of the state; the shards compute on
    replicas of the parameters). A model axis over more than one device
    raises (tensor parallelism is a later slice)."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(shd.TENSOR_PARALLEL)
    dev = mesh.flat()[0]
    pshard = prm.tree_map(lambda _: dev, model.param_specs())
    opt = {"m": pshard, "v": pshard}
    if optimizer.cfg.compress_grads:
        opt["err"] = pshard
    return {"step": dev, "params": pshard, "opt": opt}


# --- gradients -------------------------------------------------------------------

def loss_and_grads(model: Model, params, batch, *, n_moe_groups: int = 1,
                   counts=None, aux_share: float = 1.0):
    """``(loss, metrics, grads)`` of the batch (or of one data shard's
    slice: ``counts`` = the global ``(n, mtp_n)`` the NLL sums are divided
    by, ``aux_share`` the shard's share of the aux loss). Grads are in the
    params' dtypes; a leaf the loss does not reach gets zeros."""
    flat, treedef = tr.flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        parts = model.loss_parts(tr.unflatten(treedef, leaves), batch,
                                 n_moe_groups=n_moe_groups)
        parts["aux"] = parts["aux"] * aux_share
        n, mtp_n = counts if counts is not None else (parts["n"],
                                                      parts.get("mtp_n"))
        loss, metrics = model.combine_loss(parts, n, mtp_n)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tr.unflatten(treedef, grads)


def _slice_batch(batch: dict, lo: int, hi: int, dev) -> dict:
    return {k: v[lo:hi].to(dev, non_blocking=True) for k, v in batch.items()}


def _sharded_grads(model: Model, params, batch, mesh: Mesh, *,
                   n_moe_groups: int, replicas: dict):
    """The data-parallel gradient: each shard's share on its device,
    summed onto the first device in shard order."""
    devices = mesh.flat()
    first = devices[0]
    labels = batch["labels"]
    n = (labels >= 0).sum().float()
    mtp_n = (labels[:, 1:] >= 0).sum().float() if model.cfg.mtp_depth \
        else None
    k = len(devices)
    groups = n_moe_groups // k if n_moe_groups % k == 0 else 1
    acc, met = None, None
    for dev, (lo, hi) in zip(devices, shard_bounds(labels.shape[0], mesh)):
        p = params if dev == first else replicas.setdefault(
            str(dev), tr.tree_map(lambda t: t.to(dev), params))
        _, m, g = loss_and_grads(
            model, p, _slice_batch(batch, lo, hi, dev), n_moe_groups=groups,
            counts=(n.to(dev), None if mtp_n is None else mtp_n.to(dev)),
            aux_share=1.0 / k)
        g = tr.tree_map(lambda t: t.to(first), g)
        if acc is None:
            acc, met = g, {key: v.to(first) for key, v in m.items()}
            continue
        for a, b in zip(tr.leaves(acc), tr.leaves(g)):
            a.add_(b)
        for key, v in m.items():
            met[key] = met[key] + v.to(first)
    met["tokens"] = n.to(first)
    return met["loss"], met, acc


# --- the train step --------------------------------------------------------------

def make_train_step(model: Model, optimizer: AdamW, *,
                    num_microbatches: int = 1, n_moe_groups: int = 1,
                    mesh: Mesh | None = None):
    """``train_step(state, batch) -> (state, metrics)``. ``batch`` leaves
    are (B, S), or (M, B/M, S) with ``num_microbatches`` M > 1, as numpy
    arrays or tensors; the state's tensors are updated in place. With a
    ``mesh`` of several data shards, the batch (each microbatch) splits
    over them."""
    replicas: dict = {}

    def grads_of(params, mb):
        if mesh is None or mesh.size == 1:
            return loss_and_grads(model, params, mb,
                                  n_moe_groups=n_moe_groups)
        return _sharded_grads(model, params, mb, mesh,
                              n_moe_groups=n_moe_groups, replicas=replicas)

    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        if not isinstance(batch["tokens"], torch.Tensor):
            batch = to_device(batch, dev)
        replicas.clear()              # the parameters changed last step
        if num_microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            g_acc, loss_sum = None, torch.zeros((), dtype=torch.float32,
                                                device=dev)
            for i in range(num_microbatches):
                l, _, g = grads_of(params, {k: v[i] for k, v in
                                            batch.items()})
                if g_acc is None:
                    g_acc = tr.tree_map(lambda t: t.float(), g)
                else:
                    for a, b in zip(tr.leaves(g_acc), tr.leaves(g)):
                        a.add_(b.float())
                loss_sum = loss_sum + l
                del g
            inv = 1.0 / num_microbatches
            grads = tr.tree_map(lambda t: (t * inv).to(torch.bfloat16),
                                g_acc)
            del g_acc
            loss = loss_sum * inv
            metrics = {"loss": loss}
        _, opt_state, opt_metrics = optimizer.update(
            grads, state["opt"], params, state["step"])
        del grads
        metrics = {**metrics, **opt_metrics}
        new_state = {"step": state["step"] + 1, "params": params,
                     "opt": opt_state}
        return new_state, {k: v for k, v in metrics.items() if v.dim() == 0}

    return train_step


def jit_train_step(model: Model, optimizer: AdamW, mesh: Mesh,
                   rules: shd.ShardingRules, shape, *,
                   n_moe_groups: int = 1):
    """The train step on ``mesh`` for a shape cell (the reference's name:
    PyTorch runs it eagerly). The data axis splits the batch; a model
    axis over more than one device raises."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(shd.TENSOR_PARALLEL)
    return make_train_step(model, optimizer,
                           num_microbatches=shape.num_microbatches,
                           n_moe_groups=n_moe_groups, mesh=mesh)


# --- serving -----------------------------------------------------------------------

def make_decode_step(model: Model):
    def serve_step(params, cache, tokens):
        return model.decode(params, cache, tokens)
    return serve_step


def make_prefill(model: Model, *, max_seq: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_seq=max_seq)
    return prefill_step

