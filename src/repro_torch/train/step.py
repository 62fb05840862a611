"""The LM train step and the serve steps, the JAX package's
``train/step.py`` (``:30-125``) in PyTorch.

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``: the loss's gradient by autograd, microbatches accumulated in
fp32 and cast to bf16 (the reference's ``:74-91``), then
:meth:`AdamW.update` in place. Only 0-d metrics are returned.

``jit_train_step`` is the step on a mesh, on a placed state (the
reference's in/out shardings, :func:`train_state_shardings`): data
parallelism over the mesh's data axes (FSDP's ``embed`` split over them
where the rules say so) and tensor parallelism over its ``model`` axis.
Every leaf lives as one block per mesh entry (``sharding.Sharded``); the
model runs on the mesh (``Model(cfg, mesh=, rules=)``), each data row's
NLL sum over its slice of the batch, each MoE token routed once in the
unsharded model's groups and the aux loss once; autograd's backward
runs the collectives' adjoints; the gradients of the entries that hold
the same block of a leaf are all-reduced; and AdamW updates each block
where it lives. The result is the single-device step up to the order of
the summations. ``cache_shardings`` / ``jit_prefill`` /
``jit_decode_step`` are the serving counterparts.
"""

from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch import tree as tr
from repro_torch.core import collectives
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
    another tree of ParamSpecs (``specs``), and zero optimizer state —
    placed on the model's mesh where it has one (the step counter on the
    mesh's first device)."""
    if specs is None:
        params = model.init(generator, device)
    else:
        params = prm.materialize(
            generator, specs, device,
            placements=None if model.mesh is None
            else model.param_placements())
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
    """Where each leaf of the train state lives: the params' and the
    optimizer moments' ``sharding.Placement`` s (FSDP's ``embed`` over the
    data axes when ``rules`` say so, tensor parallelism over ``model``),
    and the step counter — a replicated scalar — on the mesh's first
    device."""
    pshard = prm.shardings(model.param_specs(), mesh, rules)
    opt = {"m": pshard, "v": pshard}
    if optimizer.cfg.compress_grads:
        opt["err"] = pshard
    return {"step": mesh.flat()[0], "params": pshard, "opt": opt}



# --- gradients -------------------------------------------------------------------

def loss_and_grads(model: Model, params, batch, *, n_moe_groups: int = 1):
    """``(loss, metrics, grads)`` of the batch. Grads are in the params'
    dtypes; a leaf the loss does not reach gets zeros."""
    flat, treedef = tr.flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        parts = model.loss_parts(tr.unflatten(treedef, leaves), batch,
                                 n_moe_groups=n_moe_groups)
        loss, metrics = model.combine_loss(parts, parts["n"],
                                           parts.get("mtp_n"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tr.unflatten(treedef, grads)


def placed_loss_and_grads(model: Model, params, batch, *,
                          n_moe_groups: int = 1):
    """``(loss, metrics, grads)`` of the model on its mesh for a placed
    ``params`` tree: one backward over every row and shard, then each
    leaf's gradient summed over the entries that hold the same block
    (its replicas), so every entry holds its block's whole gradient, in a
    tensor of its own (the update and the int8 compression write the
    gradients in place, entry by entry).

    Where only some data rows compute (``model.rows.live``: the dry run,
    on meta tensors, lets one row stand for the rest), gradients are
    taken for the live rows' entries alone and all-reduced into them,
    each other member of a replica group taking part with its parameter
    shard in place of its gradient (of the same shape and dtype); the
    grads come back seen through those entries (``sharding.through``)."""
    keep = model.rows.kept()
    live = range(model.mesh.size) if keep is None else keep
    flat, treedef = tr.flatten(params)
    leaves = [list(x.shards) for x in flat]
    for ts in leaves:
        for i in live:
            ts[i] = ts[i].detach().requires_grad_()
    gp = tr.unflatten(treedef, [shd.Sharded(x.placement, ts)
                                for x, ts in zip(flat, leaves)])
    with torch.enable_grad():
        parts = model.loss_parts(gp, batch, n_moe_groups=n_moe_groups)
        loss, metrics = model.combine_loss(parts, parts["n"],
                                           parts.get("mtp_n"))
        got = torch.autograd.grad(
            loss, [ts[i] for ts in leaves for i in live], allow_unused=True)
    it = iter(got)
    grads = []
    for x, ts in zip(flat, leaves):
        g = {i: torch.zeros_like(ts[i]) if (gt := next(it)) is None else gt
             for i in live}
        for group in x.placement.replicas():
            mine = [i for i in group if i in g]
            if len(group) > 1 and mine:
                summed = collectives.all_reduce_sum(
                    [g.get(i, ts[i]) for i in group],
                    [ts[i].device for i in mine], at=mine)
                taken = set()
                for i, t in zip(mine, summed):
                    g[i] = t.clone() if id(t) in taken else t
                    taken.add(id(t))
        grads.append(shd.Sharded(x.placement, [g.get(i, t) for i, t in
                                               enumerate(ts)]))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics,
            shd.through(tr.unflatten(treedef, grads), keep))


# --- the train step --------------------------------------------------------------

def make_train_step(model: Model, optimizer: AdamW, *,
                    num_microbatches: int = 1, n_moe_groups: int = 1):
    """``train_step(state, batch) -> (state, metrics)``. ``batch`` leaves
    are (B, S), or (M, B/M, S) with ``num_microbatches`` M > 1, as numpy
    arrays or tensors; the state's tensors are updated in place. A model
    on a mesh of several entries trains a placed state
    (:func:`jit_train_step`); where only some of its data rows compute
    (``model.rows.live``), the optimizer updates their entries
    (``sharding.through``)."""
    loss_grads = placed_loss_and_grads if model.sharded else loss_and_grads
    keep = model.rows.kept() if model.sharded else None

    def grads_of(params, mb):
        return loss_grads(model, params, mb, n_moe_groups=n_moe_groups)

    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        if not isinstance(batch["tokens"], torch.Tensor):
            batch = to_device(batch, dev)
        if num_microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            g_acc, loss_sum = None, torch.zeros((), dtype=torch.float32,
                                                device=dev)
            for i in range(num_microbatches):
                l, _, g = grads_of(params, {k: v[i] for k, v in
                                            batch.items()})
                if g_acc is None:
                    g_acc = shd.map_tensors(lambda t: t.float(), g)
                else:
                    shd.map_tensors(lambda a, b: a.add_(b.float()), g_acc, g)
                loss_sum = loss_sum + l
                del g
            inv = 1.0 / num_microbatches
            grads = shd.map_tensors(lambda t: (t * inv).to(torch.bfloat16),
                                    g_acc)
            del g_acc
            loss = loss_sum * inv
            metrics = {"loss": loss}
        # in place: the state's tensors are the updated ones
        _, _, opt_metrics = optimizer.update(
            grads, shd.through(state["opt"], keep),
            shd.through(params, keep), state["step"])
        del grads
        metrics = {**metrics, **opt_metrics}
        new_state = {"step": state["step"] + 1, "params": params,
                     "opt": state["opt"]}
        return new_state, {k: v for k, v in metrics.items() if v.dim() == 0}

    return train_step


def on_mesh(model: Model, mesh: Mesh, rules: shd.ShardingRules) -> Model:
    """``model`` on ``mesh`` under ``rules`` (itself where it is)."""
    if model.mesh == mesh and model.rules == rules:
        return model
    return Model(model.cfg, mesh=mesh, rules=rules)


def jit_train_step(model: Model, optimizer: AdamW, mesh: Mesh,
                   rules: shd.ShardingRules, shape, *,
                   n_moe_groups: int = 1):
    """The train step on ``mesh`` for a shape cell (the reference's name:
    PyTorch runs it eagerly), on a state placed as
    :func:`train_state_shardings` says (plain tensors on a mesh of one
    entry)."""
    return make_train_step(on_mesh(model, mesh, rules), optimizer,
                           num_microbatches=shape.num_microbatches,
                           n_moe_groups=n_moe_groups)


# --- serving -----------------------------------------------------------------------

def make_decode_step(model: Model):
    def serve_step(params, cache, tokens):
        return model.decode(params, cache, tokens)
    return serve_step


def make_prefill(model: Model, *, max_seq: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_seq=max_seq)
    return prefill_step


def cache_shardings(model: Model, mesh: Mesh, rules: shd.ShardingRules,
                    batch: int, max_seq: int):
    """The decode cache's placements (``pos``: a replicated int, on the
    mesh's first device)."""
    m = on_mesh(model, mesh, rules)
    return {"stacks": m.cache_placements(batch, max_seq),
            "pos": mesh.flat()[0]}


def jit_decode_step(model: Model, mesh: Mesh, rules: shd.ShardingRules,
                    shape):
    """The decode step on ``mesh``: placed params and cache (as
    :func:`cache_shardings` says) -> (whole logits, cache)."""
    return make_decode_step(on_mesh(model, mesh, rules))


def jit_prefill(model: Model, mesh: Mesh, rules: shd.ShardingRules, shape):
    """The prefill on ``mesh`` at ``shape.seq_len`` positions: placed
    params, whole inputs -> (whole last logits, placed cache)."""
    return make_prefill(on_mesh(model, mesh, rules), max_seq=shape.seq_len)

