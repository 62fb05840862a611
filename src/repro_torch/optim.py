"""Optimizer: AdamW with fp32 or bf16 state, LR schedules, global-norm
clipping and int8 error-feedback gradient compression — the JAX
package's ``optim.py`` (``:21-165``) in PyTorch.

The state mirrors the parameter tree leaf for leaf (``{"m", "v"}``, plus
``"err"`` with compression), so checkpoints and elastic restore treat
(params, m, v) alike. The arithmetic is the reference's, operation for
operation, in fp32: ``m = b1 * m + (1 - b1) * g``, bias corrections from
``t = step + 1`` in fp32, decoupled weight decay on leaves of two or more
dims only, the cast back to the param and state dtypes; the schedule is
evaluated on fp32 tensors.

:meth:`AdamW.update` works in place, leaf by leaf, and a stacked leaf
(a leading layers or experts axis) one slice at a time: the fp32
temporaries of an update never exceed one slice's. StarCoder2-3B's
(30, 3072, 12288) MLP leaf is 4.5 GB per fp32 temporary whole and 151 MB
per layer, so its update peaks at about 1 GB above the state, where a
whole-tree map would need tens of GB of an 80 GB card.

On a placed state (``sharding.Sharded`` leaves, a mesh's train state)
each shard updates its own block with the same arithmetic. The global
norm counts each block once — a leaf split over the mesh once per block,
a leaf replicated over an axis once, not once per copy — and int8
compression's per-tensor scale is the maximum over the whole leaf
(``all_max`` across its shards); the scalars every shard reads are
broadcast from the first shard's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import tree as tr
from repro_torch.core import collectives
from repro_torch.kernels import ops
from repro_torch.sharding import Sharded, map_tensors, tensors


# --- schedules ---------------------------------------------------------------

def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> Callable:
    """Linear warmup to ``base_lr``, then cosine decay to ``min_ratio`` of
    it; ``step`` is an int tensor (or int), the result a 0-d fp32 tensor
    on its device."""
    def sched(step):
        step = _f32(step)
        warm = ops.div(step + 1.0, float(max(warmup_steps, 1)))
        prog = ops.div(step - warmup_steps,
                       float(max(total_steps - warmup_steps, 1)))
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup_steps, warm, cos)
    return sched


def constant_lr(base_lr: float) -> Callable:
    return lambda step: torch.full((), base_lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


# --- global-norm clip -----------------------------------------------------------

def _slices(t: torch.Tensor):
    """``t`` whole, or one leading-axis slice at a time for a stacked leaf
    (three or more dims): elementwise work is the same either way, and
    the fp32 temporaries stay one slice's size."""
    return t.unbind(0) if t.dim() >= 3 else (t,)


def _sq_sum(t: torch.Tensor) -> torch.Tensor:
    acc = None
    for s in _slices(t):
        part = torch.sum(torch.square(s.float()))
        acc = part if acc is None else acc + part
    return acc


def _leaf_sq_sum(x) -> torch.Tensor:
    """A leaf's sum of squares; a placed leaf's blocks each counted once
    (the first holder of each), summed in block order; blocks that a
    view of the placement sees at one entry (``sharding.through``) are
    summed there once and take part once each."""
    if not isinstance(x, Sharded):
        return _sq_sum(x)
    sums: dict = {}
    for g in x.placement.replicas():
        if g[0] not in sums:
            sums[g[0]] = _sq_sum(x.shards[g[0]])
    parts = [sums[g[0]] for g in x.placement.replicas()]
    return collectives.all_reduce_sum(parts, [x.device])[0]


def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm over every leaf, leaves in the reference's order (on
    the first leaf's device, the mesh's first device for a placed
    tree)."""
    sums = [_leaf_sq_sum(x) for x in tr.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor divided by a tensor: PyTorch computes ``float / tensor`` as
    # a reciprocal times the float, one rounding more than the reference
    scale = torch.full_like(norm, max_norm) / (norm + 1e-9)
    return torch.minimum(torch.ones_like(scale), scale)


def clip_by_global_norm(tree, max_norm: float):
    """``(clipped tree, norm)``: every leaf times ``min(1, max_norm /
    (norm + 1e-9))`` in fp32, cast back to its dtype (new tensors)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return map_tensors(lambda x: (x.float() * scale.to(x.device))
                       .to(x.dtype), tree), norm


# --- AdamW -----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: Any = torch.float32   # m / v dtype; bf16 halves their bytes
    compress_grads: bool = False       # int8 error feedback on the gradients


class AdamW:
    """AdamW over trees; state = ``{"m", "v"[, "err"]}`` mirroring the
    params."""

    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg
        self.schedule = warmup_cosine(cfg.lr, cfg.warmup_steps,
                                      cfg.total_steps)

    def _state(self, params, device=None):
        c = self.cfg

        def zeros(dtype):
            return lambda p: torch.zeros(p.shape, dtype=dtype,
                                         device=device or p.device)
        state = {"m": map_tensors(zeros(c.state_dtype), params),
                 "v": map_tensors(zeros(c.state_dtype), params)}
        if c.compress_grads:
            state["err"] = map_tensors(zeros(torch.float32), params)
        return state

    def init(self, params):
        return self._state(params)

    def init_abstract(self, param_specs_abstract):
        """The state as meta tensors (shapes and dtypes, no storage), from
        a tree of anything with a ``.shape`` (meta tensors, TensorSpecs)."""
        return self._state(param_specs_abstract, device="meta")

    @torch.no_grad()
    def update(self, grads, state, params, step):
        """One step, in place: ``params`` and ``state``'s tensors are
        overwritten (and ``grads`` too, with compression). ``step`` is the
        0-d int step before this update. Returns ``(params, state,
        {"grad_norm", "lr"})`` with the same tensors."""
        c = self.cfg
        g_leaves = tr.leaves(grads)
        if c.compress_grads:
            for g, e in zip(g_leaves, tr.leaves(state["err"])):
                _compress_into(g, e)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, c.clip_norm)
        lr = self.schedule(step)
        t = _f32(step) + 1.0
        bc1 = 1.0 - torch.pow(c.b1, t)
        bc2 = 1.0 - torch.pow(c.b2, t)
        scalars: dict = {}

        def on(dev):
            # the step's scalars, one copy per device (the broadcast)
            key = str(dev)
            if key not in scalars:
                scalars[key] = [collectives.broadcast(x, [dev])[0]
                                for x in (scale, lr, bc1, bc2)]
            return scalars[key]
        for g, m, v, p in zip(g_leaves, tr.leaves(state["m"]),
                              tr.leaves(state["v"]), tr.leaves(params)):
            decay = len(p.shape) >= 2     # the whole leaf's rank decides
            for gt, mt, vt, pt in zip(tensors(g), tensors(m), tensors(v),
                                      tensors(p)):
                sc, lr_d, bc1_d, bc2_d = on(pt.device)
                for gs, ms, vs, ps in zip(_slices(gt), _slices(mt),
                                          _slices(vt), _slices(pt)):
                    # the clip's rounding to the gradient's dtype, then fp32
                    g32 = (gs.float() * sc).to(gs.dtype).float()
                    m_new = c.b1 * ms.float() + (1 - c.b1) * g32
                    v_new = c.b2 * vs.float() + (1 - c.b2) * torch.square(g32)
                    delta = (m_new / bc1_d) / (torch.sqrt(v_new / bc2_d)
                                               + c.eps)
                    p32 = ps.float()
                    if decay:
                        delta = delta + c.weight_decay * p32
                    ps.copy_(p32 - lr_d * delta)
                    ms.copy_(m_new)
                    vs.copy_(v_new)
        return params, state, {"grad_norm": gnorm, "lr": lr}


# --- int8 error-feedback compression ------------------------------------------------

def quantize_int8(x):
    """Symmetric per-tensor int8: ``(q, scale)``. A placed tensor's scale
    is its whole value's (the maximum over its shards), and ``q`` is
    placed alike."""
    amaxes = collectives.all_max([torch.max(torch.abs(t.float()))
                                  for t in tensors(x)])
    scales = [ops.div(torch.clamp(a, min=1e-12), 127.0) for a in amaxes]
    qs = [torch.clamp(torch.round(t.float() / sc), -127, 127).to(torch.int8)
          for t, sc in zip(tensors(x), scales)]
    if isinstance(x, Sharded):
        return Sharded(x.placement, qs), scales[0]
    return qs[0], scales[0]


def dequantize_int8(q, scale):
    return q.float() * scale


def _amax(g, e) -> torch.Tensor:
    amax = None
    for gs, es in zip(_slices(g), _slices(e)):
        part = torch.max(torch.abs(gs.float() + es))
        amax = part if amax is None else torch.maximum(amax, part)
    return amax


def _compress_into(g, e):
    """One leaf's round trip in place: ``g`` <- its int8 round trip (in
    its dtype), ``e`` <- the residual carried to the next step. The scale
    is the whole leaf's (a placed leaf's the maximum over its shards);
    the work goes a slice at a time."""
    gts, ets = tensors(g), tensors(e)
    amaxes = collectives.all_max([_amax(gt, et) for gt, et in zip(gts, ets)])
    for gt, et, amax in zip(gts, ets, amaxes):
        scale = ops.div(torch.clamp(amax, min=1e-12), 127.0)
        for gs, es in zip(_slices(gt), _slices(et)):
            target = gs.float() + es
            q = torch.clamp(torch.round(target / scale), -127,
                            127).to(torch.int8)
            deq = dequantize_int8(q, scale)
            gs.copy_(deq)
            es.copy_(target - deq)


def compress_decompress(grads, err):
    """``(grads', err')``: each leaf int8-quantized with error feedback
    (1-bit-Adam style residuals) — what would cross a data-parallel
    interconnect — as new tensors; the scale is per leaf."""
    g2 = map_tensors(torch.clone, grads)
    e2 = map_tensors(torch.clone, err)
    for g, e in zip(tr.leaves(g2), tr.leaves(e2)):
        _compress_into(g, e)
    return g2, e2
