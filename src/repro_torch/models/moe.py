"""Mixture-of-experts FFN with sort-based capacity dispatch, the JAX
package's ``models/moe.py`` in PyTorch.

The T * K (token, expert) assignments are sorted by expert id, each
assignment's rank within its expert comes from the sorted run starts, and
rows scatter into an (E, C, d) buffer; assignments ranked past the
capacity C drop. Combine is the reverse gather weighted by the router's
probabilities. Tokens are pre-grouped into ``n_groups`` independent
dispatch groups.

Which assignments drop is a discrete result and equals the reference's:
the ranking is a stable sort (``torch.argsort(stable=True)``, as the
reference's ``jnp.argsort(stable=True)``), and the top-k selection breaks
ties as ``lax.top_k`` does, lowest expert index first (:func:`top_k`; the
order of ``torch.topk`` on ties is unspecified). The router runs in fp32.

Tensor parallelism (:func:`moe_ffn_tp`) splits ``experts`` over the
model axis (or, where the experts do not divide it, their ``mlp`` width):
the router and its top-k are replicated, so every shard routes every
token alike and builds the same dispatch; each shard runs its own
experts at the unchanged capacity (the others' slots give zeros), the
shared experts are ``mlp``-parallel, and the partial outputs are summed.
The aux loss is the first shard's, counted once. Data rows that route
their own tokens pass their router loads (``load=True``) to
:func:`balance_loss`, which reckons the whole batch's aux loss from their
sum.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.kernels import ops
from repro_torch.models.params import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    f = m.d_ff_expert or cfg.d_ff
    specs = {
        "router": ParamSpec((d, m.n_experts), ("embed", None),
                            dtype=torch.float32),
        "w_gate": ParamSpec((m.n_experts, d, f), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((m.n_experts, d, f), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((m.n_experts, f, d), ("experts", "mlp", "embed")),
    }
    if m.router == "sigmoid":
        specs["router_bias"] = ParamSpec((m.n_experts,), (None,),
                                         init="zeros", dtype=torch.float32)
    if m.n_shared:
        fs = f * m.n_shared
        specs["shared_gate"] = ParamSpec((d, fs), ("embed", "mlp"))
        specs["shared_up"] = ParamSpec((d, fs), ("embed", "mlp"))
        specs["shared_down"] = ParamSpec((fs, d), ("mlp", "embed"))
    return specs


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots per expert: the capacity factor (``REPRO_MOE_CF`` overrides
    the config's) times the even share, at least 8, rounded up to a
    multiple of 8."""
    m = cfg.moe
    cf = ops.moe_capacity_factor(m.capacity_factor)
    c = math.ceil(tokens_per_group * m.top_k * cf / m.n_experts)
    return max(8, -(-c // 8) * 8)


def top_k(x, k: int):
    """(values, indices) of the k largest entries along the last axis,
    largest first and, among equal values, lowest index first — the order
    ``lax.top_k`` gives."""
    idx = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def _routing(params, x_flat, cfg: ModelConfig, load: bool = False):
    """x_flat (G, T, d) -> (weights (G, T, K) fp32, ids (G, T, K) int64,
    aux loss), or with ``load`` the router load in the aux loss's place:
    the router's probabilities summed over the tokens and the assignments
    counted per expert, each (E,) fp32 (None for the sigmoid router,
    which has no aux loss)."""
    m = cfg.moe
    logits = torch.einsum("gtd,de->gte", x_flat.float(), params["router"])
    if m.router == "sigmoid":
        scores = torch.sigmoid(logits)
        _, ids = top_k(scores + params["router_bias"], m.top_k)
        w = torch.gather(scores, -1, ids)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        ld = None
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = top_k(probs, m.top_k)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        ld = (probs.sum(dim=(0, 1)),
              torch.bincount(ids.reshape(-1), minlength=m.n_experts).float())
    if load:
        return w, ids, ld
    n_tokens = x_flat.shape[0] * x_flat.shape[1]
    return w, ids, balance_loss([ld], n_tokens, cfg, x_flat.device)


def balance_loss(loads, n_tokens: int, cfg: ModelConfig, device):
    """The Switch-style load-balance loss E * sum_e f_e * P_e of
    ``n_tokens`` tokens from the router loads of their parts (summed in
    order on ``device``): P_e the mean probability of expert e, f_e its
    share of the assignments. 0 for the sigmoid router."""
    m = cfg.moe
    if loads[0] is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    pe, fe = (collectives.all_reduce_sum([ld[j] for ld in loads],
                                         [device])[0] for j in (0, 1))
    pe = pe / n_tokens
    fe = fe / (n_tokens * m.top_k)
    return m.aux_loss_weight * m.n_experts * torch.sum(fe * pe)


def _dispatch_indices(ids_flat, n_experts: int, cap: int):
    """ids_flat (A,) expert ids of the assignments in (token, k) order ->
    (dest, ok): each assignment's slot in the (E * C) buffer, ranked
    within its expert by a stable sort, and whether it fits (a dropped
    assignment's dest is E * C, one past the buffer)."""
    a = ids_flat.shape[0]
    order = torch.argsort(ids_flat, stable=True)            # sort by expert
    counts = torch.bincount(ids_flat, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(a, device=ids_flat.device) \
        - starts[ids_flat[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    ok = rank < cap
    dest = torch.where(ok, ids_flat * cap + rank, n_experts * cap)
    return dest, ok


def _experts(params, buf, dtype):
    """The expert GLU FFNs on their (E, C, d) slots -> (E, C, d)."""
    gate = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    up = torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    h = F.silu(gate.float()).to(dtype) * up
    return torch.einsum("ecf,efd->ecd", h, params["w_down"])


def moe_ffn(params, x, cfg: ModelConfig, *, n_groups: int = 1,
            expert_offset: int = 0, shared: bool = True, load: bool = False):
    """x (B, S, d) -> (y, aux_loss), or (y, router load) with ``load``.
    Capacity dispatch + expert GLU FFN (+ the shared experts, with
    ``shared``). ``params`` may hold a slice of the experts,
    ``expert_offset`` onwards (a tensor-parallel shard): the routing is
    over all of them, and the slots of experts not held give zeros."""
    m = cfg.moe
    b, s, d = x.shape
    t_total = b * s
    g = n_groups if t_total % n_groups == 0 else 1
    tg = t_total // g
    k, e = m.top_k, m.n_experts
    held = params["w_gate"].shape[0]
    x_flat = x.reshape(g, tg, d)
    w, ids, aux = _routing(params, x_flat, cfg, load=load)
    cap = capacity(tg, cfg)
    rows = torch.arange(tg, device=x.device).repeat_interleave(k)
    ys = []
    for xg, idg, wg in zip(x_flat, ids, w):
        dest, ok = _dispatch_indices(idg.reshape(-1), e, cap)
        # one spare row takes every dropped assignment, then goes
        buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
        buf[dest] = xg[rows]
        lo = expert_offset * cap
        out = _experts(params, buf[lo:lo + held * cap].reshape(held, cap, d),
                       x.dtype).reshape(held * cap, d)
        if held != e:
            out = torch.cat([out.new_zeros((lo, d)), out,
                             out.new_zeros(((e - held) * cap - lo, d))])
        out = out[dest.clamp(max=e * cap - 1)]
        gathered = torch.where(ok[:, None], out, 0)
        contrib = (gathered * wg.reshape(-1, 1).to(x.dtype)).reshape(tg, k, d)
        # the reference's segment_sum adds a token's K terms in (token, k)
        # order, in x's dtype
        yg = contrib[:, 0]
        for j in range(1, k):
            yg = yg + contrib[:, j]
        ys.append(yg)
    y = torch.stack(ys).reshape(b, s, d)
    if m.n_shared and shared:
        y = y + _shared(params, x)
    return y, aux


def _shared(params, x):
    """The shared experts' GLU FFN."""
    sg = torch.einsum("bsd,df->bsf", x, params["shared_gate"])
    su = torch.einsum("bsd,df->bsf", x, params["shared_up"])
    sh = F.silu(sg.float()).to(x.dtype) * su
    return torch.einsum("bsf,fd->bsd", sh, params["shared_down"])


def moe_ffn_tp(ps, hs, cfg: ModelConfig, group, *, n_groups: int = 1,
               load: bool = False):
    """:func:`moe_ffn` on each shard's experts (or expert widths) and its
    share of the shared experts; partial outputs summed across the
    shards. A term that is not split (computed whole on every shard) is
    added on the first shard only. -> (outputs, aux loss of shard 0), or
    with ``load`` shard 0's router load."""
    m = cfg.moe
    f = m.d_ff_expert or cfg.d_ff
    wg = ps[0]["w_gate"]
    routed_split = wg.shape[0] != m.n_experts or wg.shape[2] != f
    shared_split = bool(m.n_shared) and \
        ps[0]["shared_gate"].shape[-1] != f * m.n_shared
    split = routed_split or shared_split
    ys, aux = [], None
    for j, (p, h) in enumerate(zip(ps, hs)):
        y, a = moe_ffn(p, h, cfg, n_groups=n_groups,
                       expert_offset=j * wg.shape[0]
                       if wg.shape[0] != m.n_experts else 0, shared=False,
                       load=load)
        if split and not routed_split and j:
            y = torch.zeros_like(y)
        if m.n_shared and (shared_split or not split or j == 0):
            y = y + _shared(p, h)
        ys.append(y)
        aux = a if aux is None else aux
    return group.reduce(ys, split), aux
