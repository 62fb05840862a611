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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def _routing(params, x_flat, cfg: ModelConfig):
    """x_flat (G, T, d) -> (weights (G, T, K) fp32, ids (G, T, K) int64,
    aux loss)."""
    m = cfg.moe
    logits = torch.einsum("gtd,de->gte", x_flat.float(), params["router"])
    if m.router == "sigmoid":
        scores = torch.sigmoid(logits)
        _, ids = top_k(scores + params["router_bias"], m.top_k)
        w = torch.gather(scores, -1, ids)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        aux = torch.zeros((), dtype=torch.float32, device=x_flat.device)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = top_k(probs, m.top_k)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        # Switch-style load-balance loss: E * sum_e f_e * P_e
        pe = probs.mean(dim=(0, 1))
        fe = torch.bincount(ids.reshape(-1), minlength=m.n_experts).float()
        fe = fe / ids.numel()
        aux = m.aux_loss_weight * m.n_experts * torch.sum(fe * pe)
    return w, ids, aux


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


def moe_ffn(params, x, cfg: ModelConfig, *, n_groups: int = 1):
    """x (B, S, d) -> (y, aux_loss). Capacity dispatch + expert GLU FFN
    (+ the shared experts)."""
    m = cfg.moe
    b, s, d = x.shape
    t_total = b * s
    g = n_groups if t_total % n_groups == 0 else 1
    tg = t_total // g
    k, e = m.top_k, m.n_experts
    x_flat = x.reshape(g, tg, d)
    w, ids, aux = _routing(params, x_flat, cfg)
    cap = capacity(tg, cfg)
    rows = torch.arange(tg, device=x.device).repeat_interleave(k)
    ys = []
    for xg, idg, wg in zip(x_flat, ids, w):
        dest, ok = _dispatch_indices(idg.reshape(-1), e, cap)
        # one spare row takes every dropped assignment, then goes
        buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
        buf[dest] = xg[rows]
        out = _experts(params, buf[:-1].reshape(e, cap, d), x.dtype)
        out = out.reshape(e * cap, d)[dest.clamp(max=e * cap - 1)]
        gathered = torch.where(ok[:, None], out, 0)
        contrib = (gathered * wg.reshape(-1, 1).to(x.dtype)).reshape(tg, k, d)
        # the reference's segment_sum adds a token's K terms in (token, k)
        # order, in x's dtype
        yg = contrib[:, 0]
        for j in range(1, k):
            yg = yg + contrib[:, j]
        ys.append(yg)
    y = torch.stack(ys).reshape(b, s, d)
    if m.n_shared:
        sg = torch.einsum("bsd,df->bsf", x, params["shared_gate"])
        su = torch.einsum("bsd,df->bsf", x, params["shared_up"])
        sh = F.silu(sg.float()).to(x.dtype) * su
        y = y + torch.einsum("bsf,fd->bsd", sh, params["shared_down"])
    return y, aux
