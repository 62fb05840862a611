"""Griffin recurrent block: temporal conv + RG-LRU gated linear recurrence,
the JAX package's ``models/rglru.py`` in PyTorch.

The recurrence h_t = a_t * h_{t-1} + b_t runs as a log-depth scan in fp32:
:func:`associative_scan` is ``lax.associative_scan``'s own recursion (pair
up neighbours, scan the pairs, fill in the even positions), so the two
packages combine the same terms in the same order. Each combine is a
multiply and an add, rounded apart here; XLA may contract them into one
fused multiply-add, so ``h`` differs from the reference's by a few fp32
ulps (the fp32 parity tests hold it to rtol 1e-5). Decode is the O(1)
recurrent update; the state is (B, W) plus a conv tail.

Tensor parallelism (``*_tp``) splits the recurrence width (``mlp``) over
the model axis: each shard holds its channels of ``in_x`` / ``in_gate`` /
the conv / ``out`` and its rows of ``w_a`` / ``w_i``, so its gate
products are partial sums over input channels. They are summed across
the shards and each shard keeps its own channels (a reduce-scatter, in
fp32); the conv, the gates' nonlinearities and the scan are per channel.
The output projection's partial sums are all-reduced.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, TensorSpec
from repro_torch.models.ssm import softplus

_C = 8.0  # Griffin's fixed recurrence sharpness constant


def rglru_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.hybrid.lru_width or d
    k = cfg.hybrid.conv_width
    return {
        "in_x": ParamSpec((d, w), ("embed", "mlp")),
        "in_gate": ParamSpec((d, w), ("embed", "mlp")),
        "conv_w": ParamSpec((k, w), (None, "mlp")),
        "conv_b": ParamSpec((w,), ("mlp",), init="zeros"),
        "w_a": ParamSpec((w, w), ("mlp", None)),
        "b_a": ParamSpec((w,), (None,), init="zeros"),
        "w_i": ParamSpec((w, w), ("mlp", None)),
        "b_i": ParamSpec((w,), (None,), init="zeros"),
        "lam": ParamSpec((w,), (None,), init="lambda_lru",
                         dtype=torch.float32),
        "out": ParamSpec((w, d), ("mlp", "embed")),
    }


def _gates(params, x, pre=None, own=slice(None)):
    """x (..., W) -> (log_a, gated input), both fp32. ``pre`` = the gate
    products (x @ w_a, x @ w_i) in fp32 where a tensor-parallel shard
    summed them; ``own`` its channels of the replicated b_a / b_i / lam."""
    if pre is None:
        pre = (torch.einsum("...w,wk->...k", x, params["w_a"]).float(),
               torch.einsum("...w,wk->...k", x, params["w_i"]).float())
    r = torch.sigmoid(pre[0] + params["b_a"][own])
    i = torch.sigmoid(pre[1] + params["b_i"][own])
    log_a = -_C * r * softplus(params["lam"][own])          # (..., W) <= 0
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * (i * x.float())
    return log_a, gated


def _conv(x, w, b):
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:xp.shape[1] - (k - 1 - i), :] * w[i] for i in range(k))
    return out + b


def _combine(left, right):
    a_l, b_l = left
    a_r, b_r = right
    return a_l * a_r, b_l * a_r + b_r


def associative_scan(a, b):
    """Inclusive scan of the pairs (a_t, b_t) along dim 1 under
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r), by
    ``lax.associative_scan``'s recursion. Returns (A, h) with h_t =
    a_t h_{t-1} + b_t from h_{-1} = 0."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = ea, oa
    out_b[:, 0::2], out_b[:, 1::2] = eb, ob
    return out_a, out_b


def rglru_forward(params, x, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence recurrent block. x (B, S, d) -> (B, S, d) (and the
    decode state {'conv', 'h'} with ``return_state``)."""
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["in_gate"]).float(),
                  approximate="tanh")
    xb_raw = torch.einsum("bsd,dw->bsw", x, params["in_x"])
    xb = _conv(xb_raw, params["conv_w"], params["conv_b"])
    log_a, bterm = _gates(params, xb)
    _, h = associative_scan(torch.exp(log_a), bterm)
    y = (gate * h).to(x.dtype)
    out = torch.einsum("bsw,wd->bsd", y, params["out"])
    if return_state:
        k = cfg.hybrid.conv_width
        tail = xb_raw[:, -(k - 1):, :]
        if tail.shape[1] < k - 1:
            tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
        return out, {"conv": tail, "h": h[:, -1]}
    return out


# --- decode ---------------------------------------------------------------------

def rglru_cache_spec(cfg: ModelConfig, batch: int, n_layers: int,
                     dtype=torch.bfloat16) -> dict:
    w = cfg.hybrid.lru_width or cfg.d_model
    k = cfg.hybrid.conv_width
    return {
        "conv": TensorSpec((n_layers, batch, k - 1, w), dtype),
        "h": TensorSpec((n_layers, batch, w), torch.float32),
    }


def rglru_decode(params, x, layer_cache, cfg: ModelConfig):
    """Single-token update. x (B, 1, d). The cache's tensors {'conv', 'h'}
    are updated in place; returns (y, that cache)."""
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["in_gate"]).float(),
                  approximate="tanh")[:, 0]
    xb = torch.einsum("bsd,dw->bsw", x, params["in_x"])[:, 0]   # (B, W)
    conv = layer_cache["conv"]
    hist = torch.cat([conv, xb[:, None].to(conv.dtype)], dim=1)
    xc = torch.einsum("bkw,kw->bw", hist.float(), params["conv_w"].float()) \
        + params["conv_b"].float()
    log_a, bterm = _gates(params, xc.to(x.dtype))
    h = layer_cache["h"] * torch.exp(log_a) + bterm
    y = (gate * h).to(x.dtype)[:, None]
    out = torch.einsum("bsw,wd->bsd", y, params["out"])
    conv.copy_(hist[:, 1:])
    layer_cache["h"].copy_(h)
    return out, layer_cache


# --- tensor parallelism over the model axis ------------------------------------

def _width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def _gates_tp(ps, xbs, group):
    """Each shard's (log_a, gated input) from its conv outputs: the gate
    products summed across the shards in fp32, each shard keeping its
    own channels."""
    n = xbs[0].shape[-1]
    pre_a = group.scatter_sum([torch.einsum("...w,wk->...k", x, p["w_a"])
                               .float() for p, x in zip(ps, xbs)], -1)
    pre_i = group.scatter_sum([torch.einsum("...w,wk->...k", x, p["w_i"])
                               .float() for p, x in zip(ps, xbs)], -1)
    return [_gates(p, x, (a, i), slice(j * n, (j + 1) * n))
            for j, (p, x, a, i) in enumerate(zip(ps, xbs, pre_a, pre_i))]


def rglru_forward_tp(ps, xs, cfg: ModelConfig, group, *,
                     return_state: bool = False):
    """:func:`rglru_forward` with the recurrence width split over the
    shards."""
    if ps[0]["in_x"].shape[1] == _width(cfg):
        outs = [rglru_forward(p, x, cfg, return_state=return_state)
                for p, x in zip(ps, xs)]
        if return_state:
            return [o[0] for o in outs], [o[1] for o in outs]
        return outs
    gates, raws, xbs = [], [], []
    for p, x in zip(ps, xs):
        gates.append(F.gelu(torch.einsum("bsd,dw->bsw", x, p["in_gate"])
                            .float(), approximate="tanh"))
        raw = torch.einsum("bsd,dw->bsw", x, p["in_x"])
        raws.append(raw)
        xbs.append(_conv(raw, p["conv_w"], p["conv_b"]))
    outs, states = [], []
    for p, x, gate, (log_a, bterm) in zip(ps, xs, gates,
                                          _gates_tp(ps, xbs, group)):
        _, h = associative_scan(torch.exp(log_a), bterm)
        outs.append(torch.einsum("bsw,wd->bsd", (gate * h).to(x.dtype),
                                 p["out"]))
        states.append(h[:, -1])
    outs = group.sum(outs)
    if not return_state:
        return outs
    k = cfg.hybrid.conv_width
    caches = []
    for raw, h in zip(raws, states):
        tail = raw[:, -(k - 1):, :]
        if tail.shape[1] < k - 1:
            tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
        caches.append({"conv": tail, "h": h})
    return outs, caches


def rglru_decode_tp(ps, xs, caches, cfg: ModelConfig, group):
    """:func:`rglru_decode` with the width split over the shards; each
    shard's cache (its channels) updated in place."""
    if ps[0]["in_x"].shape[1] == _width(cfg):
        return [rglru_decode(p, x, c, cfg)[0]
                for p, x, c in zip(ps, xs, caches)]
    gates, hists, xcs = [], [], []
    for p, x, c in zip(ps, xs, caches):
        gates.append(F.gelu(torch.einsum("bsd,dw->bsw", x, p["in_gate"])
                            .float(), approximate="tanh")[:, 0])
        xb = torch.einsum("bsd,dw->bsw", x, p["in_x"])[:, 0]
        hist = torch.cat([c["conv"], xb[:, None].to(c["conv"].dtype)], dim=1)
        hists.append(hist)
        xc = torch.einsum("bkw,kw->bw", hist.float(), p["conv_w"].float()) \
            + p["conv_b"].float()
        xcs.append(xc.to(x.dtype))
    outs = []
    for p, x, c, gate, hist, (log_a, bterm) in zip(
            ps, xs, caches, gates, hists, _gates_tp(ps, xcs, group)):
        h = c["h"] * torch.exp(log_a) + bterm
        outs.append(torch.einsum("bsw,wd->bsd",
                                 (gate * h).to(x.dtype)[:, None], p["out"]))
        c["conv"].copy_(hist[:, 1:])
        c["h"].copy_(h)
    return group.sum(outs)
