"""Mamba-2 block: state-space duality (SSD) chunked scan, the JAX
package's ``models/ssm.py`` in PyTorch.

Prefill / forward uses the chunked SSD algorithm with the reference's
chunking: quadratic attention-like work within chunks of length Q plus a
sequential inter-chunk recurrence of S / Q steps, the state (B, H, P, N) in
fp32. Decode is the O(1) recurrent update; its cache is the conv window
(B, K - 1, C) and that state, bounded in sequence length.

Tensor parallelism (``*_tp``) splits ``ssm_inner`` over the model axis by
head: ``in_proj``'s columns pack z | x | B | C | dt side by side (and
``conv_w`` / ``conv_b`` / the conv cache x | B | C), so they are split
segment by segment (``ParamSpec.segments``) and each shard holds its own
channels of z and x, its heads' dt, its block of B and C, and its heads'
``A_log`` / ``D`` / ``dt_bias`` (replicated leaves it indexes). B and C are
per group: where the groups do not divide the shards, the shards' conv
outputs of B and C are all-gathered and each shard keeps the groups its
heads read. The gated RMSNorm averages over all of ``d_inner``, so each
shard's sum of squares is all-reduced before the scale
(:func:`gated_norm_tp`). The output projection's partial sums are
all-reduced.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamSpec, TensorSpec


def softplus(x):
    """``jax.nn.softplus``'s formula, log(1 + e^x) as max(x, 0) +
    log1p(e^-|x|)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.headdim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nheads, conv_ch


def ssm_specs(cfg: ModelConfig) -> dict:
    s, d_in, nheads, conv_ch = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nheads   # z, x, B, C, dt
    gn = s.n_groups * s.d_state
    conv_seg = (d_in, gn, gn)
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_inner"),
                             segments=(d_in, d_in, gn, gn, nheads)),
        "conv_w": ParamSpec((s.conv_kernel, conv_ch), (None, "ssm_inner"),
                            segments=conv_seg),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), init="zeros",
                            segments=conv_seg),
        "a_log": ParamSpec((nheads,), (None,), init="a_log",
                           dtype=torch.float32),
        "d_skip": ParamSpec((nheads,), (None,), init="ones",
                            dtype=torch.float32),
        "dt_bias": ParamSpec((nheads,), (None,), init="dt_bias",
                             dtype=torch.float32),
        "norm": ParamSpec((d_in,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    s, d_in, nheads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, nheads], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B, S, C), w (K, C): the K taps summed in
    order in x's dtype, as the reference sums them."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:xp.shape[1] - (k - 1 - i), :] * w[i] for i in range(k))
    return out + b


def ssd_chunked(x, dt, a, bb, cc, d_skip, *, chunk: int, init_state=None):
    """SSD scan. x (B, S, H, P), dt (B, S, H) fp32, a (H,), bb / cc
    (B, S, G, N). Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) fp32). One chunk at a time carries the inter-chunk state;
    peak memory is one chunk's (B, Q, Q, H) score tensor."""
    b, s, h, p = x.shape
    g, n = bb.shape[2], bb.shape[3]
    q = min(chunk, s)
    while s % q:
        q -= 1
    rep = h // g
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for i in range(0, s, q):
        xc, dtc = x[:, i:i + q], dt[:, i:i + q]
        bc = torch.repeat_interleave(bb[:, i:i + q], rep, dim=2)
        cc_ = torch.repeat_interleave(cc[:, i:i + q], rep, dim=2)
        da = dtc * a[None, None, :]                          # (B, Q, H)
        cum = torch.cumsum(da, dim=1)
        seg = cum[:, -1, :]                                  # (B, H)
        # intra-chunk
        li = cum[:, :, None, :] - cum[:, None, :, :]
        ldec = torch.where(mask[None, :, :, None], torch.exp(li), 0.0)
        scores = torch.einsum("bqhk,bthk->bqth", cc_, bc)
        xdt = xc * dtc[..., None]
        y_diag = torch.einsum("bqth,bqth,bthp->bqhp", scores.float(), ldec,
                              xdt.float())
        # inter-chunk: read the previous state
        decay_in = torch.exp(cum)
        y_off = torch.einsum("bqhn,bqh,bhpn->bqhp", cc_.float(), decay_in,
                             hprev)
        # this chunk's contribution to the running state
        decay_to_end = torch.exp(seg[:, None, :] - cum)
        cst = torch.einsum("bqhn,bqh,bqhp->bhpn", bc.float(), decay_to_end,
                           xdt.float())
        hprev = hprev * torch.exp(seg)[:, :, None, None] + cst
        y = y_diag + y_off + xc.float() * d_skip[None, None, :, None]
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), hprev


def mamba2_forward(params, x, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence mamba2 block. x (B, S, d) -> (B, S, d) (and the decode
    state {'conv', 'ssm'} with ``return_state``)."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    zxbcdt = torch.einsum("bsd,dk->bsk", x, params["in_proj"])
    z, xs, bb, cc, dt = _split_proj(cfg, zxbcdt)
    xbc_raw = torch.cat([xs, bb, cc], dim=-1)
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
                 .float()).to(x.dtype)
    gn = s.n_groups * s.d_state
    xs, bb, cc = torch.split(xbc, [d_in, gn, gn], dim=-1)
    dt = softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    xh = xs.reshape(*xs.shape[:2], nheads, s.headdim)
    bh = bb.reshape(*bb.shape[:2], s.n_groups, s.d_state)
    ch = cc.reshape(*cc.shape[:2], s.n_groups, s.d_state)
    y, h_final = ssd_chunked(xh, dt, a, bh, ch, params["d_skip"],
                             chunk=s.chunk_size)
    y = y.reshape(*x.shape[:2], d_in)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(x.dtype),
                cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, params["out_proj"])
    if return_state:
        k = s.conv_kernel
        tail = xbc_raw[:, -(k - 1):, :]
        if tail.shape[1] < k - 1:   # S < K-1: left-pad with zeros
            tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
        return out, {"conv": tail, "ssm": h_final}
    return out


# --- decode ---------------------------------------------------------------------

def mamba2_cache_spec(cfg: ModelConfig, batch: int, n_layers: int,
                      dtype=torch.bfloat16) -> dict:
    s, d_in, nheads, conv_ch = _dims(cfg)
    gn = s.n_groups * s.d_state
    return {
        "conv": TensorSpec((n_layers, batch, s.conv_kernel - 1, conv_ch),
                           dtype, segments=(d_in, gn, gn)),
        "ssm": TensorSpec((n_layers, batch, nheads, s.headdim, s.d_state),
                          torch.float32),
    }


def mamba2_decode(params, x, layer_cache, cfg: ModelConfig):
    """Single-token recurrent update. x (B, 1, d). The cache's tensors
    {'conv', 'ssm'} are updated in place; returns (y, that cache)."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    zxbcdt = torch.einsum("bsd,dk->bsk", x, params["in_proj"])
    z, xs, bb, cc, dt = _split_proj(cfg, zxbcdt)
    conv = layer_cache["conv"]
    xbc = torch.cat([xs, bb, cc], dim=-1)[:, 0]              # (B, C)
    conv_hist = torch.cat([conv, xbc[:, None].to(conv.dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", conv_hist.float(),
                            params["conv_w"].float())
    conv_out = F.silu(conv_out + params["conv_b"].float())
    gn = s.n_groups * s.d_state
    xs_c, bb_c, cc_c = torch.split(conv_out.to(x.dtype), [d_in, gn, gn],
                                   dim=-1)
    dt1 = softplus(dt[:, 0].float() + params["dt_bias"])     # (B, H)
    a = -torch.exp(params["a_log"])
    da = torch.exp(dt1 * a[None, :])                         # (B, H)
    xh = xs_c.reshape(-1, nheads, s.headdim)
    rep = nheads // s.n_groups
    bh = torch.repeat_interleave(bb_c.reshape(-1, s.n_groups, s.d_state),
                                 rep, dim=1)
    chh = torch.repeat_interleave(cc_c.reshape(-1, s.n_groups, s.d_state),
                                  rep, dim=1)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt1, xh.float(), bh.float())
    hstate = layer_cache["ssm"] * da[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", chh.float(), hstate)
    y = y + xh.float() * params["d_skip"][None, :, None]
    y = y.reshape(-1, 1, d_in).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(x.dtype),
                cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, params["out_proj"])
    conv.copy_(conv_hist[:, 1:])
    layer_cache["ssm"].copy_(hstate)
    return out, layer_cache


# --- tensor parallelism over the model axis ------------------------------------

def _shard_dims(cfg: ModelConfig, p, n_shards: int):
    """(split, d_in, heads, group block) of a shard's leaves: its inner
    channels, heads and B / C channels."""
    s, d_in, nheads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    split = p["norm"].shape[0] != d_in
    if not split:
        return False, d_in, nheads, gn
    if p["in_proj"].shape[1] * n_shards != 2 * d_in + 2 * gn + nheads:
        raise NotImplementedError("Mamba-2 in_proj and norm split unlike")
    return True, d_in // n_shards, nheads // n_shards, gn // n_shards


def _bc_for_heads(cfg: ModelConfig, group, parts, j: int, heads: int):
    """Shard j's heads' B (or C) channels, (B, S, G_j * N): the shard's
    own groups where the groups divide the shards, else the gathered
    groups its heads read."""
    s = cfg.ssm
    n = group.size
    if s.n_groups % n == 0:
        return parts[j]
    whole = group.gather(parts, -1)[j]
    nheads = heads * n
    per = nheads // s.n_groups                 # heads per group
    first, last = j * heads // per, (j * heads + heads - 1) // per
    if not ((last == first) or (heads % per == 0)):
        raise NotImplementedError(
            f"Mamba-2 shard {j}: heads use groups {first}..{last} unevenly")
    return whole[..., first * s.d_state:(last + 1) * s.d_state]


def gated_norm_tp(ws, ys, zs, d_inner: int, eps: float, group):
    """RMSNorm of ``y * silu(z)`` over all ``d_inner`` channels, each
    shard holding a block of them: every shard's sum of squares is
    all-reduced before the scale, in fp32, cast back to y's dtype."""
    gs = [y * F.silu(z.float()).to(y.dtype) for y, z in zip(ys, zs)]
    sq = group.sum([torch.sum(torch.square(g.float()), dim=-1, keepdim=True)
                    for g in gs])
    return [((g.float() * torch.rsqrt(q / d_inner + eps)) * w.float())
            .to(g.dtype) for g, q, w in zip(gs, sq, ws)]


def _split_local(cfg: ModelConfig, zxbcdt, d_in: int, heads: int, gn: int):
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, heads], dim=-1)


def mamba2_forward_tp(ps, xs, cfg: ModelConfig, group, *,
                      return_state: bool = False):
    """:func:`mamba2_forward` with ``ssm_inner`` split over the shards."""
    s, d_in_full, _, _ = _dims(cfg)
    split, d_in, heads, gn = _shard_dims(cfg, ps[0], group.size)
    if not split:
        outs = [mamba2_forward(p, x, cfg, return_state=return_state)
                for p, x in zip(ps, xs)]
        if return_state:
            return [o[0] for o in outs], [o[1] for o in outs]
        return outs
    zs, xbcs, dts = [], [], []
    for p, x in zip(ps, xs):
        zxbcdt = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
        z, xs_, bb, cc, dt = _split_local(cfg, zxbcdt, d_in, heads, gn)
        xbc_raw = torch.cat([xs_, bb, cc], dim=-1)
        xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
                     .float()).to(x.dtype)
        zs.append(z)
        xbcs.append((xbc_raw, torch.split(xbc, [d_in, gn, gn], dim=-1)))
        dts.append(dt)
    bbs = [b for _, (_, b, _) in xbcs]
    ccs = [c for _, (_, _, c) in xbcs]
    ys, states = [], []
    for j, (p, x) in enumerate(zip(ps, xs)):
        hsl = slice(j * heads, (j + 1) * heads)
        xs_ = xbcs[j][1][0]
        bb = _bc_for_heads(cfg, group, bbs, j, heads)
        cc = _bc_for_heads(cfg, group, ccs, j, heads)
        dt = softplus(dts[j].float() + p["dt_bias"][hsl])
        a = -torch.exp(p["a_log"][hsl])
        xh = xs_.reshape(*xs_.shape[:2], heads, s.headdim)
        g = bb.shape[-1] // s.d_state
        bh = bb.reshape(*bb.shape[:2], g, s.d_state)
        ch = cc.reshape(*cc.shape[:2], g, s.d_state)
        y, h_final = ssd_chunked(xh, dt, a, bh, ch, p["d_skip"][hsl],
                                 chunk=s.chunk_size)
        ys.append(y.reshape(*x.shape[:2], d_in))
        states.append(h_final)
    ys = gated_norm_tp([p["norm"] for p in ps], ys, zs, d_in_full,
                       cfg.norm_eps, group)
    outs = group.sum([torch.einsum("bsk,kd->bsd", y, p["out_proj"])
                      for y, p in zip(ys, ps)])
    if not return_state:
        return outs
    k = s.conv_kernel
    caches = []
    for (raw, _), h in zip(xbcs, states):
        tail = raw[:, -(k - 1):, :]
        if tail.shape[1] < k - 1:
            tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
        caches.append({"conv": tail, "ssm": h})
    return outs, caches


def mamba2_decode_tp(ps, xs, caches, cfg: ModelConfig, group):
    """:func:`mamba2_decode` with ``ssm_inner`` split over the shards;
    each shard's cache holds its channels' conv window and its heads'
    state, updated in place."""
    s, d_in_full, _, _ = _dims(cfg)
    split, d_in, heads, gn = _shard_dims(cfg, ps[0], group.size)
    if not split:
        return [mamba2_decode(p, x, c, cfg)[0]
                for p, x, c in zip(ps, xs, caches)]
    zs, convs, dts = [], [], []
    for p, x, c in zip(ps, xs, caches):
        zxbcdt = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
        z, xs_, bb, cc, dt = _split_local(cfg, zxbcdt, d_in, heads, gn)
        xbc = torch.cat([xs_, bb, cc], dim=-1)[:, 0]
        hist = torch.cat([c["conv"], xbc[:, None].to(c["conv"].dtype)],
                         dim=1)
        out = torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float())
        out = F.silu(out + p["conv_b"].float()).to(x.dtype)
        zs.append(z)
        convs.append((hist, torch.split(out, [d_in, gn, gn], dim=-1)))
        dts.append(dt)
    bbs = [b[:, None] for _, (_, b, _) in convs]
    ccs = [cc[:, None] for _, (_, _, cc) in convs]
    ys = []
    for j, (p, x, c) in enumerate(zip(ps, xs, caches)):
        hsl = slice(j * heads, (j + 1) * heads)
        xs_c = convs[j][1][0]
        bb = _bc_for_heads(cfg, group, bbs, j, heads)[:, 0]
        cc = _bc_for_heads(cfg, group, ccs, j, heads)[:, 0]
        dt1 = softplus(dts[j][:, 0].float() + p["dt_bias"][hsl])
        a = -torch.exp(p["a_log"][hsl])
        da = torch.exp(dt1 * a[None, :])
        xh = xs_c.reshape(-1, heads, s.headdim)
        g = bb.shape[-1] // s.d_state
        rep = heads // g
        bh = torch.repeat_interleave(bb.reshape(-1, g, s.d_state), rep, dim=1)
        chh = torch.repeat_interleave(cc.reshape(-1, g, s.d_state), rep,
                                      dim=1)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt1, xh.float(), bh.float())
        hstate = c["ssm"] * da[:, :, None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", chh.float(), hstate)
        y = y + xh.float() * p["d_skip"][hsl][None, :, None]
        ys.append(y.reshape(-1, 1, d_in).to(x.dtype))
        c["ssm"].copy_(hstate)
        c["conv"].copy_(convs[j][0][:, 1:])
    ys = gated_norm_tp([p["norm"] for p in ps], ys, zs, d_in_full,
                       cfg.norm_eps, group)
    return group.sum([torch.einsum("bsk,kd->bsd", y, p["out_proj"])
                      for y, p in zip(ys, ps)])
