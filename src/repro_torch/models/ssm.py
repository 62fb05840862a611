"""Mamba-2 block: state-space duality (SSD) chunked scan, the JAX
package's ``models/ssm.py`` in PyTorch.

Prefill / forward uses the chunked SSD algorithm with the reference's
chunking: quadratic attention-like work within chunks of length Q plus a
sequential inter-chunk recurrence of S / Q steps, the state (B, H, P, N) in
fp32. Decode is the O(1) recurrent update; its cache is the conv window
(B, K - 1, C) and that state, bounded in sequence length.
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
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.conv_kernel, conv_ch), (None, "ssm_inner")),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), init="zeros"),
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
    return {
        "conv": TensorSpec((n_layers, batch, s.conv_kernel - 1, conv_ch),
                           dtype),
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
