"""Attention mixers: GQA (covers MHA / MQA), sliding-window local
attention, MLA (DeepSeek multi-head latent attention) and encoder
cross-attention — the JAX package's ``models/attention.py`` in PyTorch.

Two execution modes share one parameterization:

- ``full``  : prefill / forward over a whole sequence (causal or
  bidirectional, windowed or not, self or cross).
- ``decode``: one new token against a cache, in plain PyTorch, as the
  reference computes it in XLA outside any kernel. GQA caches (k, v) in a
  ring buffer (a window's length for local attention); MLA caches the
  latent (c_kv, k_rope) and uses the absorbed-matmul formulation. The cache
  is updated in place (the reference returns a fresh one).

Which full-sequence calls take the hand-written kernel
(:func:`takes_flash`): ``ops.flash_attention`` computes causal
self-attention with the mask by sequence index, so a call goes to it only
where that is the same function — causal, self-attention, no window or a
window no shorter than the sequence — and where the kernel takes the head
dim (``flash_attn.HEAD_DIMS``). The reference runs a chunked XLA path
there (bf16 logits and softmax weights); the kernel keeps both in fp32, as
the reference's Pallas kernel does, so the two agree to bf16 rounding, not
bit for bit. Every other call — bidirectional (an encoder), cross, a
window shorter than the sequence, a head dim of 256, MLA's 192 / 128 — takes
the plain chunked path :func:`_chunked_attn`, the reference's arithmetic
step for step; the reference computes all of these in XLA too. So does a
call under autograd (a training forward): the kernel has no backward, and
the reference's training never reaches its Pallas kernel either.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import AttentionKind, ModelConfig
from repro_torch.kernels import flash_attn, ops
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_spec
from repro_torch.models.params import ParamSpec, TensorSpec

NEG_INF = -1e30
DEFAULT_Q_CHUNK = 512


# --- parameter specs ----------------------------------------------------------

def attn_specs(cfg: ModelConfig, *, cross: bool = False) -> dict:
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.attention == AttentionKind.MLA and not cross:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", None)),
            "q_norm": rmsnorm_spec(m.q_lora_rank),
            "wq_b": ParamSpec((m.q_lora_rank, h, qk), (None, "heads", None)),
            "wkv_a": ParamSpec((d, m.kv_lora_rank), ("embed", None)),
            "kv_norm": rmsnorm_spec(m.kv_lora_rank),
            "wk_rope": ParamSpec((d, m.qk_rope_head_dim), ("embed", None)),
            "wk_b": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                              (None, "heads", None)),
            "wv_b": ParamSpec((m.kv_lora_rank, h, m.v_head_dim),
                              (None, "heads", None)),
            "wo": ParamSpec((h, m.v_head_dim, d), ("heads", None, "embed")),
        }
    return {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "qk_dim")),
        "wk": ParamSpec((d, kvh, dh), ("embed", "kv_heads", "qk_dim")),
        "wv": ParamSpec((d, kvh, dh), ("embed", "kv_heads", "qk_dim")),
        "wo": ParamSpec((h, dh, d), ("heads", "qk_dim", "embed")),
    }


# --- masking -------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """(..., S_q, S_k) additive fp32 bias from position comparisons."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=dq.device)
    if causal:
        ok = ok & (dk <= dq)
    if window:
        ok = ok & (dq - dk < window)
    zero = torch.zeros((), dtype=torch.float32, device=dq.device)
    return torch.where(ok, zero, NEG_INF)


def _pick_chunk(s: int, want: int) -> int:
    """Largest divisor of s that is <= want."""
    c = min(want, s)
    while s % c:
        c -= 1
    return max(c, 1)


def _inv_sqrt(n: int) -> float:
    """``1 / sqrt(n)`` rounded as the reference's fp32 arithmetic rounds
    it (a Python float holding an fp32 value, so a product with it is one
    fp32 multiplication on any device)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


# --- the plain chunked softmax-attention core ----------------------------------

def _chunked_attn(q, k, v, q_pos, k_pos, scale: float, *, causal: bool,
                  window: int, q_chunk: int = DEFAULT_Q_CHUNK):
    """q (B, S, KVH, G, D), k (B, T, KVH, D), v (B, T, KVH, Dv) ->
    (B, S, KVH, G, Dv), one query chunk at a time: peak logits memory is
    (B, KVH, G, c, T) for one chunk c. Logits are the product in the
    inputs' dtype, then fp32; the softmax weights round back to v's dtype
    before the second product, as the reference's do."""
    b, s = q.shape[:2]
    c = _pick_chunk(s, q_chunk)
    qp = q_pos.expand(b, s)
    outs = []
    for i in range(0, s, c):
        logits = torch.einsum("bckgd,btkd->bkgct", q[:, i:i + c], k)
        logits = logits.float() * scale
        bias = _mask_bias(qp[:, i:i + c], k_pos, causal=causal, window=window)
        w = torch.softmax(logits + bias[:, None, None], dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgct,btkd->bckgd", w, v))
    return torch.cat(outs, dim=1)


# --- GQA / local / cross ---------------------------------------------------------

def takes_flash(q, k, v, *, causal: bool, window: int, cross: bool) -> bool:
    """Whether a full-sequence call is the function ``ops.flash_attention``
    computes (causal self-attention over the whole sequence) at a head dim
    the kernel takes, and autograd need not differentiate it. q (B, S, H,
    D), k and v (B, T, KVH, D)."""
    s, d = q.shape[1], q.shape[-1]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel has no backward (neither has the reference's: its
        # training computes attention in XLA), so a call autograd must
        # differentiate takes the plain chunked path
        return False
    return (causal and not cross and (not window or s <= window)
            and d in flash_attn.HEAD_DIMS and k.shape[-1] == d
            and v.shape[-1] == d and q.dtype in flash_attn.DTYPES)


def gqa_full(params, x, positions, cfg: ModelConfig, *, causal=True,
             window: int = 0, kv_x=None, kv_positions=None, return_kv=False):
    """Attention over a whole sequence: x (B, S, d) -> (B, S, d) (and the
    post-rope (k, v), each (B, T, KVH, Dh), with ``return_kv``).
    ``kv_x`` (B, T, d) makes it cross-attention (no rope, no mask).

    ``positions`` (B, S) rotate q and k and build the mask; a call that
    :func:`takes_flash` is masked by sequence index instead, so there they
    must be ``0 .. S-1`` on every row, as a prefill's are."""
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kvh
    cross = kv_x is not None
    src = kv_x if cross else x
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", src, params["wk"])
    v = torch.einsum("btd,dhk->bthk", src, params["wv"])
    if not cross and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions if kv_positions is None else kv_positions,
                       cfg.rope_theta)
    if cross:
        kpos = torch.arange(src.shape[1], dtype=torch.int32,
                            device=x.device)[None, :]
        causal, window = False, 0
    else:
        kpos = positions if kv_positions is None else kv_positions
    if kv_positions is None and takes_flash(q, k, v, causal=causal,
                                            window=window, cross=cross):
        out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous())
        y = torch.einsum("bhsk,hkd->bsd", out, params["wo"])
    else:
        qg = q.reshape(*q.shape[:2], kvh, g, dh)
        out = _chunked_attn(qg, k, v, positions, kpos, _inv_sqrt(dh),
                            causal=causal, window=window)
        y = torch.einsum("bshk,hkd->bsd", out.reshape(*x.shape[:2], h, dh),
                         params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(params, x, cache: dict, pos: int, cfg: ModelConfig, *,
               window: int = 0):
    """One-token decode: x (B, 1, d) at absolute position ``pos`` against
    cache {'k', 'v': (B, Tbuf, KVH, Dh), 'kpos': (Tbuf,) absolute
    positions (-1 = empty)}. The new K/V go to slot ``pos % Tbuf`` of the
    cache's own tensors (in place); with a ``window`` only the last
    ``window`` positions count, so a ring buffer of that length serves any
    context. Returns (y, the same cache dict's tensors)."""
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kvh
    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    write = pos % k.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])      # S == 1
    k_new = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.rope_theta > 0:
        p = torch.full(x.shape[:2], pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, p, cfg.rope_theta)
        k_new = apply_rope(k_new, p, cfg.rope_theta)
    k[:, write] = k_new[:, 0].to(k.dtype)
    v[:, write] = v_new[:, 0].to(v.dtype)
    kpos[write] = pos
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid = valid & (kpos > pos - window)
    logits = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(*q.shape[:2], kvh, g, dh), k)
    logits = ops.div(logits.float(), math.sqrt(dh))
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(*x.shape[:2], h, dh)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, {"k": k, "v": v, "kpos": kpos}


def cross_decode(params, x, xk, xv, cfg: ModelConfig):
    """One token's cross-attention against the encoder K/V that the
    prefill computed once: x (B, 1, d), xk / xv (B, T_enc, KVH, Dh)."""
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kvh
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    logits = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(*q.shape[:2], kvh, g, dh), xk)
    w = torch.softmax(ops.div(logits.float(), math.sqrt(dh)),
                      dim=-1).to(x.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, xv)
    o = o.reshape(*x.shape[:2], cfg.n_heads, dh)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


# --- MLA ------------------------------------------------------------------------

def _mla_qkv(params, x, positions, cfg: ModelConfig):
    m = cfg.mla
    cq = rmsnorm(params["q_norm"],
                 torch.einsum("bsd,dr->bsr", x, params["wq_a"]), cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    c_kv = rmsnorm(params["kv_norm"],
                   torch.einsum("bsd,dr->bsr", x, params["wkv_a"]),
                   cfg.norm_eps)
    k_rope = torch.einsum("bsd,dk->bsk", x, params["wk_rope"])[..., None, :]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_full(params, x, positions, cfg: ModelConfig, *, causal=True,
             q_chunk: int = DEFAULT_Q_CHUNK, return_kv=False):
    """Expanded MLA for prefill / forward, one query chunk at a time, on
    the plain path (qk head dim 192 against v's 128: not the kernel's
    function). Returns y (and the latent (c_kv, k_rope) with
    ``return_kv``)."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, positions, cfg)
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, params["wk_b"])
    v = torch.einsum("btr,rhk->bthk", c_kv, params["wv_b"])
    scale = _inv_sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    c = _pick_chunk(s, q_chunk)
    pos = positions.expand(b, s)
    outs = []
    for i in range(0, s, c):
        logits = (torch.einsum("bchk,bthk->bhct", q_nope[:, i:i + c], k_nope)
                  + torch.einsum("bchk,btk->bhct", q_rope[:, i:i + c],
                                 k_rope))
        logits = logits.float() * scale
        bias = _mask_bias(pos[:, i:i + c], positions, causal=causal, window=0)
        w = torch.softmax(logits + bias[:, None], dim=-1).to(x.dtype)
        outs.append(torch.einsum("bhct,bthk->bchk", w, v))
    out = torch.cat(outs, dim=1)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    if return_kv:
        return y, (c_kv, k_rope)
    return y


def mla_decode(params, x, cache: dict, pos: int, cfg: ModelConfig):
    """Absorbed-matmul MLA decode against the latent cache {'c_kv':
    (B, T, r_kv), 'k_rope': (B, T, r_rope)}, written at ``pos`` in place:
    W_uk is absorbed into the query and W_uv into the output, so a step
    scales with r_kv rather than H * Dh."""
    m = cfg.mla
    p = torch.full(x.shape[:2], pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, x, p, cfg)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    at = min(pos, c_kv.shape[1] - 1)      # dynamic_update_slice clamps
    c_kv[:, at] = c_kv_new[:, 0].to(c_kv.dtype)
    k_rope[:, at] = k_rope_new[:, 0].to(k_rope.dtype)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wk_b"])
    scale = _inv_sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    logits = (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope))
    logits = logits.float() * scale
    valid = torch.arange(c_kv.shape[1], device=x.device) <= pos
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhst,btr->bshr", w, c_kv)
    out = torch.einsum("bshr,rhk->bshk", ctx_lat, params["wv_b"])
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def mla_cache_spec(cfg: ModelConfig, batch: int, max_seq: int, n_layers: int,
                   dtype=torch.bfloat16) -> dict:
    m = cfg.mla
    return {
        "c_kv": TensorSpec((n_layers, batch, max_seq, m.kv_lora_rank), dtype),
        "k_rope": TensorSpec((n_layers, batch, max_seq, m.qk_rope_head_dim),
                             dtype),
    }
