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

Tensor parallelism (the ``*_tp`` functions): each shard of a mesh's model
axis holds its heads of ``wq`` / ``wo`` (and of ``wk`` / ``wv`` where the
kv heads divide the axis, else all of them) and runs the functions above
on them — the widths come from the shard's own leaves — giving a partial
sum of the output projection, all-reduced across the shards. A shard
attends with the kv heads its own query heads use (query head h uses kv
head h // (H / KVH)), which need not be a contiguous slice of the global
kv heads: ``kv_pick``. MLA splits its heads the same way; the latent
``c_kv`` / ``k_rope`` are computed by every shard alike. With
sequence-sharded caches (``kv_seq``) each shard holds a contiguous slice
of the cache's positions and all kv heads; a decode step gathers every
query head onto each shard, each shard takes the softmax statistics of its
slice (max, sum, weighted values), and the shards merge them by
log-sum-exp in shard order (:func:`_lse_merge`).

The two switches of ``--rule-opt`` (reference ``sharding.py:138-146``,
``models/attention.py:54-62, 111``):

- ``qk_dim_fallback`` splits ``head_dim`` over the model axis where the
  head counts do not divide it. Every shard then holds every query head
  and its slice of each head's features: q and k are gathered whole for
  rope and cut again, each shard takes the logits' partial sum over its
  slice, the partial logits are all-reduced before the softmax, each
  shard weights its slice of v, and the partial ``wo`` products are
  all-reduced (:func:`_gqa_full_qk`, :func:`_gqa_decode_qk`). Where only
  the kv heads fail to divide (the query heads split as usual), each
  shard projects its slice of ``head_dim`` of every kv head and the
  slices are gathered (:func:`_kv_by_slices`, as for replicated kv heads
  without the switch in a prefill or a train step; a decode step
  projects replicated kv heads whole on every shard).
- ``seq_parallel_attn`` (the group's ``q_seq``) splits the queries over
  the model axis instead: each shard gathers every head's q, k and v,
  attends its contiguous block of query rows against the whole K/V,
  the blocks are all-gathered along the sequence, and each shard
  projects its own heads through its ``wo`` (partial sums all-reduced)
  (:func:`_gqa_full_seq`). Decode has one query row and is unaffected.
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
             window: int = 0, kv_x=None, kv_positions=None, return_kv=False,
             kv_pick: slice | None = None, kv=None):
    """Attention over a whole sequence: x (B, S, d) -> (B, S, d) (and the
    post-rope (k, v), each (B, T, KVH, Dh), with ``return_kv``).
    ``kv_x`` (B, T, d) makes it cross-attention (no rope, no mask).

    ``positions`` (B, S) rotate q and k and build the mask; a call that
    :func:`takes_flash` is masked by sequence index instead, so there they
    must be ``0 .. S-1`` on every row, as a prefill's are.

    The head counts are those of ``params``' leaves (a tensor-parallel
    shard's); ``kv_pick`` selects the kv heads the query heads attend with
    (all by default); ``return_kv`` returns every kv head computed;
    ``kv`` the (k, v) projections (before rope) computed already."""
    h, dh = params["wq"].shape[1], params["wq"].shape[2]
    cross = kv_x is not None
    src = kv_x if cross else x
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k, v = kv if kv is not None else (
        torch.einsum("btd,dhk->bthk", src, params["wk"]),
        torch.einsum("btd,dhk->bthk", src, params["wv"]))
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
    ka, va = (k, v) if kv_pick is None else (k[:, :, kv_pick],
                                               v[:, :, kv_pick])
    kvh = ka.shape[2]
    g = h // kvh
    if kv_positions is None and takes_flash(q, ka, va, causal=causal,
                                            window=window, cross=cross):
        out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                                  ka.transpose(1, 2).contiguous(),
                                  va.transpose(1, 2).contiguous())
        y = torch.einsum("bhsk,hkd->bsd", out, params["wo"])
    else:
        qg = q.reshape(*q.shape[:2], kvh, g, dh)
        out = _chunked_attn(qg, ka, va, positions, kpos, _inv_sqrt(dh),
                            causal=causal, window=window)
        y = torch.einsum("bshk,hkd->bsd", out.reshape(*x.shape[:2], h, dh),
                         params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(params, x, cache: dict, pos: int, cfg: ModelConfig, *,
               window: int = 0, kv_pick: slice | None = None, kv=None):
    """One-token decode: x (B, 1, d) at absolute position ``pos`` against
    cache {'k', 'v': (B, Tbuf, KVH, Dh), 'kpos': (Tbuf,) absolute
    positions (-1 = empty)}. The new K/V go to slot ``pos % Tbuf`` of the
    cache's own tensors (in place); with a ``window`` only the last
    ``window`` positions count, so a ring buffer of that length serves any
    context. Returns (y, the same cache dict's tensors). Head counts and
    ``kv_pick`` as in :func:`gqa_full`: every kv head computed is
    written, the picked ones attended; ``kv`` the new token's (k, v)
    projections computed already."""
    h, dh = params["wq"].shape[1], params["wq"].shape[2]
    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    write = pos % k.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])      # S == 1
    k_new, v_new = kv if kv is not None else (
        torch.einsum("bsd,dhk->bshk", x, params["wk"]),
        torch.einsum("bsd,dhk->bshk", x, params["wv"]))
    if cfg.rope_theta > 0:
        p = torch.full(x.shape[:2], pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, p, cfg.rope_theta)
        k_new = apply_rope(k_new, p, cfg.rope_theta)
    k[:, write] = k_new[:, 0].to(k.dtype)
    v[:, write] = v_new[:, 0].to(v.dtype)
    kpos[write] = pos
    valid = _valid(kpos, pos, window)
    ka, va = (k, v) if kv_pick is None else (k[:, :, kv_pick],
                                             v[:, :, kv_pick])
    kvh = ka.shape[2]
    logits = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(*q.shape[:2], kvh, h // kvh, dh), ka)
    logits = ops.div(logits.float(), math.sqrt(dh))
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, va).reshape(*x.shape[:2], h,
                                                           dh)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, {"k": k, "v": v, "kpos": kpos}


def _valid(kpos, pos: int, window: int):
    """Cache slots holding a position the step at ``pos`` attends to."""
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid = valid & (kpos > pos - window)
    return valid


def cross_decode(params, x, xk, xv, cfg: ModelConfig, *,
                 kv_pick: slice | None = None):
    """One token's cross-attention against the encoder K/V that the
    prefill computed once: x (B, 1, d), xk / xv (B, T_enc, KVH, Dh)."""
    if kv_pick is not None:
        xk, xv = xk[:, :, kv_pick], xv[:, :, kv_pick]
    h, dh = params["wq"].shape[1], params["wq"].shape[2]
    kvh = xk.shape[2]
    g = h // kvh
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    logits = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(*q.shape[:2], kvh, g, dh), xk)
    w = torch.softmax(ops.div(logits.float(), math.sqrt(dh)),
                      dim=-1).to(x.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, xv)
    o = o.reshape(*x.shape[:2], h, dh)
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


# --- tensor parallelism over the model axis ------------------------------------

def kv_pick(n_heads: int, n_kv: int, n_shards: int, j: int, q_split: bool,
            kv_split: bool) -> slice | None:
    """The kv heads (a slice of those shard ``j`` holds) that its query
    heads attend with: None where they use all it holds. Query head h
    uses kv head h // (H / KVH); a shard whose heads would use its kv
    heads unevenly raises."""
    if not q_split:
        return None
    hq = n_heads // n_shards
    lo = j * hq
    group = n_heads // n_kv
    held_lo = j * (n_kv // n_shards) if kv_split else 0
    held = n_kv // n_shards if kv_split else n_kv
    first, last = lo // group, (lo + hq - 1) // group
    n_used = last - first + 1
    if not (n_used == 1 or (lo % group == 0 and hq % group == 0)):
        raise NotImplementedError(
            f"shard {j} of {n_shards}: query heads {lo}..{lo + hq - 1} use "
            f"kv heads {first}..{last} unevenly ({n_heads} heads over "
            f"{n_kv} kv heads)")
    if first - held_lo == 0 and n_used == held:
        return None
    if first < held_lo or last >= held_lo + held:
        raise NotImplementedError(f"shard {j}: kv heads {first}..{last} "
                                  "not held")
    return slice(first - held_lo, last - held_lo + 1)


def _head_split(cfg: ModelConfig, p) -> tuple:
    """(query heads split, kv heads split) of a GQA shard's leaves."""
    return (p["wq"].shape[1] != cfg.n_heads,
            p["wk"].shape[1] != cfg.n_kv_heads)


def _picks(cfg: ModelConfig, ps) -> list:
    q_split, kv_split = _head_split(cfg, ps[0])
    return [kv_pick(cfg.n_heads, cfg.n_kv_heads, len(ps), j, q_split,
                    kv_split) for j in range(len(ps))]


def gqa_full_tp(ps, hs, positions, cfg: ModelConfig, group, *, causal=True,
                window: int = 0, kv_xs=None, return_kv=False):
    """:func:`gqa_full` on each shard's heads, the output projections'
    partial sums all-reduced. Lists over the shards: ``ps``, ``hs``,
    ``positions``, ``kv_xs``. Returns the outputs (and each shard's
    computed (k, v) with ``return_kv``)."""
    kw = dict(causal=causal, window=window, kv_xs=kv_xs, return_kv=return_kv)
    if _dh_split(cfg, ps[0], "wq"):
        return _gqa_full_qk(ps, hs, positions, cfg, group, **kw)
    kvs = _kv_by_slices(cfg, ps, hs if kv_xs is None else kv_xs, group)
    if getattr(group, "q_seq", False) and group.size > 1 \
            and hs[0].shape[1] % group.size == 0:
        return _gqa_full_seq(ps, hs, positions, cfg, group, kvs=kvs, **kw)
    picks = _picks(cfg, ps)
    outs = [gqa_full(p, h, pos, cfg, causal=causal, window=window,
                     kv_x=None if kv_xs is None else kv_xs[j],
                     return_kv=return_kv, kv_pick=picks[j], kv=kvs[j])
            for j, (p, h, pos) in enumerate(zip(ps, hs, positions))]
    ys = group.reduce([o[0] if return_kv else o for o in outs],
                      _head_split(cfg, ps[0])[0])
    if return_kv:
        return ys, [o[1] for o in outs]
    return ys


def gqa_decode_tp(ps, hs, caches, pos: int, cfg: ModelConfig, group, *,
                  window: int = 0):
    """:func:`gqa_decode` on each shard's heads and its cache (its kv
    heads, or all of them), partial sums all-reduced."""
    if _dh_split(cfg, ps[0], "wq"):
        return _gqa_decode_qk(ps, hs, caches, pos, cfg, group, window=window)
    # replicated kv heads are projected whole on every shard: one token's
    # projection is too small for two gathers a layer to pay for
    kvs = _kv_by_slices(cfg, ps, hs, group) if _dh_split(
        cfg, ps[0], "wk") else [None] * len(ps)
    picks = _picks(cfg, ps)
    ys = [gqa_decode(p, h, c, pos, cfg, window=window, kv_pick=picks[j],
                     kv=kvs[j])[0]
          for j, (p, h, c) in enumerate(zip(ps, hs, caches))]
    return group.reduce(ys, _head_split(cfg, ps[0])[0])


def cross_decode_tp(ps, hs, xks, xvs, cfg: ModelConfig, group):
    if _dh_split(cfg, ps[0], "wq"):
        return _cross_decode_qk(ps, hs, xks, xvs, cfg, group)
    picks = _picks(cfg, ps)
    ys = [cross_decode(p, h, xk, xv, cfg, kv_pick=picks[j])
          for j, (p, h, xk, xv) in enumerate(zip(ps, hs, xks, xvs))]
    return group.reduce(ys, _head_split(cfg, ps[0])[0])


def _lse_merge(group, logits, values):
    """Softmax attention over keys spread across the shards: ``logits``
    per shard (..., T_j) fp32 (masked at NEG_INF), ``values`` per shard a
    function of the unnormalised weights (..., T_j) -> (..., Dv) fp32.
    Each shard's max, sum and weighted values, merged by log-sum-exp in
    shard order -> the attention output (..., Dv) on every shard."""
    ms = [lg.amax(-1, keepdim=True) for lg in logits]
    es = [torch.exp(lg - m) for lg, m in zip(logits, ms)]
    outs = [fn(e) for fn, e in zip(values, es)]
    sums = [e.sum(-1, keepdim=True) for e in es]
    top = group.max(ms)
    scale = [torch.exp(m - t) for m, t in zip(ms, top)]
    num = group.sum([o * s for o, s in zip(outs, scale)])
    den = group.sum([z * s for z, s in zip(sums, scale)])
    return [n / d for n, d in zip(num, den)]


def _all_heads(group, parts, split: bool, dim: int = 2):
    """Every head of a per-shard head-split activation, on every shard."""
    return group.gather(parts, dim) if split else list(parts)


def _own_heads(xs, split: bool, n_shards: int, dim: int = 2):
    """Each shard's own heads of an all-heads activation."""
    if not split:
        return list(xs)
    return [x.chunk(n_shards, dim=dim)[j] for j, x in enumerate(xs)]


def _seq_owner(caches, key: str, slot: int):
    """(shard, local slot) of global cache slot ``slot`` in a cache cut
    into equal contiguous position slices."""
    n = caches[0][key].shape[1]
    return slot // n, slot % n


def _kvseq_project(ps, hs, pos: int, cfg: ModelConfig, group):
    """q of every head and the new token's k / v of every kv head, on each
    shard, after rope (kv_seq decode)."""
    q_split, kv_split = _head_split(cfg, ps[0])
    qs, ks, vs = [], [], []
    for p, h in zip(ps, hs):
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
        if cfg.rope_theta > 0:
            at = torch.full(h.shape[:2], pos, dtype=torch.int32,
                            device=h.device)
            q = apply_rope(q, at, cfg.rope_theta)
            k = apply_rope(k, at, cfg.rope_theta)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    return (_all_heads(group, qs, q_split), _all_heads(group, ks, kv_split),
            _all_heads(group, vs, kv_split))


def _kvseq_attend(group, qs, ks, vs, valids, dh: int):
    """Every head's attention over sequence-sliced K/V: q (B, 1, H, Dh),
    k / v (B, T_j, KVH, Dh), valid (T_j,) or None -> (B, 1, H, Dh) fp32."""
    b, _, h, _ = qs[0].shape
    kvh = ks[0].shape[2]
    logits = []
    for q, k, valid in zip(qs, ks, valids):
        lg = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(b, 1, kvh, h // kvh, dh), k)
        lg = ops.div(lg.float(), math.sqrt(dh))
        logits.append(lg if valid is None else
                      torch.where(valid, lg, NEG_INF))
    values = [lambda e, v=v: torch.einsum("bkgst,btkd->bkgsd", e, v.float())
              for v in vs]
    outs = _lse_merge(group, logits, values)
    return [o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, dh) for o in outs]


def gqa_decode_kvseq(ps, hs, caches, pos: int, cfg: ModelConfig, group, *,
                     window: int = 0):
    """One decode step against caches cut by position over the shards
    (each holds a contiguous slice of the slots and every kv head): the
    new k / v go to the slot's owner, every shard attends all heads over
    its slice, the slices merge by log-sum-exp, and each shard projects
    its own heads' context through its ``wo``."""
    _no_dh_split(cfg, ps[0], "kv_seq_sharding")
    q_split = _head_split(cfg, ps[0])[0]
    dh = cfg.head_dim
    qs, ks, vs = _kvseq_project(ps, hs, pos, cfg, group)
    n_slots = caches[0]["k"].shape[1] * len(caches)
    owner, at = _seq_owner(caches, "k", pos % n_slots)
    c = caches[owner]
    c["k"][:, at] = ks[owner][:, 0].to(c["k"].dtype)
    c["v"][:, at] = vs[owner][:, 0].to(c["v"].dtype)
    c["kpos"][at] = pos
    ctx = _kvseq_attend(group, qs, [c["k"] for c in caches],
                        [c["v"] for c in caches],
                        [_valid(c["kpos"], pos, window) for c in caches], dh)
    return _project_own(ps, hs, ctx, q_split, group)


def _project_own(ps, hs, ctx, q_split: bool, group):
    """Each shard's own heads of an all-heads context through its ``wo``,
    partial sums all-reduced."""
    own = _own_heads(ctx, q_split, len(ps))
    ys = [torch.einsum("bshk,hkd->bsd", o.to(h.dtype), p["wo"])
          for o, h, p in zip(own, hs, ps)]
    return group.reduce(ys, q_split)


def cross_decode_kvseq(ps, hs, xks, xvs, cfg: ModelConfig, group):
    """Cross-attention of one token against encoder K/V cut by position
    over the shards (every kv head on each), merged by log-sum-exp."""
    _no_dh_split(cfg, ps[0], "kv_seq_sharding")
    q_split = _head_split(cfg, ps[0])[0]
    qs = _all_heads(group, [torch.einsum("bsd,dhk->bshk", h, p["wq"])
                            for p, h in zip(ps, hs)], q_split)
    ctx = _kvseq_attend(group, qs, xks, xvs, [None] * len(ps),
                        cfg.head_dim)
    return _project_own(ps, hs, ctx, q_split, group)


# --- the dry run's switches: head_dim or the queries over the model axis -----

def _dh_split(cfg: ModelConfig, p, key: str) -> bool:
    """Whether a shard's ``key`` leaf holds a slice of ``head_dim``
    (``qk_dim_fallback``)."""
    return p[key].shape[2] != cfg.head_dim


def _no_dh_split(cfg: ModelConfig, p, what: str) -> None:
    if any(_dh_split(cfg, p, k) for k in ("wq", "wk", "wv")):
        raise NotImplementedError(f"{what} with head_dim split over the "
                                  "model axis (qk_dim_fallback)")


def _kv_by_slices(cfg: ModelConfig, ps, srcs, group) -> list:
    """Each shard's (k, v) of every kv head, computed a slice of
    ``head_dim`` a shard and gathered, where the kv heads do not split
    over the shards (they are replicated, or ``qk_dim_fallback`` cut their
    ``head_dim``): each shard projects 1/n of them, as the reference's
    partitioner splits the replicated product, instead of all. None per
    shard where the kv heads split (each shard projects its own)."""
    n = group.size
    dh = cfg.head_dim
    split = _dh_split(cfg, ps[0], "wk")
    if n == 1 or dh % n or (not split and _head_split(cfg, ps[0])[1]) or (
            not split and not _head_split(cfg, ps[0])[0]):
        return [None] * len(ps)
    w = dh // n

    def cut(p, key, j):
        return p[key] if split else p[key][:, :, j * w:(j + 1) * w]
    ks = [torch.einsum("btd,dhk->bthk", x, cut(p, "wk", j))
          for j, (p, x) in enumerate(zip(ps, srcs))]
    vs = [torch.einsum("btd,dhk->bthk", x, cut(p, "wv", j))
          for j, (p, x) in enumerate(zip(ps, srcs))]
    return list(zip(group.gather(ks, 3), group.gather(vs, 3)))


def _own_slice(xs, n: int, dim: int = -1) -> list:
    """Shard ``j``'s ``j``-th slice of a whole tensor, per shard."""
    return [x.chunk(n, dim=dim)[j] for j, x in enumerate(xs)]


def _qk_project(ps, hs, kv_src, cfg: ModelConfig, group, q_pos, k_pos):
    """q, k and v of every head, each shard's slice of ``head_dim``, after
    rope (q and k gathered whole to rotate, then cut again); also k and v
    whole."""
    n = group.size
    qs = [torch.einsum("bsd,dhk->bshk", h, p["wq"]) for p, h in zip(ps, hs)]
    ks = [torch.einsum("btd,dhk->bthk", x, p["wk"])
          for p, x in zip(ps, kv_src)]
    vs = [torch.einsum("btd,dhk->bthk", x, p["wv"])
          for p, x in zip(ps, kv_src)]
    k_whole = group.gather(ks, 3)
    if q_pos is not None and cfg.rope_theta > 0:
        q_whole = [apply_rope(q, pos, cfg.rope_theta)
                   for q, pos in zip(group.gather(qs, 3), q_pos)]
        k_whole = [apply_rope(k, pos, cfg.rope_theta)
                   for k, pos in zip(k_whole, k_pos)]
        qs, ks = _own_slice(q_whole, n), _own_slice(k_whole, n)
    return qs, ks, vs, k_whole


def _partial_attend(group, qs, ks, vs, scale: float, masks):
    """Softmax attention from per-shard ``head_dim`` slices: q (B, c, KVH,
    G, d_j), k (B, T, KVH, d_j), v (B, T, KVH, d_j); the logits' partial
    sums all-reduced (fp32), each shard weighting its slice of v ->
    (B, c, KVH, G, d_j) per shard. ``masks`` an additive (B, 1, 1, c, T)
    bias or a (T,) validity per shard, or None."""
    parts = [torch.einsum("bckgd,btkd->bkgct", q, k).float()
             for q, k in zip(qs, ks)]
    logits = group.sum(parts)
    out = []
    for lg, v, m in zip(logits, vs, masks):
        lg = lg * scale
        if m is not None:
            lg = lg + m if m.dtype != torch.bool else torch.where(m, lg,
                                                                  NEG_INF)
        w = torch.softmax(lg, dim=-1).to(v.dtype)
        out.append(torch.einsum("bkgct,btkd->bckgd", w, v))
    return out


def _gqa_full_qk(ps, hs, positions, cfg: ModelConfig, group, *, causal,
                 window, kv_xs, return_kv):
    """Whole-sequence attention with ``head_dim`` split (every head on
    every shard), query chunk by query chunk as :func:`_chunked_attn`."""
    n = group.size
    cross = kv_xs is not None
    src = kv_xs if cross else hs
    k_pos = None if cross else positions
    qs, ks, vs, k_whole = _qk_project(ps, hs, src, cfg, group,
                                      None if cross else positions, k_pos)
    b, s, h, d_j = qs[0].shape
    kvh = ks[0].shape[2]
    if cross:
        causal, window = False, 0
        k_pos = [torch.arange(x.shape[1], dtype=torch.int32,
                              device=x.device)[None, :] for x in src]
    c = _pick_chunk(s, DEFAULT_Q_CHUNK)
    scale = _inv_sqrt(cfg.head_dim)
    outs = [[] for _ in range(n)]
    for i in range(0, s, c):
        masks = [_mask_bias(pos.expand(b, s)[:, i:i + c], kp, causal=causal,
                            window=window)[:, None, None]
                 for pos, kp in zip(positions, k_pos)]
        qc = [q[:, i:i + c].reshape(b, -1, kvh, h // kvh, d_j) for q in qs]
        for j, o in enumerate(_partial_attend(group, qc, ks, vs, scale,
                                              masks)):
            outs[j].append(o)
    ys = [torch.einsum("bshk,hkd->bsd", torch.cat(o, dim=1).reshape(
        b, s, h, d_j), p["wo"]) for o, p in zip(outs, ps)]
    ys = group.reduce(ys, True)
    if return_kv:
        return ys, list(zip(k_whole, group.gather(vs, 3)))
    return ys


def _gqa_decode_qk(ps, hs, caches, pos: int, cfg: ModelConfig, group, *,
                   window: int = 0):
    """One decode step with ``head_dim`` split: the new k / v gathered
    whole into every shard's cache (each holds every kv head), the
    logits' partial sums over the shards' slices all-reduced."""
    n = group.size
    at = [torch.full(h.shape[:2], pos, dtype=torch.int32, device=h.device)
          for h in hs]
    qs, _, vs, k_whole = _qk_project(ps, hs, hs, cfg, group, at, at)
    v_whole = group.gather(vs, 3)
    b, _, h, d_j = qs[0].shape
    for c, k, v in zip(caches, k_whole, v_whole):
        write = pos % c["k"].shape[1]
        c["k"][:, write] = k[:, 0].to(c["k"].dtype)
        c["v"][:, write] = v[:, 0].to(c["v"].dtype)
        c["kpos"][write] = pos
    kvh = caches[0]["k"].shape[2]
    outs = _partial_attend(
        group, [q.reshape(b, 1, kvh, h // kvh, d_j) for q in qs],
        _own_slice([c["k"] for c in caches], n),
        _own_slice([c["v"] for c in caches], n), 1.0 / math.sqrt(cfg.head_dim),
        [_valid(c["kpos"], pos, window) for c in caches])
    ys = [torch.einsum("bshk,hkd->bsd", o.reshape(b, 1, h, d_j), p["wo"])
          for o, p in zip(outs, ps)]
    return group.reduce(ys, True)


def _cross_decode_qk(ps, hs, xks, xvs, cfg: ModelConfig, group):
    """One token's cross-attention with ``head_dim`` split, against the
    whole encoder K/V each shard holds."""
    n = group.size
    qs = [torch.einsum("bsd,dhk->bshk", h, p["wq"]) for p, h in zip(ps, hs)]
    b, _, h, d_j = qs[0].shape
    kvh = xks[0].shape[2]
    outs = _partial_attend(
        group, [q.reshape(b, 1, kvh, h // kvh, d_j) for q in qs],
        _own_slice(xks, n), _own_slice(xvs, n),
        1.0 / math.sqrt(cfg.head_dim), [None] * n)
    ys = [torch.einsum("bshk,hkd->bsd", o.reshape(b, 1, h, d_j).to(x.dtype),
                       p["wo"]) for o, p, x in zip(outs, ps, hs)]
    return group.reduce(ys, True)


def _gqa_full_seq(ps, hs, positions, cfg: ModelConfig, group, *, causal,
                  window, kv_xs, return_kv, kvs):
    """Whole-sequence attention with the queries split over the shards:
    every head's q, k and v gathered onto each shard, each shard's block
    of query rows attended against the whole K/V, the blocks gathered
    along the sequence, each shard's own heads through its ``wo``."""
    n = group.size
    cross = kv_xs is not None
    src = kv_xs if cross else hs
    q_split, kv_split = _head_split(cfg, ps[0])
    qs, ks, vs = [], [], []
    for p, h, x, pos, kv in zip(ps, hs, src, positions, kvs):
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
        k, v = kv if kv is not None else (
            torch.einsum("btd,dhk->bthk", x, p["wk"]),
            torch.einsum("btd,dhk->bthk", x, p["wv"]))
        if not cross and cfg.rope_theta > 0:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    qa = _all_heads(group, qs, q_split)
    ka = _all_heads(group, ks, kv_split)
    va = _all_heads(group, vs, kv_split)
    b, s, h, dh = qa[0].shape
    kvh = ka[0].shape[2]
    rows = s // n
    blocks = []
    for j, (q, k, v, pos) in enumerate(zip(qa, ka, va, positions)):
        lo = j * rows
        q_pos = pos.expand(b, s)[:, lo:lo + rows]
        if cross:
            k_pos = torch.arange(k.shape[1], dtype=torch.int32,
                                 device=k.device)[None, :]
        else:
            k_pos = pos
        blocks.append(_chunked_attn(
            q[:, lo:lo + rows].reshape(b, rows, kvh, h // kvh, dh), k, v,
            q_pos, k_pos, _inv_sqrt(dh), causal=causal and not cross,
            window=0 if cross else window))
    whole = group.gather(blocks, 1)
    own = _own_heads([o.reshape(b, s, h, dh) for o in whole], q_split, n)
    ys = group.reduce([torch.einsum("bshk,hkd->bsd", o, p["wo"])
                       for o, p in zip(own, ps)], q_split)
    if return_kv:
        return ys, list(zip(ks, vs))
    return ys


def _mla_split(cfg: ModelConfig, p) -> bool:
    return p["wq_b"].shape[1] != cfg.n_heads


def mla_full_tp(ps, hs, positions, cfg: ModelConfig, group, *, causal=True,
                return_kv=False):
    """:func:`mla_full` on each shard's heads (the latent computed by
    every shard alike), partial sums all-reduced."""
    outs = [mla_full(p, h, pos, cfg, causal=causal, return_kv=return_kv)
            for p, h, pos in zip(ps, hs, positions)]
    ys = group.reduce([o[0] if return_kv else o for o in outs],
                      _mla_split(cfg, ps[0]))
    if return_kv:
        return ys, [o[1] for o in outs]
    return ys


def mla_decode_tp(ps, hs, caches, pos: int, cfg: ModelConfig, group):
    """:func:`mla_decode` on each shard's heads against its copy of the
    latent cache (every shard writes the same new entry)."""
    ys = [mla_decode(p, h, c, pos, cfg)[0]
          for p, h, c in zip(ps, hs, caches)]
    return group.reduce(ys, _mla_split(cfg, ps[0]))


def mla_decode_kvseq(ps, hs, caches, pos: int, cfg: ModelConfig, group):
    """Absorbed MLA decode against a latent cache cut by position over
    the shards: the absorbed queries of every head gathered onto each
    shard, each shard's slice attended, merged by log-sum-exp; each shard
    expands its own heads' latent context."""
    m = cfg.mla
    split = _mla_split(cfg, ps[0])
    qls, qrs, new = [], [], []
    for p, h in zip(ps, hs):
        at = torch.full(h.shape[:2], pos, dtype=torch.int32, device=h.device)
        q_nope, q_rope, c_new, kr_new = _mla_qkv(p, h, at, cfg)
        qls.append(torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"]))
        qrs.append(q_rope)
        new.append((c_new, kr_new))
    qls = _all_heads(group, qls, split)
    qrs = _all_heads(group, qrs, split)
    n_slots = caches[0]["c_kv"].shape[1] * len(caches)
    owner, at = _seq_owner(caches, "c_kv", min(pos, n_slots - 1))
    c = caches[owner]
    c["c_kv"][:, at] = new[owner][0][:, 0].to(c["c_kv"].dtype)
    c["k_rope"][:, at] = new[owner][1][:, 0].to(c["k_rope"].dtype)
    scale = _inv_sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    logits, values = [], []
    for j, (ql, qr, c) in enumerate(zip(qls, qrs, caches)):
        n = c["c_kv"].shape[1]
        lg = (torch.einsum("bshr,btr->bhst", ql, c["c_kv"])
              + torch.einsum("bshk,btk->bhst", qr, c["k_rope"]))
        lg = lg.float() * scale
        slots = torch.arange(j * n, (j + 1) * n, device=lg.device)
        logits.append(torch.where(slots <= pos, lg, NEG_INF))
        values.append(lambda e, ck=c["c_kv"]: torch.einsum(
            "bhst,btr->bhsr", e, ck.float()))
    ctx = _lse_merge(group, logits, values)            # (B, H, 1, r)
    ctx = [x.transpose(1, 2) for x in ctx]              # (B, 1, H, r)
    own = _own_heads(ctx, split, len(ps))
    ys = []
    for o, h, p in zip(own, hs, ps):
        out = torch.einsum("bshr,rhk->bshk", o.to(h.dtype), p["wv_b"])
        ys.append(torch.einsum("bshk,hkd->bsd", out, p["wo"]))
    return group.reduce(ys, split)
