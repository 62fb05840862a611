"""Grouped-query attention (covers MHA / MQA), the JAX package's
``models/attention.py`` GQA part in PyTorch.

Two execution modes share one parameterization:

- ``full``  : prefill / forward over a whole sequence, causal. Its
  attention is :func:`repro_torch.kernels.ops.flash_attention`: the
  hand-written CUDA kernel on the card, its plain version on the CPU.
  The reference runs a chunked XLA path here (bf16 logits and softmax
  weights); the kernel keeps both in fp32, as the reference's Pallas
  kernel does, so the two agree to bf16 rounding, not bit for bit.
- ``decode``: one new token against a (B, T, KVH, Dh) cache, in plain
  PyTorch, as the reference computes it in XLA outside any kernel. The
  cache is updated in place (the reference returns a fresh one).

MLA, cross-attention, bidirectional and windowed (local) attention raise
``NotImplementedError``: they are ROADMAP A12's, and no config of the
dense serve path reaches them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import AttentionKind, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import ParamSpec, TensorSpec

NEG_INF = -1e30


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A12); the port runs dense "
        "causal GQA decoders")


# --- parameter specs ----------------------------------------------------------

def attn_specs(cfg: ModelConfig, *, cross: bool = False) -> dict:
    if cross:
        raise _unported("cross-attention")
    if cfg.attention != AttentionKind.GQA:
        raise _unported(f"{cfg.attention.value} attention")
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
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


# --- GQA -----------------------------------------------------------------------

def gqa_full(params, x, positions, cfg: ModelConfig, *, causal=True,
             window: int = 0, kv_x=None, kv_positions=None, return_kv=False):
    """Causal self-attention over a whole sequence: x (B, S, d) -> (B, S, d)
    (and the post-rope (k, v), each (B, S, KVH, Dh), with ``return_kv``).

    ``positions`` (B, S) rotate q and k; the causal mask is by sequence
    index, so they must be ``0 .. S-1`` on every row, as a prefill's are.
    """
    if kv_x is not None or kv_positions is not None:
        raise _unported("cross-attention")
    if not causal:
        raise _unported("bidirectional attention")
    if window:
        raise _unported("windowed (local) attention")
    b, s = x.shape[:2]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous())
    y = torch.einsum("bhsk,hkd->bsd", out, params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(params, x, cache: dict, pos: int, cfg: ModelConfig, *,
               window: int = 0):
    """One-token decode: x (B, 1, d) at absolute position ``pos`` against
    cache {'k', 'v': (B, Tbuf, KVH, Dh), 'kpos': (Tbuf,) absolute
    positions (-1 = empty)}. The new K/V go to slot ``pos % Tbuf`` of the
    cache's own tensors (in place); returns (y, the same cache dict's
    tensors)."""
    if window:
        raise _unported("windowed (local) attention")
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
    logits = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(*q.shape[:2], kvh, g, dh), k)
    logits = ops.div(logits.float(), math.sqrt(dh))
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(*x.shape[:2], h, dh)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, {"k": k, "v": v, "kpos": kpos}


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_seq: int, n_layers: int,
                   dtype=torch.bfloat16) -> dict:
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.window:
        max_seq = min(max_seq, cfg.window)        # ring buffer bound (local attn)
    shape = (n_layers, batch, max_seq, kvh, dh)
    return {
        "k": TensorSpec(shape, dtype),
        "v": TensorSpec(shape, dtype),
        "kpos": TensorSpec((n_layers, max_seq), torch.int32),
    }
