"""Layer assembly: pre-norm residual blocks, the JAX package's
``models/transformer.py`` for the layer kind ``attn_dense`` (causal GQA
attention + dense MLP). Every other kind (MoE, Mamba-2, RG-LRU, local,
encoder, cross-attention decoder) raises ``NotImplementedError``: they
are ROADMAP A12's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_specs, rmsnorm, rmsnorm_spec
from repro_torch.models.params import TensorSpec

KINDS = ("attn_dense",)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP A12); the port "
            f"runs {KINDS}")


def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    _check_kind(kind)
    d = cfg.d_model
    return {"ln1": rmsnorm_spec(d), "attn": attn.attn_specs(cfg),
            "ln2": rmsnorm_spec(d), "ffn": mlp_specs(cfg)}


def layer_apply(params, x, positions, cfg: ModelConfig, kind: str, *,
                causal: bool = True):
    """Full-sequence layer. Returns (y, aux_loss) (aux is 0: no MoE)."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_full(params["attn"], h, positions, cfg, causal=causal)
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h2, cfg), aux


def layer_decode(params, x, layer_cache, pos: int, cfg: ModelConfig,
                 kind: str):
    """One-token layer step. Returns (y, layer cache), the cache updated in
    place."""
    _check_kind(kind)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    y, cache = attn.gqa_decode(params["attn"], h, layer_cache, pos, cfg)
    x = x + y
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h2, cfg), cache


def _fill_buffer(buf_len: int, seq, dtype):
    """Pack a (B, S, ...) prefill sequence into a (B, buf_len, ...) ring
    buffer.

    Entry for absolute position p lives at slot p % buf_len; returns
    (buffer, kpos) where kpos[i] is the absolute position stored in slot i
    (-1 = empty).
    """
    b, s = seq.shape[0], seq.shape[1]
    dev = seq.device
    buf = torch.zeros((b, buf_len, *seq.shape[2:]), dtype=dtype, device=dev)
    if s <= buf_len:
        buf[:, :s] = seq.to(dtype)
        kpos = torch.cat([torch.arange(s, dtype=torch.int32, device=dev),
                          torch.full((buf_len - s,), -1, dtype=torch.int32,
                                     device=dev)])
        return buf, kpos
    pos = torch.arange(s - buf_len, s, dtype=torch.int32, device=dev)
    slots = torch.remainder(pos, buf_len).long()
    buf[:, slots] = seq[:, s - buf_len:].to(dtype)
    kpos = torch.zeros((buf_len,), dtype=torch.int32, device=dev)
    kpos[slots] = pos
    return buf, kpos


def layer_prefill(params, x, positions, cfg: ModelConfig, kind: str, *,
                  max_seq: int, cache_dtype=torch.bfloat16):
    """Full-sequence layer that also emits its decode cache. -> (y, cache)."""
    _check_kind(kind)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    y, (k, v) = attn.gqa_full(params["attn"], h, positions, cfg,
                              return_kv=True)
    k_buf, kpos = _fill_buffer(max_seq, k, cache_dtype)
    v_buf, _ = _fill_buffer(max_seq, v, cache_dtype)
    x = x + y
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h2, cfg), {"k": k_buf, "v": v_buf,
                                             "kpos": kpos}


def layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype=torch.bfloat16) -> dict:
    """Per-layer (unstacked) decode-cache specs."""
    _check_kind(kind)
    spec = attn.gqa_cache_spec(cfg, batch, max_seq, 1, dtype)
    return {k: TensorSpec(v.shape[1:], v.dtype) for k, v in spec.items()}
