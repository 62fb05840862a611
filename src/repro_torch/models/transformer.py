"""Layer assembly: pre-norm residual blocks over pluggable mixers, the JAX
package's ``models/transformer.py`` in PyTorch.

``layer_specs`` / ``layer_apply`` / ``layer_decode`` / ``layer_prefill``
define one layer of every kind; stacks are built in ``model.py``:

- ``attn_dense``: attention (GQA or MLA) + dense MLP
- ``attn_moe``  : attention + MoE FFN
- ``mamba2``    : norm + Mamba-2 block (no FFN)
- ``recurrent`` : RG-LRU block + dense MLP
- ``local_attn``: sliding-window attention + dense MLP
- ``enc``       : bidirectional attention + dense MLP (encoder)
- ``dec_cross`` : self attention + cross attention + dense MLP (decoder of
  an encoder-decoder); the cross K/V are computed once, at prefill
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import AttentionKind, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, mlp_specs, rmsnorm, rmsnorm_spec
from repro_torch.models.params import TensorSpec

KINDS = ("attn_dense", "attn_moe", "mamba2", "recurrent", "local_attn",
         "enc", "dec_cross")


def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    s: dict[str, Any] = {"ln1": rmsnorm_spec(d)}
    if kind == "mamba2":
        s["ssm"] = ssm_mod.ssm_specs(cfg)
        return s
    if kind == "recurrent":
        s["rglru"] = rglru_mod.rglru_specs(cfg)
    else:
        s["attn"] = attn.attn_specs(cfg)
    if kind == "dec_cross":
        s["lnx"] = rmsnorm_spec(d)
        s["xattn"] = attn.attn_specs(cfg, cross=True)
    s["ln2"] = rmsnorm_spec(d)
    if kind == "attn_moe":
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["ffn"] = mlp_specs(cfg)
    return s


def _ffn(params, x, cfg: ModelConfig, kind: str, n_moe_groups: int = 1):
    """The post-attention half: (x + FFN(ln2(x)), aux loss)."""
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if kind == "attn_moe":
        y, aux = moe_mod.moe_ffn(params["moe"], h2, cfg, n_groups=n_moe_groups)
        return x + y, aux
    return x + mlp(params["ffn"], h2, cfg), None


def layer_apply(params, x, positions, cfg: ModelConfig, kind: str, *,
                enc_out=None, n_moe_groups: int = 1, causal: bool = True):
    """Full-sequence layer. Returns (y, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        return x + ssm_mod.mamba2_forward(params["ssm"], h, cfg), aux
    if kind == "recurrent":
        mixed = rglru_mod.rglru_forward(params["rglru"], h, cfg)
    elif kind == "local_attn":
        mixed = attn.gqa_full(params["attn"], h, positions, cfg, causal=True,
                              window=cfg.window)
    elif cfg.attention == AttentionKind.MLA:
        mixed = attn.mla_full(params["attn"], h, positions, cfg, causal=causal)
    else:
        mixed = attn.gqa_full(params["attn"], h, positions, cfg, causal=causal)
    x = x + mixed
    if kind == "dec_cross":
        hx = rmsnorm(params["lnx"], x, cfg.norm_eps)
        x = x + attn.gqa_full(params["xattn"], hx, positions, cfg,
                              kv_x=enc_out)
    y, a = _ffn(params, x, cfg, kind, n_moe_groups)
    return y, aux if a is None else a


def layer_decode(params, x, layer_cache, pos: int, cfg: ModelConfig,
                 kind: str):
    """One-token layer step. Returns (y, layer cache), the cache's tensors
    updated in place."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        y, _ = ssm_mod.mamba2_decode(params["ssm"], h, layer_cache, cfg)
        return x + y, layer_cache
    if kind == "recurrent":
        y, _ = rglru_mod.rglru_decode(params["rglru"], h, layer_cache, cfg)
    elif cfg.attention == AttentionKind.MLA:
        y, _ = attn.mla_decode(params["attn"], h, layer_cache, pos, cfg)
    else:
        window = cfg.window if kind == "local_attn" else 0
        y, _ = attn.gqa_decode(params["attn"], h, layer_cache, pos, cfg,
                               window=window)
    x = x + y
    if kind == "dec_cross":
        hx = rmsnorm(params["lnx"], x, cfg.norm_eps)
        x = x + attn.cross_decode(params["xattn"], hx, layer_cache["xk"],
                                  layer_cache["xv"], cfg)
    y, _ = _ffn(params, x, cfg, kind)
    return y, layer_cache


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
                  max_seq: int, enc_out=None, cache_dtype=torch.bfloat16):
    """Full-sequence layer that also emits its decode cache. -> (y, cache)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        y, st = ssm_mod.mamba2_forward(params["ssm"], h, cfg,
                                       return_state=True)
        return x + y, {"conv": st["conv"].to(cache_dtype), "ssm": st["ssm"]}
    if kind == "recurrent":
        y, st = rglru_mod.rglru_forward(params["rglru"], h, cfg,
                                        return_state=True)
        cache = {"conv": st["conv"].to(cache_dtype), "h": st["h"]}
    elif cfg.attention == AttentionKind.MLA:
        y, (c_kv, k_rope) = attn.mla_full(params["attn"], h, positions, cfg,
                                          return_kv=True)
        cache = {"c_kv": _fill_buffer(max_seq, c_kv, cache_dtype)[0],
                 "k_rope": _fill_buffer(max_seq, k_rope, cache_dtype)[0]}
    else:
        window = cfg.window if kind == "local_attn" else 0
        y, (k, v) = attn.gqa_full(params["attn"], h, positions, cfg,
                                  window=window, return_kv=True)
        buf_len = min(max_seq, window) if window else max_seq
        k_buf, kpos = _fill_buffer(buf_len, k, cache_dtype)
        cache = {"k": k_buf, "v": _fill_buffer(buf_len, v, cache_dtype)[0],
                 "kpos": kpos}
    x = x + y
    if kind == "dec_cross":
        hx = rmsnorm(params["lnx"], x, cfg.norm_eps)
        x = x + attn.gqa_full(params["xattn"], hx, positions, cfg,
                              kv_x=enc_out)
        cache["xk"] = torch.einsum("btd,dhk->bthk", enc_out,
                                   params["xattn"]["wk"]).to(cache_dtype)
        cache["xv"] = torch.einsum("btd,dhk->bthk", enc_out,
                                   params["xattn"]["wv"]).to(cache_dtype)
    y, _ = _ffn(params, x, cfg, kind)
    return y, cache


def layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype=torch.bfloat16) -> dict:
    """Per-layer (unstacked) decode-cache specs."""
    def unstack(spec):
        return {k: TensorSpec(v.shape[1:], v.dtype) for k, v in spec.items()}
    if kind == "mamba2":
        return unstack(ssm_mod.mamba2_cache_spec(cfg, batch, 1, dtype))
    if kind == "recurrent":
        return unstack(rglru_mod.rglru_cache_spec(cfg, batch, 1, dtype))
    if cfg.attention == AttentionKind.MLA:
        out = unstack(attn.mla_cache_spec(cfg, batch, max_seq, 1, dtype))
    else:
        eff = min(max_seq, cfg.window) if (cfg.window and
                                           kind == "local_attn") else max_seq
        kvh, dh = cfg.n_kv_heads, cfg.head_dim
        out = {"k": TensorSpec((batch, eff, kvh, dh), dtype),
               "v": TensorSpec((batch, eff, kvh, dh), dtype),
               "kpos": TensorSpec((eff,), torch.int32)}
    if kind == "dec_cross":
        enc = (batch, cfg.encdec.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        out["xk"] = TensorSpec(enc, dtype)
        out["xv"] = TensorSpec(enc, dtype)
    return out


def cache_logical(kind: str, cfg: ModelConfig) -> dict:
    """Logical sharding axes of each cache leaf (batch over dp, heads over
    tp), the reference's table; the port has no mesh to place them on yet."""
    if kind == "mamba2":
        return {"conv": ("batch", None, "ssm_inner"),
                "ssm": ("batch", "heads", None, None)}
    if kind == "recurrent":
        return {"conv": ("batch", None, "mlp"), "h": ("batch", "mlp")}
    if cfg.attention == AttentionKind.MLA:
        out = {"c_kv": ("batch", "kv_seq", None),
               "k_rope": ("batch", "kv_seq", None)}
    else:
        out = {"k": ("batch", "kv_seq", "kv_heads", None),
               "v": ("batch", "kv_seq", "kv_heads", None),
               "kpos": ("kv_seq",)}
    if kind == "dec_cross":
        out["xk"] = ("batch", "kv_seq", "kv_heads", None)
        out["xv"] = ("batch", "kv_seq", "kv_heads", None)
    return out
