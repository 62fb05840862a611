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

``layer_apply_tp`` / ``layer_prefill_tp`` / ``layer_decode_tp`` are the
same layers over the shards of a mesh's model axis: lists over the shards
of one data row (each shard's leaves, its copy of the residual stream,
which stays replicated, and its cache), each mixer and FFN the
tensor-parallel function of its module, ``group`` the row's
``core.collectives.Group``. ``seq_split`` names the cache leaves cut by
position over the shards (``kv_seq``): those layers' prefill keeps each
shard's slice of positions with every kv head, and their decode merges
the slices by log-sum-exp.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import AttentionKind, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mlp, mlp_specs, mlp_tp, rmsnorm,
                                       rmsnorm_spec)
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
    tp, the sequence over tp with ``kv_seq``), the reference's table."""
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


# --- tensor parallelism over the model axis ------------------------------------

def _norms(ps, xs, key: str, cfg: ModelConfig):
    return [rmsnorm(p[key], x, cfg.norm_eps) for p, x in zip(ps, xs)]


def _sub(ps, key: str) -> list:
    return [p[key] for p in ps]


def _add(xs, ys) -> list:
    return [x + y for x, y in zip(xs, ys)]


def ffn_tp(ps, xs, cfg: ModelConfig, kind: str, group,
           n_moe_groups: int = 1):
    """The post-attention half over the shards -> (outputs, aux loss)."""
    h2 = _norms(ps, xs, "ln2", cfg)
    if kind == "attn_moe":
        ys, aux = moe_mod.moe_ffn_tp(_sub(ps, "moe"), h2, cfg, group,
                                     n_groups=n_moe_groups)
        return _add(xs, ys), aux
    return _add(xs, mlp_tp(_sub(ps, "ffn"), h2, cfg, group)), None


def layer_apply_tp(ps, xs, positions, cfg: ModelConfig, kind: str, group, *,
                   enc_outs=None, n_moe_groups: int = 1,
                   causal: bool = True, ffn: bool = True):
    """:func:`layer_apply` over the shards -> (outputs, aux loss); with
    ``ffn=False`` only the mixer half -> outputs (a MoE layer's FFN runs
    over every data row at once, in ``model.py``)."""
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    hs = _norms(ps, xs, "ln1", cfg)
    if kind == "mamba2":
        ys = _add(xs, ssm_mod.mamba2_forward_tp(_sub(ps, "ssm"), hs, cfg,
                                                group))
        return (ys, aux) if ffn else ys
    if kind == "recurrent":
        mixed = rglru_mod.rglru_forward_tp(_sub(ps, "rglru"), hs, cfg, group)
    elif kind == "local_attn":
        mixed = attn.gqa_full_tp(_sub(ps, "attn"), hs, positions, cfg, group,
                                 causal=True, window=cfg.window)
    elif cfg.attention == AttentionKind.MLA:
        mixed = attn.mla_full_tp(_sub(ps, "attn"), hs, positions, cfg, group,
                                 causal=causal)
    else:
        mixed = attn.gqa_full_tp(_sub(ps, "attn"), hs, positions, cfg, group,
                                 causal=causal)
    xs = _add(xs, mixed)
    if kind == "dec_cross":
        xs = _add(xs, attn.gqa_full_tp(_sub(ps, "xattn"),
                                       _norms(ps, xs, "lnx", cfg), positions,
                                       cfg, group, kv_xs=enc_outs))
    if not ffn:
        return xs
    ys, a = ffn_tp(ps, xs, cfg, kind, group, n_moe_groups)
    return ys, aux if a is None else a


def _by_position(group, parts, n_shards: int, split_heads: bool,
                 seq_dim: int = 1):
    """Each shard's contiguous slice of positions of a per-shard (B, T,
    KVH, ...) tensor, with every kv head (gathered where the heads were
    split)."""
    whole = group.gather(parts, 2) if split_heads else list(parts)
    return [w.chunk(n_shards, dim=seq_dim)[j].contiguous()
            for j, w in enumerate(whole)]


def layer_prefill_tp(ps, xs, positions, cfg: ModelConfig, kind: str, group,
                     *, max_seq: int, enc_outs=None,
                     cache_dtype=torch.bfloat16, seq_split=(),
                     ffn: bool = True):
    """:func:`layer_prefill` over the shards -> (outputs, each shard's
    cache); ``ffn`` as in :func:`layer_apply_tp`."""
    n = group.size
    hs = _norms(ps, xs, "ln1", cfg)
    if kind == "mamba2":
        ys, sts = ssm_mod.mamba2_forward_tp(_sub(ps, "ssm"), hs, cfg, group,
                                            return_state=True)
        return _add(xs, ys), [{"conv": st["conv"].to(cache_dtype),
                               "ssm": st["ssm"]} for st in sts]
    if kind == "recurrent":
        ys, sts = rglru_mod.rglru_forward_tp(_sub(ps, "rglru"), hs, cfg,
                                             group, return_state=True)
        caches = [{"conv": st["conv"].to(cache_dtype), "h": st["h"]}
                  for st in sts]
    elif cfg.attention == AttentionKind.MLA:
        ys, kvs = attn.mla_full_tp(_sub(ps, "attn"), hs, positions, cfg,
                                   group, return_kv=True)
        caches = []
        for j, (c_kv, k_rope) in enumerate(kvs):
            c = {"c_kv": _fill_buffer(max_seq, c_kv, cache_dtype)[0],
                 "k_rope": _fill_buffer(max_seq, k_rope, cache_dtype)[0]}
            if "c_kv" in seq_split:
                c = {k: t.chunk(n, dim=1)[j].contiguous()
                     for k, t in c.items()}
            caches.append(c)
    else:
        window = cfg.window if kind == "local_attn" else 0
        aps = _sub(ps, "attn")
        ys, kvs = attn.gqa_full_tp(aps, hs, positions, cfg, group,
                                   window=window, return_kv=True)
        buf_len = min(max_seq, window) if window else max_seq
        caches = []
        for k, v in kvs:
            k_buf, kpos = _fill_buffer(buf_len, k, cache_dtype)
            caches.append({"k": k_buf, "v": _fill_buffer(buf_len, v,
                                                         cache_dtype)[0],
                           "kpos": kpos})
        if "k" in seq_split:
            kv_split = attn._head_split(cfg, aps[0])[1]
            for key in ("k", "v"):
                for c, t in zip(caches, _by_position(
                        group, [c[key] for c in caches], n, kv_split)):
                    c[key] = t
            for j, c in enumerate(caches):
                c["kpos"] = c["kpos"].chunk(n)[j].contiguous()
    xs = _add(xs, ys)
    if kind == "dec_cross":
        xps = _sub(ps, "xattn")
        xs = _add(xs, attn.gqa_full_tp(xps, _norms(ps, xs, "lnx", cfg),
                                       positions, cfg, group,
                                       kv_xs=enc_outs))
        for key, w in (("xk", "wk"), ("xv", "wv")):
            parts = [torch.einsum("btd,dhk->bthk", e, p[w]).to(cache_dtype)
                     for e, p in zip(enc_outs, xps)]
            if attn._dh_split(cfg, xps[0], w):   # qk_dim_fallback
                parts = group.gather(parts, 3)
            if "xk" in seq_split:
                parts = _by_position(group, parts, n,
                                     attn._head_split(cfg, xps[0])[1])
            for c, t in zip(caches, parts):
                c[key] = t
    if not ffn:
        return xs, caches
    ys, _ = ffn_tp(ps, xs, cfg, kind, group)
    return ys, caches


def layer_decode_tp(ps, xs, caches, pos: int, cfg: ModelConfig, kind: str,
                    group, *, seq_split=(), ffn: bool = True):
    """:func:`layer_decode` over the shards, each shard's cache updated in
    place -> outputs; ``ffn`` as in :func:`layer_apply_tp`."""
    hs = _norms(ps, xs, "ln1", cfg)
    if kind == "mamba2":
        return _add(xs, ssm_mod.mamba2_decode_tp(_sub(ps, "ssm"), hs, caches,
                                                 cfg, group))
    if kind == "recurrent":
        ys = rglru_mod.rglru_decode_tp(_sub(ps, "rglru"), hs, caches, cfg,
                                       group)
    elif cfg.attention == AttentionKind.MLA:
        fn = attn.mla_decode_kvseq if "c_kv" in seq_split \
            else attn.mla_decode_tp
        ys = fn(_sub(ps, "attn"), hs, caches, pos, cfg, group)
    else:
        window = cfg.window if kind == "local_attn" else 0
        fn = attn.gqa_decode_kvseq if "k" in seq_split \
            else attn.gqa_decode_tp
        ys = fn(_sub(ps, "attn"), hs, caches, pos, cfg, group, window=window)
    xs = _add(xs, ys)
    if kind == "dec_cross":
        fn = attn.cross_decode_kvseq if "xk" in seq_split \
            else attn.cross_decode_tp
        xs = _add(xs, fn(_sub(ps, "xattn"), _norms(ps, xs, "lnx", cfg),
                         _sub(caches, "xk"), _sub(caches, "xv"), cfg, group))
    return ffn_tp(ps, xs, cfg, kind, group)[0] if ffn else xs
