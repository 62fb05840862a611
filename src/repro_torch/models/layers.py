"""Shared layer primitives: norms, rope, embeddings, dense MLPs.

The JAX package's ``models/layers.py`` in PyTorch. All forwards are pure
functions ``(params, x) -> y``; activations compute in the config dtype
(bf16) with fp32 norm statistics, rotary angles and activation functions,
rounding back where the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.models.params import ParamSpec


# --- norms -------------------------------------------------------------------

def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(w, x, eps: float = 1e-5):
    """Statistics in fp32, the result cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


# --- rotary embeddings ---------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)                             # (dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S). Rotates the two HALVES of
    the head dimension (not interleaved pairs), in fp32."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                    # (d/2,)
    ang = positions[..., None].float() * inv                # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None):
    """(seq, d) fp32 sinusoidal position table: sin on even columns, cos on
    odd ones. Built on the CPU in fp32, the reference's arithmetic step for
    step, then moved to ``device``."""
    pos = torch.arange(seq, dtype=torch.float32)[:, None]
    step = -torch.log(torch.tensor(10000.0)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32) * step)
    pe = torch.zeros((seq, d), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(device)


# --- embedding -----------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    specs = {"embedding": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", None),
                                    init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return specs


def embed(params, tokens):
    return params["embedding"][tokens]


def unembed(params, x, cfg: ModelConfig):
    """Logits as the product in ``x``'s dtype (bf16), then cast to fp32:
    the values are bf16 values, as the reference's are."""
    w = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("...d,dv->...v", x, w).float()


# --- dense MLP -----------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    specs = {
        "up": ParamSpec((d, f), ("embed", "mlp")),
        "down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.mlp_gated:
        specs["gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return specs


def mlp(params, x, cfg: ModelConfig):
    """SwiGLU (gated) or GELU MLP. ``jax.nn.gelu`` defaults to the tanh
    approximation, so this one does too."""
    up = torch.einsum("...d,df->...f", x, params["up"])
    if cfg.mlp_gated:
        gate = torch.einsum("...d,df->...f", x, params["gate"])
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return torch.einsum("...f,fd->...d", h, params["down"])


# --- tensor parallelism over the model axis ------------------------------------
#
# Lists over the shards of one data row: each shard's leaves (``ps``) and
# its copy of the replicated activations; ``group`` is the row's
# ``core.collectives.Group``. A width split over the shards shows in the
# shard's leaf shapes.

def embed_tp(ps, tokens, vocab: int, group):
    """Vocab-parallel lookup: shard j holds rows j*n .. (j+1)*n - 1 of the
    table (or every row); a token outside them looks up zeros, and the
    shards' lookups are summed."""
    n = ps[0]["embedding"].shape[0]
    if n == vocab:
        return [embed(p, t) for p, t in zip(ps, tokens)]
    parts = []
    for j, (p, t) in enumerate(zip(ps, tokens)):
        local = t - j * n
        inside = (local >= 0) & (local < n)
        rows = p["embedding"][local.clamp(0, n - 1)]
        parts.append(torch.where(inside[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device)))
    return group.sum(parts)


def unembed_tp(ps, hs, cfg: ModelConfig, group):
    """Vocab-parallel logits, gathered over the vocab onto the row's
    first shard (the loss and the returned logits read them there). A
    vocab the shards do not split (every shard holds all of it) is cut
    into blocks of ceil(V / n) columns all the same, each shard computing
    one, as the reference's partitioner splits a replicated product."""
    n = group.size
    w0 = ps[0]["embedding"] if cfg.tie_embeddings else ps[0]["lm_head"]
    if n > 1 and w0.shape[0 if cfg.tie_embeddings else 1] == cfg.vocab:
        c = -(-cfg.vocab // n)
        parts = []
        for j, (p, h) in enumerate(zip(ps, hs)):
            lo, hi = min(j * c, cfg.vocab), min((j + 1) * c, cfg.vocab)
            w = p["embedding"][lo:hi].T if cfg.tie_embeddings \
                else p["lm_head"][:, lo:hi]
            parts.append(torch.einsum("...d,dv->...v", h, w).float())
        return collectives.all_gather(parts, -1, [group.devices[0]])[0]
    parts = [unembed(p, h, cfg) for p, h in zip(ps, hs)]
    if parts[0].shape[-1] == cfg.vocab:
        return parts[0]
    return collectives.all_gather(parts, -1, [group.devices[0]])[0]


def mlp_tp(ps, hs, cfg: ModelConfig, group, d_ff: int | None = None):
    """Column- then row-parallel MLP over ``mlp``: each shard's partial
    down projection, all-reduced."""
    ys = [mlp(p, h, cfg) for p, h in zip(ps, hs)]
    return group.reduce(ys, ps[0]["up"].shape[-1] != (d_ff or cfg.d_ff))
