"""Model API over the dense GQA members of the architecture zoo.

The JAX package's ``models/model.py`` in PyTorch, for StarCoder2 (GELU
MLP) and Granite, DeepSeek-67B and Mistral-Large (SwiGLU). ``Model``
exposes:

  - ``param_specs()``                 tree of ParamSpec (no allocation)
  - ``init(generator)``               materialized params
  - ``forward(params, batch)``        hidden states after the final norm
  - ``prefill(params, batch, max_seq)``  -> (last logits, cache)
  - ``decode(params, cache, tokens)``    one-token serve step
  - ``cache_specs(batch, max_seq)``      decode-cache specs

Layouts are the reference's: stacked layer parameters (L, ...), caches
{"stacks": {"layers": {"k", "v": (L, B, T, KVH, Dh), "kpos": (L, T)}},
"pos": the next position}. A Python loop over the layers replaces
``lax.scan`` (each layer's parameters are views of the stack), and there
is no mesh, so the reference's sharding constraints have no counterpart.
Every other family raises ``NotImplementedError`` (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import AttentionKind, Family, ModelConfig
from repro_torch.models import params as prm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, embed_specs, rmsnorm,
                                       rmsnorm_spec, unembed)
from repro_torch.models.params import TensorSpec


@dataclasses.dataclass(frozen=True)
class StackDef:
    name: str
    kinds: tuple[str, ...]
    scan: bool

    @property
    def homogeneous_kind(self) -> str:
        assert self.scan
        return self.kinds[0]


def _stacks_for(cfg: ModelConfig) -> tuple[StackDef, ...]:
    if cfg.family == Family.SSM:
        return (StackDef("layers", ("mamba2",) * cfg.n_layers, True),)
    if cfg.family == Family.HYBRID:
        pat = cfg.hybrid.pattern
        kinds = tuple(pat[i % len(pat)] for i in range(cfg.n_layers))
        return (StackDef("layers", kinds, False),)
    if cfg.family == Family.AUDIO:
        return (StackDef("decoder", ("dec_cross",) * cfg.n_layers, True),)
    if cfg.moe is not None:
        fd = cfg.moe.first_dense
        stacks = []
        if fd:
            stacks.append(StackDef("dense_layers", ("attn_dense",) * fd, True))
        stacks.append(StackDef("moe_layers", ("attn_moe",) * (cfg.n_layers - fd), True))
        return tuple(stacks)
    return (StackDef("layers", ("attn_dense",) * cfg.n_layers, True),)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views, no copy)."""
    return prm.tree_map(lambda t: t[i], tree)


class Model:
    def __init__(self, cfg: ModelConfig):
        stacks = _stacks_for(cfg)
        dense = (cfg.family == Family.DENSE and cfg.moe is None
                 and cfg.attention == AttentionKind.GQA and not cfg.window
                 and cfg.encdec is None and not cfg.mtp_depth
                 and not cfg.n_frontend_tokens)
        if not dense:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family.value} with "
                f"{cfg.attention.value} attention is not ported yet (ROADMAP "
                "A12); the port runs dense GQA decoders")
        self.cfg = cfg
        self.stacks = stacks
        self.kind = stacks[0].homogeneous_kind

    # --- parameters --------------------------------------------------------

    def param_specs(self):
        cfg = self.cfg
        return {"embed": embed_specs(cfg),
                "layers": prm.map_stacked(tfm.layer_specs(cfg, self.kind),
                                          cfg.n_layers),
                "final_norm": rmsnorm_spec(cfg.d_model)}

    def init(self, generator: torch.Generator, device=None) -> Any:
        return prm.materialize(generator, self.param_specs(), device)

    # --- full-sequence forward ------------------------------------------------

    def _embed_inputs(self, params, batch):
        return embed(params["embed"], batch["tokens"]).to(torch.bfloat16)

    @staticmethod
    def _positions(x):
        b, s = x.shape[:2]
        return torch.arange(s, dtype=torch.int32,
                            device=x.device).expand(b, s)

    def forward(self, params, batch):
        """-> (hidden (B, S, d) post-final-norm, aux_loss 0)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = self._positions(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            x, a = tfm.layer_apply(_layer(params["layers"], i), x, positions,
                                   cfg, self.kind)
            aux = aux + a
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    # --- serving ------------------------------------------------------------------

    def cache_specs(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        one = tfm.layer_cache_spec(self.cfg, self.kind, batch, max_seq, dtype)
        layers = {k: TensorSpec((self.cfg.n_layers, *s.shape), s.dtype)
                  for k, s in one.items()}
        return {"stacks": {"layers": layers},
                "pos": TensorSpec((), torch.int32)}

    def prefill(self, params, batch, *, max_seq: int,
                cache_dtype=torch.bfloat16):
        """Full-sequence forward that also builds the decode cache.
        -> (logits (B, 1, V) fp32 at the last position, cache)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = self._positions(x)
        caches = []
        for i in range(cfg.n_layers):
            x, c = tfm.layer_prefill(_layer(params["layers"], i), x,
                                     positions, cfg, self.kind,
                                     max_seq=max_seq, cache_dtype=cache_dtype)
            caches.append(c)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], h[:, -1:], cfg)
        stack = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
        return logits, {"stacks": {"layers": stack}, "pos": x.shape[1]}

    def decode(self, params, cache, tokens):
        """One-token step. tokens: (B, 1) -> (logits (B, 1, V), cache).

        The new token's K/V are written into ``cache``'s tensors in place;
        the returned cache holds the same tensors and ``pos + 1``."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = embed(params["embed"], tokens).to(torch.bfloat16)
        stack = cache["stacks"]["layers"]
        for i in range(cfg.n_layers):
            x, _ = tfm.layer_decode(_layer(params["layers"], i), x,
                                    _layer(stack, i), pos, cfg, self.kind)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], h, cfg)
        return logits, {"stacks": {"layers": stack}, "pos": pos + 1}
