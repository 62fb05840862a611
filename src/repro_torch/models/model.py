"""Model API over the whole architecture zoo, the JAX package's
``models/model.py`` in PyTorch: dense GQA decoders (StarCoder2, Granite,
DeepSeek-67B, Mistral-Large), MoE with GQA or MLA (DeepSeekMoE-16B,
DeepSeek-V3), Mamba-2 (SSM), the Griffin hybrid (RecurrentGemma), the
encoder-decoder (Whisper) and the VLM backbone (Pixtral). ``Model``
exposes:

  - ``param_specs()``                 tree of ParamSpec (no allocation)
  - ``init(generator)``               materialized params
  - ``forward(params, batch)``        hidden states after the final norm
  - ``prefill(params, batch, max_seq)``  -> (last logits, cache)
  - ``decode(params, cache, tokens)``    one-token serve step
  - ``cache_specs(batch, max_seq)``      decode-cache specs

Layouts are the reference's: stacked layer parameters (L, ...) for a
homogeneous stack, a list of per-layer trees for the Griffin interleave;
caches {"stacks": {name: stacked leaves, or a list for the interleave},
"pos": the next position}. A Python loop over the layers replaces
``lax.scan`` (each layer's parameters are views of the stack), and there
is no mesh, so the reference's sharding constraints have no counterpart.
The multi-token-prediction head's parameters are in ``param_specs`` (the
reference's ``mtp`` subtree); its forward belongs to the training loss
(ROADMAP §A item 6, training).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.models import params as prm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, embed_specs, rmsnorm,
                                       rmsnorm_spec, sinusoidal_positions,
                                       unembed)
from repro_torch.models.params import ParamSpec, TensorSpec

# rows of the decoder's sinusoidal table that decode reads (the reference's)
DECODE_PE_ROWS = 65536


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
        stacks.append(StackDef("moe_layers",
                               ("attn_moe",) * (cfg.n_layers - fd), True))
        return tuple(stacks)
    return (StackDef("layers", ("attn_dense",) * cfg.n_layers, True),)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views, no copy)."""
    return prm.tree_map(lambda t: t[i], tree)


def _layers(st: StackDef, params, cache=None):
    """(kind, layer params, layer cache) of each layer of stack ``st``."""
    for i, kind in enumerate(st.kinds):
        if st.scan:
            yield kind, _layer(params, i), \
                None if cache is None else _layer(cache, i)
        else:
            yield kind, params[i], None if cache is None else cache[i]


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.stacks = _stacks_for(cfg)
        self._pe = {}

    # --- parameters --------------------------------------------------------

    def param_specs(self):
        cfg = self.cfg
        specs: dict[str, Any] = {"embed": embed_specs(cfg)}
        for st in self.stacks:
            if st.scan:
                one = tfm.layer_specs(cfg, st.homogeneous_kind)
                specs[st.name] = prm.map_stacked(one, len(st.kinds))
            else:
                specs[st.name] = [tfm.layer_specs(cfg, k) for k in st.kinds]
        specs["final_norm"] = rmsnorm_spec(cfg.d_model)
        if cfg.encdec is not None:
            enc_one = tfm.layer_specs(cfg, "enc")
            specs["encoder"] = prm.map_stacked(enc_one,
                                               cfg.encdec.n_encoder_layers)
            specs["enc_norm"] = rmsnorm_spec(cfg.d_model)
        if cfg.mtp_depth:
            kind = "attn_moe" if cfg.moe is not None else "attn_dense"
            specs["mtp"] = {
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                                  ("embed", None)),
                "norm_h": rmsnorm_spec(cfg.d_model),
                "norm_e": rmsnorm_spec(cfg.d_model),
                "layer": tfm.layer_specs(cfg, kind),
                "final_norm": rmsnorm_spec(cfg.d_model),
            }
        return specs

    def init(self, generator: torch.Generator, device=None) -> Any:
        return prm.materialize(generator, self.param_specs(), device)

    # --- embedding / frontends ----------------------------------------------

    def _embed_inputs(self, params, batch):
        """Token embeddings in bf16; a VLM's ``patches`` (B, n, d) replace
        the first n positions (so a prompt of at most n tokens is all
        patches, n positions long)."""
        x = embed(params["embed"], batch["tokens"]).to(torch.bfloat16)
        if self.cfg.family == Family.VLM and "patches" in batch:
            n = batch["patches"].shape[1]
            x = torch.cat([batch["patches"].to(x.dtype), x[:, n:]], dim=1)
        return x

    @staticmethod
    def _positions(x):
        b, s = x.shape[:2]
        return torch.arange(s, dtype=torch.int32,
                            device=x.device).expand(b, s)

    def _pe_table(self, device):
        """The decoder's (DECODE_PE_ROWS, d) sinusoidal table, built once
        per model and device."""
        key = str(device)
        if key not in self._pe:
            self._pe[key] = sinusoidal_positions(DECODE_PE_ROWS,
                                                 self.cfg.d_model, device)
        return self._pe[key]

    def _add_positions(self, x, start: int = 0):
        """An encoder-decoder without rope adds sinusoidal positions to the
        decoder's input (rows ``start ..`` of the table)."""
        cfg = self.cfg
        if cfg.rope_theta > 0 or cfg.family != Family.AUDIO:
            return x
        pe = self._pe_table(x.device)[start:start + x.shape[1]]
        return (x.float() + pe).to(x.dtype)

    def _encode(self, params, frames):
        """The encoder stack over ``frames`` (B, T, d) with sinusoidal
        positions, bidirectional, then its final norm."""
        cfg = self.cfg
        pe = sinusoidal_positions(frames.shape[1], cfg.d_model, frames.device)
        x = (frames.float() + pe).to(torch.bfloat16)
        positions = self._positions(x)
        enc = params["encoder"]
        for i in range(cfg.encdec.n_encoder_layers):
            x, _ = tfm.layer_apply(_layer(enc, i), x, positions, cfg, "enc",
                                   causal=False)
        return rmsnorm(params["enc_norm"], x, cfg.norm_eps)

    def _enc_out(self, params, batch):
        if self.cfg.encdec is None:
            return None
        return self._encode(params, batch["frames"])

    # --- full-sequence forward ------------------------------------------------

    def forward(self, params, batch, *, n_moe_groups: int = 1):
        """-> (hidden (B, S, d) post-final-norm, aux_loss)."""
        cfg = self.cfg
        x = self._add_positions(self._embed_inputs(params, batch))
        positions = self._positions(x)
        enc_out = self._enc_out(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for st in self.stacks:
            for kind, p, _ in _layers(st, params[st.name]):
                x, a = tfm.layer_apply(p, x, positions, cfg, kind,
                                       enc_out=enc_out,
                                       n_moe_groups=n_moe_groups)
                aux = aux + a
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    # --- serving ------------------------------------------------------------------

    def cache_specs(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        cfg = self.cfg
        caches: dict[str, Any] = {}
        for st in self.stacks:
            if st.scan:
                one = tfm.layer_cache_spec(cfg, st.homogeneous_kind, batch,
                                           max_seq, dtype)
                caches[st.name] = {k: TensorSpec((len(st.kinds), *s.shape),
                                                 s.dtype)
                                   for k, s in one.items()}
            else:
                caches[st.name] = [tfm.layer_cache_spec(cfg, k, batch,
                                                        max_seq, dtype)
                                   for k in st.kinds]
        return {"stacks": caches, "pos": TensorSpec((), torch.int32)}

    def cache_logical(self):
        cfg = self.cfg
        out: dict[str, Any] = {}
        for st in self.stacks:
            if st.scan:
                one = tfm.cache_logical(st.homogeneous_kind, cfg)
                out[st.name] = {k: ("layers", *v) for k, v in one.items()}
            else:
                out[st.name] = [tfm.cache_logical(k, cfg) for k in st.kinds]
        return {"stacks": out, "pos": ()}

    def prefill(self, params, batch, *, max_seq: int,
                cache_dtype=torch.bfloat16):
        """Full-sequence forward that also builds the decode cache.
        -> (logits (B, 1, V) fp32 at the last position, cache)."""
        cfg = self.cfg
        x = self._add_positions(self._embed_inputs(params, batch))
        positions = self._positions(x)
        enc_out = self._enc_out(params, batch)
        caches: dict[str, Any] = {}
        for st in self.stacks:
            per_layer, stacked = [], None
            for i, (kind, p, _) in enumerate(_layers(st, params[st.name])):
                x, c = tfm.layer_prefill(p, x, positions, cfg, kind,
                                         max_seq=max_seq, enc_out=enc_out,
                                         cache_dtype=cache_dtype)
                if not st.scan:
                    per_layer.append(c)
                    continue
                if stacked is None:         # stacked in place, layer by layer
                    stacked = {k: t.new_empty((len(st.kinds), *t.shape))
                               for k, t in c.items()}
                for k, t in c.items():
                    stacked[k][i] = t
            caches[st.name] = stacked if st.scan else per_layer
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], h[:, -1:], cfg)
        return logits, {"stacks": caches, "pos": x.shape[1]}

    def decode(self, params, cache, tokens):
        """One-token step. tokens: (B, 1) -> (logits (B, 1, V), cache).

        The new token's state is written into ``cache``'s tensors in place;
        the returned cache holds the same tensors and ``pos + 1``."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = embed(params["embed"], tokens).to(torch.bfloat16)
        x = self._add_positions(x, pos)
        for st in self.stacks:
            for kind, p, c in _layers(st, params[st.name],
                                      cache["stacks"][st.name]):
                x, _ = tfm.layer_decode(p, x, c, pos, cfg, kind)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], h, cfg)
        return logits, {"stacks": cache["stacks"], "pos": pos + 1}
