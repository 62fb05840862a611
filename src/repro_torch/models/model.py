"""Model API over the whole architecture zoo, the JAX package's
``models/model.py`` in PyTorch: dense GQA decoders (StarCoder2, Granite,
DeepSeek-67B, Mistral-Large), MoE with GQA or MLA (DeepSeekMoE-16B,
DeepSeek-V3), Mamba-2 (SSM), the Griffin hybrid (RecurrentGemma), the
encoder-decoder (Whisper) and the VLM backbone (Pixtral). ``Model``
exposes:

  - ``param_specs()``                 tree of ParamSpec (no allocation)
  - ``init(generator)``               materialized params
  - ``abstract_params()``             the params as meta tensors
  - ``loss(params, batch)``           next-token CE (+ MoE aux, + MTP)
  - ``forward(params, batch)``        hidden states after the final norm
  - ``prefill(params, batch, max_seq)``  -> (last logits, cache)
  - ``decode(params, cache, tokens)``    one-token serve step
  - ``cache_specs(batch, max_seq)``      decode-cache specs
  - ``input_specs(shape)``            a shape cell's inputs as meta tensors

Layouts are the reference's: stacked layer parameters (L, ...) for a
homogeneous stack, a list of per-layer trees for the Griffin interleave;
caches {"stacks": {name: stacked leaves, or a list for the interleave},
"pos": the next position}. A Python loop over the layers replaces
``lax.scan`` (each layer's parameters are views of the stack, unbound
once a call, so a stacked leaf's gradient is assembled once), and the
reference's sharding constraints have no counterpart: data parallelism
splits the batch in ``train/step.py``.

Training (``loss``): the reference's ``remat_policy`` per layer —
``"full"`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the matrix
products' outputs (selective checkpointing; where this PyTorch lacks it,
``"full"``), ``"none"`` keeps everything — the fp32 cross-entropy with
``-1`` labels masked, the MoE aux loss and DeepSeek-V3's multi-token
prediction head. Under autograd attention takes the plain chunked path,
as the reference's training does (``attention.takes_flash``).

``cfg.dtype`` is the activations' and the parameters' dtype: bf16, the
reference's, or ``"float32"`` for an fp32 model throughout (the parity
tests' training mode; the reference's ``cfg.dtype`` is inert, and its
tests run it in fp32 by giving its model module float32 where it names
bfloat16). The fp32 leaves of a bf16 model (the router, A_log, ...) stay
fp32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.configs.shapes import ShapeConfig
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


def _unstack(tree, n: int) -> list:
    """The ``n`` layer trees of a stacked tree: each leaf unbound once
    (views), so that under autograd the stack's gradient is one stack of
    the layers' gradients, not a full-size zero tensor per layer."""
    flat = list(prm.leaves(tree))
    parts = {path: t.unbind(0) for path, t in flat}
    return [prm.map_with_path(lambda path, _: parts[path][i], tree)
            for i in range(n)]


def _layers(st: StackDef, params, cache=None):
    """(kind, layer params, layer cache) of each layer of stack ``st``."""
    if st.scan:
        ps = _unstack(params, len(st.kinds))
        cs = None if cache is None else _unstack(cache, len(st.kinds))
    for i, kind in enumerate(st.kinds):
        if st.scan:
            yield kind, ps[i], None if cs is None else cs[i]
        else:
            yield kind, params[i], None if cache is None else cache[i]


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``"dots"``: keep the matrix
    products' outputs, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under the reference's remat policy: recomputed in the
    backward (``"full"``), with the products kept (``"dots"``, or
    ``"full"`` where this PyTorch has no selective checkpointing), or as
    it is (``"none"``, and whenever autograd is off)."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if policy == "dots" and hasattr(torch.utils.checkpoint,
                                    "create_selective_checkpoint_contexts"):
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False, **kw)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.stacks = _stacks_for(cfg)
        self._pe = {}
        # the activations' dtype (the reference's is bf16 whatever cfg says)
        self.dtype = torch.float32 if cfg.dtype == "float32" \
            else torch.bfloat16

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
        if cfg.dtype == "float32":
            specs = prm.tree_map(
                lambda s: dataclasses.replace(s, dtype=torch.float32), specs)
        return specs

    def init(self, generator: torch.Generator, device=None) -> Any:
        return prm.materialize(generator, self.param_specs(), device)

    def abstract_params(self):
        """The parameter tree as meta tensors (shapes and dtypes only)."""
        return prm.tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                  device="meta"),
                            self.param_specs())

    # --- embedding / frontends ----------------------------------------------

    def _embed_inputs(self, params, batch):
        """Token embeddings in bf16; a VLM's ``patches`` (B, n, d) replace
        the first n positions (so a prompt of at most n tokens is all
        patches, n positions long)."""
        x = embed(params["embed"], batch["tokens"]).to(self.dtype)
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
        x = (frames.float() + pe).to(self.dtype)
        positions = self._positions(x)
        def body(p, xc):
            return tfm.layer_apply(p, xc, positions, cfg, "enc",
                                   causal=False)[0]
        run = _remat(body, cfg.remat_policy)
        for p in _unstack(params["encoder"], cfg.encdec.n_encoder_layers):
            x = run(p, x)
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
                def body(lp, xc, _kind=kind):
                    return tfm.layer_apply(lp, xc, positions, cfg, _kind,
                                           enc_out=enc_out,
                                           n_moe_groups=n_moe_groups)
                x, a = _remat(body, cfg.remat_policy)(p, x)
                aux = aux + a
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    # --- training loss ----------------------------------------------------------

    @staticmethod
    def _ce(logits, labels):
        """fp32 CE with -1 = masked. -> (sum_loss, n_valid)."""
        valid = labels >= 0
        lab = torch.where(valid, labels, 0).long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (lse - gold) * valid
        return torch.sum(nll), torch.sum(valid.float())

    def loss_parts(self, params, batch, *, n_moe_groups: int = 1) -> dict:
        """The loss's parts before normalisation: ``nll`` / ``n`` (the
        next-token NLL sum and valid count), ``aux`` (MoE), and with an
        MTP head ``mtp_nll`` / ``mtp_n``. A data shard's parts over its
        slice of the batch add up to the whole batch's."""
        cfg = self.cfg
        h, aux = self.forward(params, batch, n_moe_groups=n_moe_groups)
        logits = unembed(params["embed"], h, cfg)
        nll, n = self._ce(logits, batch["labels"])
        out = {"nll": nll, "n": n, "aux": aux}
        if cfg.mtp_depth:
            mtp = params["mtp"]
            tokens = batch["tokens"]
            e_next = embed(params["embed"], tokens[:, 1:]).to(h.dtype)
            x_mtp = torch.cat(
                [rmsnorm(mtp["norm_h"], h[:, :-1], cfg.norm_eps),
                 rmsnorm(mtp["norm_e"], e_next, cfg.norm_eps)], dim=-1)
            x_mtp = torch.einsum("bsk,kd->bsd", x_mtp, mtp["proj"])
            kind = "attn_moe" if cfg.moe is not None else "attn_dense"
            y, _ = tfm.layer_apply(mtp["layer"], x_mtp,
                                   self._positions(x_mtp), cfg, kind,
                                   n_moe_groups=n_moe_groups)
            h_mtp = rmsnorm(mtp["final_norm"], y, cfg.norm_eps)
            logits_mtp = unembed(params["embed"], h_mtp, cfg)
            out["mtp_nll"], out["mtp_n"] = self._ce(logits_mtp,
                                                    batch["labels"][:, 1:])
        return out

    def combine_loss(self, parts: dict, n, mtp_n=None):
        """``(loss, metrics)`` from :meth:`loss_parts` normalised by the
        valid counts ``n`` (and ``mtp_n``) — the batch's own, or a global
        count when ``parts`` are one data shard's share."""
        one = torch.ones((), dtype=torch.float32, device=parts["nll"].device)
        ce = parts["nll"] / torch.maximum(n, one)
        loss = ce
        metrics = {"ce": ce, "aux": parts["aux"], "tokens": parts["n"]}
        if "mtp_nll" in parts:
            mtp_loss = parts["mtp_nll"] / torch.maximum(mtp_n, one)
            metrics["mtp_ce"] = mtp_loss
            loss = loss + 0.3 * mtp_loss
        loss = loss + parts["aux"]
        metrics["loss"] = loss
        return loss, metrics

    def loss(self, params, batch, *, n_moe_groups: int = 1):
        """``(loss, metrics)``: next-token CE (+ 0.3 x the MTP head's CE)
        + the MoE aux loss, the reference's ``Model.loss``."""
        parts = self.loss_parts(params, batch, n_moe_groups=n_moe_groups)
        return self.combine_loss(parts, parts["n"], parts.get("mtp_n"))

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
        x = embed(params["embed"], tokens).to(self.dtype)
        x = self._add_positions(x, pos)
        for st in self.stacks:
            for kind, p, c in _layers(st, params[st.name],
                                      cache["stacks"][st.name]):
                x, _ = tfm.layer_decode(p, x, c, pos, cfg, kind)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], h, cfg)
        return logits, {"stacks": cache["stacks"], "pos": pos + 1}

    # --- input specs --------------------------------------------------------------

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Every model input of a shape cell as meta tensors. Train cells
        with gradient accumulation are microbatch-major: each leaf is
        (M, B/M, ...)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")
        if shape.kind == "decode":
            return {"tokens": meta((b, 1), torch.int32)}
        m = shape.num_microbatches if shape.kind == "train" else 1
        lead = (m, b // m) if m > 1 else (b,)
        specs = {"tokens": meta((*lead, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = meta((*lead, s), torch.int32)
        if cfg.encdec is not None:
            specs["frames"] = meta((*lead, cfg.encdec.encoder_seq,
                                    cfg.d_model), torch.bfloat16)
        if cfg.family == Family.VLM and cfg.n_frontend_tokens:
            specs["patches"] = meta((*lead, cfg.n_frontend_tokens,
                                     cfg.d_model), torch.bfloat16)
        return specs

    def input_logical(self, shape: ShapeConfig) -> dict:
        m = shape.num_microbatches if shape.kind == "train" else 1
        lead = (None, "batch") if m > 1 else ("batch",)
        out = {"tokens": (*lead, None)}
        if shape.kind == "train":
            out["labels"] = (*lead, None)
        if shape.kind != "decode":
            if self.cfg.encdec is not None:
                out["frames"] = (*lead, None, None)
            if self.cfg.family == Family.VLM and self.cfg.n_frontend_tokens:
                out["patches"] = (*lead, None, None)
        return out
