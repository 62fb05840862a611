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
once a call, so a stacked leaf's gradient is assembled once).

On a mesh (``Model(cfg, mesh=, rules=)``, the reference's signature;
``train_rules(mesh)`` by default) ``init`` returns the placed tree — each
leaf a ``sharding.Sharded`` (on a mesh of one entry, plain tensors) — and
``forward`` / ``loss_parts`` / ``prefill`` / ``decode`` run on it: each
data row of the mesh takes its slice of the batch, and within a row each
layer runs shard by shard over the model axis
(``transformer.layer_*_tp``), the residual stream replicated over the
shards. A leaf split over the data axes (FSDP's ``embed``) is gathered
for the layer that reads it. A MoE layer routes each token once, in the
unsharded model's dispatch groups (:meth:`Model._ffn_rows`). Outputs
come back whole: logits gathered
over the vocab and the rows, the decode cache placed as
:meth:`cache_placements` says. ``param_specs`` / ``abstract_params`` stay
global. Every tensor that crosses shards goes through
``core/collectives.py``.

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

from repro_torch import sharding as shd
from repro_torch import tree as tr
from repro_torch.configs.base import Family, ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import collectives
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as prm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, embed_specs, embed_tp, rmsnorm,
                                       rmsnorm_spec, sinusoidal_positions,
                                       unembed, unembed_tp)
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


class Rows:
    """A mesh seen as data rows of model shards: entries in row-major
    order with the ``model`` axis last, row ``r``'s shards entries ``r * M
    .. r * M + M - 1``, each row's shards a ``collectives.Group``."""

    def __init__(self, mesh):
        names = mesh.axis_names
        if "model" in names and names[-1] != "model":
            raise ValueError(f"mesh axes {names}: 'model' must come last")
        self.mesh = mesh
        self.m = mesh.shape.get("model", 1)
        self.n = mesh.size // self.m
        flat = mesh.flat()
        self.groups = [collectives.Group(flat[r * self.m:(r + 1) * self.m])
                       for r in range(self.n)]
        # the rows that compute; the dry run (launch/dryrun.py) runs one
        # and lets it stand for the rest, which run the same program on
        # slices of the same shapes
        self.live = list(range(self.n))

    def entries(self, r: int) -> range:
        return range(r * self.m, (r + 1) * self.m)

    def kept(self) -> list | None:
        """The live rows' mesh entries, or None where every row
        computes."""
        if len(self.live) == self.n:
            return None
        return [e for r in self.live for e in self.entries(r)]

    def map(self, fn, rows=None) -> list:
        """``fn(r)`` for every row (or each of ``rows``): computed for the
        live rows, the first one's result (detached: a stand-in passes no
        gradient back) standing for each other row's."""
        want = range(self.n) if rows is None else rows
        done = {r: fn(r) for r in want if r in self.live}
        if len(done) == len(want):
            return [done[r] for r in want]
        stand_in = tr.tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
            next(iter(done.values())))
        return [done.get(r, stand_in) for r in want]


def _gather_over_rows(t_entry, pl: shd.Placement, e: int, k: int,
                      dim: int, dev, kept=None):
    """Entry ``e``'s block of a leaf with dim ``k`` whole over the data
    axes that split it: the blocks of the entries that differ from ``e``
    only on those axes, all-gathered along ``dim``. Where only the
    entries ``kept`` compute (``Rows.kept``, on meta), ``e``'s own block
    stands in for each other peer's: the gather's adjoint then hands
    ``e`` the gradient pieces that those peers' own gathers would have
    sent it, one for each, as in the run where every row computes."""
    axes = pl.dim_axes(k)
    if "model" in axes:
        raise NotImplementedError(f"{pl}: dim {k} split over {axes}")
    peers = _peers(pl.mesh.devices.shape, pl.mesh.axis_names, axes, e)
    return collectives.all_gather(
        [t_entry(i if kept is None or i in kept else e) for i in peers],
        dim, [dev], at=[e])[0]


@functools.lru_cache(maxsize=4096)
def _peers(shape: tuple, names: tuple, axes: tuple, e: int) -> tuple:
    """The mesh entries that differ from ``e`` only on ``axes``, in the
    order of the block they hold along a dim split over ``axes`` (major
    axis first)."""
    table = shd._coords(shape, names)
    mine = table[e]
    sizes = dict(zip(names, shape))
    peers = [i for i, c in enumerate(table)
             if all(v == mine[a] for a, v in c.items() if a not in axes)]

    def block(i):
        b = 0
        for a in axes:
            b = b * sizes[a] + table[i][a]
        return b
    return tuple(sorted(peers, key=block))


class PlacedView:
    """One call's view of a placed tree, row by row: each shard's leaves
    (a stacked leaf's layers unbound once, FSDP's data-split dims
    gathered per use)."""

    def __init__(self, rows: Rows):
        self.rows = rows
        self._unbound: dict = {}
        kept = rows.kept()
        self._kept = None if kept is None else set(kept)

    def _layers(self, leaf: shd.Sharded) -> list:
        key = id(leaf)
        if key not in self._unbound:
            self._unbound[key] = [t.unbind(0) for t in leaf.shards]
        return self._unbound[key]

    def prepare(self, tree) -> None:
        """Unbind a stacked tree's leaves (outside any recomputed
        region)."""
        for leaf in tr.leaves(tree):
            self._layers(leaf)

    def leaf(self, leaf, r: int, layer=None) -> list:
        """Row ``r``'s shards of ``leaf`` (layer ``layer`` of a stacked
        one), whole over the data axes."""
        if not isinstance(leaf, shd.Sharded):
            raise TypeError(
                "a model on a mesh runs on placed leaves, got "
                f"{type(leaf).__name__}: place the tree with "
                "sharding.place_tree(tree, model.param_placements())")
        pl = leaf.placement
        if layer is None:
            def block(i):
                return leaf.shards[i]
        else:
            views = self._layers(leaf)

            def block(i):
                return views[i][layer]
        dp_dims = [k for k in range(len(pl.shape))
                   if any(a != "model" and pl.mesh.shape[a] > 1
                          for a in pl.dim_axes(k))]
        if len(dp_dims) > 1:
            raise NotImplementedError(f"{pl}: several dims split over the "
                                      "data axes")
        out = []
        for e in self.rows.entries(r):
            if not dp_dims:
                out.append(block(e))
                continue
            k = dp_dims[0]
            out.append(_gather_over_rows(block, pl, e, k,
                                         k - (layer is not None),
                                         pl.devices[e], self._kept))
        return out

    def shards(self, tree, r: int, layer=None) -> list:
        """Row ``r``'s per-shard trees of ``tree``."""
        flat, treedef = tr.flatten(tree)
        per = [self.leaf(x, r, layer) for x in flat]
        return [tr.unflatten(treedef, [p[j] for p in per])
                for j in range(self.rows.m)]


_INPUT_LOGICAL = {"tokens": ("batch", None), "labels": ("batch", None),
                  "frames": ("batch", None, None),
                  "patches": ("batch", None, None)}


@dataclasses.dataclass
class PlacedInputs:
    """A batch on a mesh: ``parts[name]`` one tensor per mesh entry, and
    whether the data axes split the batch (else every row holds all of
    it)."""
    parts: dict
    split: bool


class Model:
    def __init__(self, cfg: ModelConfig, mesh=None, rules=None):
        self.cfg = cfg
        self.stacks = _stacks_for(cfg)
        self._pe = {}
        # the activations' dtype (the reference's is bf16 whatever cfg says)
        self.dtype = torch.float32 if cfg.dtype == "float32" \
            else torch.bfloat16
        self.mesh = mesh
        self.rules = rules if rules is not None or mesh is None \
            else shd.train_rules(mesh)
        self.rows = None
        if mesh is not None and mesh.size > 1:
            self.rows = Rows(mesh)
            # seq_parallel_attn: attention splits its queries over the
            # model axis (attention._gqa_full_seq)
            axes = shd._entry_axes(self.rules.mesh_axes("attn_q_seq"))
            q_seq = "model" in axes and mesh.shape.get("model", 1) > 1
            for g in self.rows.groups:
                g.q_seq = q_seq

    @property
    def sharded(self) -> bool:
        """Whether the model runs on placed (split) trees."""
        return self.rows is not None

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
        """Seeded parameters: each leaf drawn whole from ``generator`` on
        ``device`` (the generator's by default), and on a mesh placed as
        :meth:`param_placements` says."""
        specs = self.param_specs()
        if self.mesh is None:
            return prm.materialize(generator, specs, device)
        return prm.materialize(generator, specs, device,
                               placements=self.param_placements())

    def param_placements(self):
        """Each parameter's ``sharding.Placement`` on the model's mesh."""
        return prm.shardings(self.param_specs(), self.mesh, self.rules)

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
        if self.sharded:
            return self._forward_placed(params, batch, n_moe_groups)
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
        slice of the batch add up to the whole batch's (on a mesh, the
        rows' parts summed onto the first shard)."""
        if self.sharded:
            return self._loss_parts_placed(params, batch, n_moe_groups)
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

    def cache_placements(self, batch: int, max_seq: int,
                         dtype=torch.bfloat16):
        """Each decode-cache leaf's ``sharding.Placement`` on the model's
        mesh (``pos`` excepted: a Python int)."""
        specs = self.cache_specs(batch, max_seq, dtype)["stacks"]
        logical = self.cache_logical()["stacks"]
        out: dict[str, Any] = {}
        for st in self.stacks:
            def one(lg, sp):
                return self.rules.sharding(self.mesh, lg, sp.shape,
                                           segments=sp.segments)
            if st.scan:
                out[st.name] = {k: one(logical[st.name][k], v)
                                for k, v in specs[st.name].items()}
            else:
                out[st.name] = [{k: one(lg[k], v) for k, v in sp.items()}
                                for lg, sp in zip(logical[st.name],
                                                  specs[st.name])]
        return out

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

    def prefill(self, params, batch, *, max_seq: int, cache_dtype=None):
        """Full-sequence forward that also builds the decode cache, in
        ``cache_dtype`` (the model's dtype by default: bf16, or fp32 for
        an fp32 model). -> (logits (B, 1, V) fp32 at the last position,
        cache)."""
        cache_dtype = cache_dtype or self.dtype
        if self.sharded:
            return self._prefill_placed(params, batch, max_seq, cache_dtype)
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
        if self.sharded:
            return self._decode_placed(params, cache, tokens)
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

    # --- on a mesh ------------------------------------------------------------

    def place_inputs(self, batch) -> "PlacedInputs":
        """Each input split over the data axes by the batch (replicated
        where they do not divide it), one tensor per mesh entry."""
        parts, split = {}, False
        for k, v in batch.items():
            v = torch.as_tensor(v)
            logical = _INPUT_LOGICAL.get(k, ("batch",) + (None,) *
                                         (v.dim() - 1))
            pl = self.rules.sharding(self.mesh, logical, tuple(v.shape))
            parts[k] = pl.split(v)
            split = split or pl.splits("data") or pl.splits("pod")
        return PlacedInputs(parts, split)

    def _row(self, inputs, name: str, r: int) -> list:
        return [inputs.parts[name][e] for e in self.rows.entries(r)]

    def _gather_rows(self, inputs, parts: list):
        """Row results (B_r, ...) on each row's first shard -> the whole
        batch on the mesh's first device (row 0's where every row holds
        the whole batch)."""
        if len(parts) == 1 or not inputs.split:
            return parts[0]
        return collectives.all_gather(parts, 0, [self.mesh.flat()[0]])[0]

    def _row_embed(self, view, params, inputs, r: int):
        cfg = self.cfg
        group = self.rows.groups[r]
        emb = view.shards(params["embed"], r)
        xs = [x.to(self.dtype) for x in embed_tp(
            emb, self._row(inputs, "tokens", r), cfg.vocab, group)]
        if cfg.family == Family.VLM and "patches" in inputs.parts:
            pats = self._row(inputs, "patches", r)
            n = pats[0].shape[1]
            xs = [torch.cat([p.to(x.dtype), x[:, n:]], dim=1)
                  for p, x in zip(pats, xs)]
        return emb, [self._add_positions(x) for x in xs]

    def _row_encode(self, view, params, inputs, r: int):
        cfg = self.cfg
        if cfg.encdec is None:
            return None
        group = self.rows.groups[r]
        xs = []
        for f in self._row(inputs, "frames", r):
            pe = sinusoidal_positions(f.shape[1], cfg.d_model, f.device)
            xs.append((f.float() + pe).to(self.dtype))
        positions = [self._positions(x) for x in xs]
        view.prepare(params["encoder"])
        for i in range(cfg.encdec.n_encoder_layers):
            def body(*xc, _i=i):
                ps = view.shards(params["encoder"], r, _i)
                return tuple(tfm.layer_apply_tp(ps, list(xc), positions, cfg,
                                                "enc", group,
                                                causal=False)[0])
            xs = list(_remat(body, cfg.remat_policy)(*xs))
        norms = view.leaf(params["enc_norm"], r)
        return [rmsnorm(w, x, cfg.norm_eps) for w, x in zip(norms, xs)]

    def _layer_params(self, view, params, st: StackDef, r: int, i: int):
        if st.scan:
            return view.shards(params[st.name], r, i)
        return view.shards(params[st.name][i], r)

    def _ffn_rows(self, ps: list, kind: str, mids: list, inputs,
                  n_moe_groups: int):
        """The FFN half of a layer over every row (``ps``: each row's
        shards' layer leaves). A MoE layer routes each token once, in the
        unsharded model's dispatch groups: where those groups fall on the
        rows' bounds, each row routes its own tokens in its own groups
        and the aux loss is reckoned once from the rows' summed router
        loads; otherwise row 0 routes the whole batch, all-gathered onto
        it, and each row gets its slice of the output back."""
        cfg = self.cfg
        rows = range(len(mids))
        groups = self.rows.groups
        if kind != "attn_moe":
            return self.rows.map(lambda r: tfm.ffn_tp(
                ps[r], mids[r], cfg, kind, groups[r])[0]), None
        h2 = self.rows.map(lambda r: [rmsnorm(p["ln2"], x, cfg.norm_eps)
                                      for p, x in zip(ps[r], mids[r])])
        experts = [[p["moe"] for p in ps[r]] for r in rows]
        n = len(mids) if inputs.split else 1   # rows that split the batch
        b, s = mids[0][0].shape[:2]
        tokens = n * b * s
        g = n_moe_groups if tokens % n_moe_groups == 0 else 1
        dev = self.mesh.flat()[0]
        if g % n == 0:
            def route(r):
                ys, ld = moe_mod.moe_ffn_tp(experts[r], h2[r], cfg,
                                            groups[r], n_groups=g // n,
                                            load=True)
                return [x + y for x, y in zip(mids[r], ys)], ld
            outs, loads = zip(*self.rows.map(route))
            return list(outs), moe_mod.balance_loss(list(loads[:n]), tokens,
                                                    cfg, dev)
        whole = [collectives.all_gather([h2[r][j] for r in rows], 0,
                                        [h2[0][j].device])[0]
                 for j in range(self.rows.m)]
        ys, ld = moe_mod.moe_ffn_tp(experts[0], whole, cfg, groups[0],
                                    n_groups=g, load=True)
        # a one-part reduce_scatter: row 0's output cut into the rows'
        # slices, each onto its row's shard
        cut = [collectives.reduce_scatter(
            [y], 0, [mids[r][j].device for r in rows],
            at=[r * self.rows.m + j for r in rows])
               for j, y in enumerate(ys)]
        return (self.rows.map(lambda r: [x + c[r]
                                         for x, c in zip(mids[r], cut)]),
                moe_mod.balance_loss([ld], tokens, cfg, dev))

    def _rows_hidden(self, view, params, inputs, n_moe_groups: int):
        """Every row's final hidden states per shard, the aux loss (once)
        and each row's shards' embedding leaves; layer by layer over the
        rows."""
        cfg = self.cfg
        rows = range(self.rows.n)
        embs, xs = zip(*self.rows.map(
            lambda r: self._row_embed(view, params, inputs, r)))
        xs = [list(x) for x in xs]
        positions = self.rows.map(lambda r: [self._positions(x)
                                             for x in xs[r]])
        enc = self.rows.map(lambda r: self._row_encode(view, params, inputs,
                                                       r))
        aux = torch.zeros((), dtype=torch.float32,
                          device=self.mesh.flat()[0])
        m = self.rows.m
        for st in self.stacks:
            if st.scan:
                view.prepare(params[st.name])
            for i, kind in enumerate(st.kinds):
                def body(*flat, _i=i, _kind=kind, _st=st):
                    mids = self.rows.map(lambda r: tfm.layer_apply_tp(
                        self._layer_params(view, params, _st, r, _i),
                        list(flat[r * m:(r + 1) * m]), positions[r], cfg,
                        _kind, self.rows.groups[r], enc_outs=enc[r],
                        ffn=False))
                    if _kind == "mamba2":
                        return (*[x for xr in mids for x in xr],
                                torch.zeros_like(aux))
                    outs, a = self._ffn_rows(
                        self.rows.map(lambda r: self._layer_params(
                            view, params, _st, r, _i)),
                        _kind, mids, inputs, n_moe_groups)
                    a = torch.zeros_like(aux) if a is None else a.to(
                        aux.device)
                    return (*[x for xr in outs for x in xr], a)
                *flat, a = _remat(body, cfg.remat_policy)(
                    *[x for xr in xs for x in xr])
                xs = [list(flat[r * m:(r + 1) * m]) for r in rows]
                aux = aux + a
        hs = self.rows.map(lambda r: [
            rmsnorm(w, x, cfg.norm_eps)
            for w, x in zip(view.leaf(params["final_norm"], r), xs[r])])
        return hs, aux, embs

    def _forward_placed(self, params, batch, n_moe_groups: int):
        inputs = self.place_inputs(batch)
        hs, aux, _ = self._rows_hidden(PlacedView(self.rows), params,
                                       inputs, n_moe_groups)
        return self._gather_rows(inputs, [h[0] for h in hs]), aux

    def _loss_parts_placed(self, params, batch, n_moe_groups: int) -> dict:
        """:meth:`loss_parts` on the mesh: each row's NLL sum and count
        over its slice of the batch, summed over the rows onto the first
        shard (a batch every row holds whole is counted once)."""
        cfg = self.cfg
        inputs = self.place_inputs(batch)
        view = PlacedView(self.rows)
        hs, aux, embs = self._rows_hidden(view, params, inputs, n_moe_groups)
        rows = range(self.rows.n) if inputs.split else [0]

        def ce(r):
            labels = self._row(inputs, "labels", r)[0]
            nll, n = self._ce(unembed_tp(embs[r], hs[r], cfg,
                                         self.rows.groups[r]), labels)
            return {"nll": nll, "n": n}
        parts = self.rows.map(ce, rows)
        if cfg.mtp_depth:
            for r, p in zip(rows, self._mtp_rows(view, params, inputs, embs,
                                                 hs, n_moe_groups)):
                parts[r].update(p)
        dev = self.mesh.flat()[0]
        out = {k: collectives.all_reduce_sum([p[k] for p in parts], [dev])[0]
               for k in parts[0]}
        out["aux"] = aux
        return out

    def _mtp_rows(self, view, params, inputs, embs, hs,
                  n_moe_groups: int) -> list:
        """Each row's multi-token-prediction NLL sum and count; its layer
        runs over every row, as the stacks' layers do."""
        cfg = self.cfg
        rows = range(self.rows.n)
        mtp = self.rows.map(lambda r: view.shards(params["mtp"], r))
        kind = "attn_moe" if cfg.moe is not None else "attn_dense"

        def mid(r):
            group = self.rows.groups[r]
            e_next = [e.to(self.dtype) for e in embed_tp(
                embs[r], [t[:, 1:] for t in self._row(inputs, "tokens", r)],
                cfg.vocab, group)]
            xs = [torch.einsum("bsk,kd->bsd", torch.cat(
                [rmsnorm(m["norm_h"], h[:, :-1], cfg.norm_eps),
                 rmsnorm(m["norm_e"], e, cfg.norm_eps)], dim=-1), m["proj"])
                for m, h, e in zip(mtp[r], hs[r], e_next)]
            return tfm.layer_apply_tp(
                [m["layer"] for m in mtp[r]], xs,
                [self._positions(x) for x in xs], cfg, kind, group,
                ffn=False)
        mids = self.rows.map(mid)
        ys, _ = self._ffn_rows([[m["layer"] for m in mtp[r]] for r in rows],
                               kind, mids, inputs, n_moe_groups)
        def ce(r):
            h_mtp = [rmsnorm(m["final_norm"], y, cfg.norm_eps)
                     for m, y in zip(mtp[r], ys[r])]
            labels = self._row(inputs, "labels", r)[0]
            nll, n = self._ce(unembed_tp(embs[r], h_mtp, cfg,
                                         self.rows.groups[r]), labels[:, 1:])
            return {"mtp_nll": nll, "mtp_n": n}
        return self.rows.map(ce, rows if inputs.split else [0])

    def _seq_split(self, placements) -> set:
        """Names of a layer's cache leaves cut by position over the model
        axis (``kv_seq``)."""
        out = set()
        for k, pl in placements.items():
            lg = pl.logical or ()
            if "kv_seq" in lg and "model" in pl.dim_axes(lg.index("kv_seq")) \
                    and pl.mesh.shape["model"] > 1:
                out.add(k)
        return out

    def _prefill_placed(self, params, batch, max_seq: int, cache_dtype):
        cfg = self.cfg
        inputs = self.place_inputs(batch)
        b = int(torch.as_tensor(batch["tokens"]).shape[0])
        pls = self.cache_placements(b, max_seq, cache_dtype)
        view = PlacedView(self.rows)
        rows = range(self.rows.n)          # each row fills its own cache
        embs, xs = zip(*self.rows.map(
            lambda r: self._row_embed(view, params, inputs, r)))
        xs = [list(x) for x in xs]
        positions = self.rows.map(lambda r: [self._positions(x)
                                             for x in xs[r]])
        enc = self.rows.map(lambda r: self._row_encode(view, params, inputs,
                                                       r))
        entries = [list(self.rows.entries(r)) for r in rows]
        stacks = {}
        for st in self.stacks:
            if st.scan:
                view.prepare(params[st.name])
            stacked = [None] * self.mesh.size      # per entry {leaf: (L, ..)}
            per_layer = []
            for i, kind in enumerate(st.kinds):
                split = self._seq_split(pls[st.name] if st.scan
                                        else pls[st.name][i])
                layer_caches = [None] * self.mesh.size
                done = self.rows.map(lambda r, _i=i, _kind=kind, _st=st,
                                     _split=split: tfm.layer_prefill_tp(
                    self._layer_params(view, params, _st, r, _i), xs[r],
                    positions[r], cfg, _kind, self.rows.groups[r],
                    max_seq=max_seq, enc_outs=enc[r],
                    cache_dtype=cache_dtype, seq_split=_split, ffn=False))
                mids = [x for x, _ in done]
                for r, (_, cs) in zip(rows, done):
                    for e, c in zip(entries[r], cs):
                        layer_caches[e] = c
                xs = mids if kind == "mamba2" else self._ffn_rows(
                    self.rows.map(lambda r, _i=i, _st=st: self._layer_params(
                        view, params, _st, r, _i)), kind, mids, inputs, 1)[0]
                if not st.scan:
                    per_layer.append({
                        k: shd.Sharded(pl, [c[k] for c in layer_caches])
                        for k, pl in pls[st.name][i].items()})
                    continue
                for e, c in enumerate(layer_caches):
                    if stacked[e] is None:        # stacked layer by layer
                        stacked[e] = {k: t.new_empty((len(st.kinds),
                                                      *t.shape))
                                      for k, t in c.items()}
                    for k, t in c.items():
                        stacked[e][k][i] = t
            stacks[st.name] = per_layer if not st.scan else {
                k: shd.Sharded(pl, [c[k] for c in stacked])
                for k, pl in pls[st.name].items()}
        def last(r):
            norms = view.leaf(params["final_norm"], r)
            hs = [rmsnorm(w, x[:, -1:], cfg.norm_eps)
                  for w, x in zip(norms, xs[r])]
            return unembed_tp(embs[r], hs, cfg, self.rows.groups[r])
        logits = self.rows.map(last)
        pos = inputs.parts["tokens"][0].shape[1]
        return self._gather_rows(inputs, logits), {"stacks": stacks,
                                                   "pos": pos}

    def _decode_placed(self, params, cache, tokens):
        cfg = self.cfg
        pos = int(cache["pos"])
        inputs = self.place_inputs({"tokens": tokens})
        view = PlacedView(self.rows)
        embs = self.rows.map(lambda r: view.shards(params["embed"], r))
        xs = self.rows.map(lambda r: [
            self._add_positions(x.to(self.dtype), pos)
            for x in embed_tp(embs[r], self._row(inputs, "tokens", r),
                              cfg.vocab, self.rows.groups[r])])
        for st in self.stacks:
            for i, kind in enumerate(st.kinds):
                leaves = cache["stacks"][st.name] if st.scan \
                    else cache["stacks"][st.name][i]
                split = self._seq_split({k: t.placement
                                         for k, t in leaves.items()})
                def step(r, _i=i, _kind=kind, _st=st, _leaves=leaves,
                         _split=split):
                    cs = [{k: (t.shards[e][_i] if _st.scan else t.shards[e])
                           for k, t in _leaves.items()}
                          for e in self.rows.entries(r)]
                    return tfm.layer_decode_tp(
                        self._layer_params(view, params, _st, r, _i), xs[r],
                        cs, pos, cfg, _kind, self.rows.groups[r],
                        seq_split=_split, ffn=False)
                mids = self.rows.map(step)
                xs = mids if kind == "mamba2" else self._ffn_rows(
                    self.rows.map(lambda r, _i=i, _st=st: self._layer_params(
                        view, params, _st, r, _i)), kind, mids, inputs, 1)[0]
        def last(r):
            norms = view.leaf(params["final_norm"], r)
            hs = [rmsnorm(w, x, cfg.norm_eps) for w, x in zip(norms, xs[r])]
            return unembed_tp(embs[r], hs, cfg, self.rows.groups[r])
        logits = self.rows.map(last)
        return self._gather_rows(inputs, logits), {"stacks": cache["stacks"],
                                                   "pos": pos + 1}

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
