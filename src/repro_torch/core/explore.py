"""Design-space exploration: map architectures onto analog crossbar macros
and annotate energy/latency with LASANA surrogates (port of
``repro.core.explore``).

Two evaluation paths share one tile model:

* :func:`explore_arch` — the per-architecture path: walk one
  ``ModelConfig``'s parameter specs (the port's ``Model(cfg)``, in the
  reference's key order), tile every weight-stationary matrix into 32x32
  differential-pair macros, and price each tile with a trained crossbar
  surrogate (``PredictorBank`` or :class:`Surrogate`).
* :class:`DSEEngine` / :func:`evaluate_candidates` — the vectorized
  design-space engine: a batched :class:`CandidateSpec` (layer widths,
  tile size, V_dd, MoE shape, circuit mix) is priced in one pass on the
  device. Tile math is exact int64 numpy over the candidate arrays; each
  candidate's per-tile energy/latency comes from one
  :meth:`Surrogate.predict_heads` pass over all ``C * n_samples`` rows
  (the stacked ``M_ED``/``M_L`` MLP heads in one ``mlp_surrogate_heads``
  launch). The feature matrices are a workspace set up once per
  (C, n_samples, surrogate structure) — the engine's "program" — so a
  retrained surrogate of equal structure re-prices the space with nothing
  set up again (``compile_count`` stays put).

Only *weight-stationary* matmuls map to crossbars (QKVO/FFN/expert
projections); activation-activation products (attention scores, SSD scans,
RG-LRU recurrences) and routers stay digital. Each weight matrix is tiled
into (rows/T x cols/T) differential-pair macros; one token's forward pass
fires one MVM event per tile, whose energy/latency come from the trained
``M_ED``/``M_L`` crossbar surrogates averaged over the input distribution.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.circuits import CrossbarRow, _uniform
from repro_torch.core.surrogate import (Surrogate, SurrogateLibrary,
                                        as_surrogate, structure_key)
from repro_torch.kernels import ops

TILE = 32
# DAC full-scale drive tracks the supply rail; candidates' V_dd enters the
# surrogate through the input-voltage scale relative to this training rail
VDD_REF = 1.2

# analog-unmappable params (gather tables / recurrent gates)
_DIGITAL_KEYS = ("embedding", "router", "a_log", "dt_bias", "d_skip", "lam",
                 "conv_w", "conv_b", "norm", "ln", "q_norm", "kv_norm",
                 "b_a", "b_i", "kpos")

# leading ParamSpec axes that enumerate independent matrices (each slice is
# its own weight-stationary matmul) rather than matrix rows
_STACK_AXES = ("layers", "experts")


@dataclasses.dataclass
class TileReport:
    arch: str
    n_matrices: int
    n_tiles: int
    analog_params: int
    total_params: int
    analog_flop_fraction: float
    energy_per_token_j: float
    latency_critical_ns: float
    tile_energy_j: float
    tiles_by_component: dict

    def summary(self) -> str:
        return (f"{self.arch}: {self.n_tiles:,} 32x32 tiles over "
                f"{self.n_matrices} matrices | analog FLOP fraction "
                f"{self.analog_flop_fraction:.2%} | "
                f"{self.energy_per_token_j * 1e9:.3f} nJ/token | "
                f"critical path {self.latency_critical_ns:.2f} ns/layer-stage")


def _is_analog(path: str, spec) -> bool:
    if any(k in path for k in _DIGITAL_KEYS):
        return False
    return len(spec.shape) >= 2


def _matrix_dims(spec) -> tuple[int, int, int]:
    """(count, rows, cols) of a weight spec's independent matmul matrices.

    Leading ``"layers"`` / ``"experts"`` logical axes enumerate stacked
    *independent* matrices (a layer stack, an expert bank) and multiply
    ``count``; the remaining axes are one matrix of ``rows`` x ``cols``.
    An ``(E, d, f)`` expert bank therefore tiles as ``E * ceil(d/T) *
    ceil(f/T)``, not as one ``(E, d*f)`` matrix."""
    shape = list(spec.shape)
    logical = list(spec.logical or ())
    count = 1
    while len(shape) > 2 and logical and logical[0] in _STACK_AXES:
        count *= shape.pop(0)
        logical.pop(0)
    rows = shape[0]
    cols = int(np.prod(shape[1:]))
    return count, rows, cols


def _keyed_leaves(tree, prefix: str = ""):
    """``(keystr, leaf)`` pairs in ``jax.tree_util.tree_leaves_with_path``'s
    order — dict keys sorted, sequences by index — with its ``keystr``
    spelling (``['layers']['attn']['wq']``): the component names, the
    analog test and the order of the energy sum all read it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed_leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keyed_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _crossbar_surrogate(surrogates) -> Any:
    """Resolve the crossbar-tile predictor from any accepted form.

    Accepts a :class:`Surrogate`, a fitted ``PredictorBank`` (both used
    directly), or a :class:`SurrogateLibrary` / ``{kind: surrogate}`` dict
    — the ``"crossbar"`` entry prices the 32x32 MVM macro."""
    if isinstance(surrogates, (SurrogateLibrary, dict)):
        sur = surrogates.get("crossbar")
        if sur is None:
            raise ValueError(
                "exploration needs a 'crossbar' surrogate; the given "
                "library carries none")
        return sur
    return surrogates


def _sample_rows(seed: int, n_samples: int, device):
    """The testbench rows a tile is priced on: ``(x (n, 32), params
    (n, 33), o_prev (n,))`` from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (the reference's distributions)."""
    circ = CrossbarRow()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = circ.sample_inputs(gen, (n_samples,), device)
    p = circ.sample_params(gen, n_samples, device)
    o_prev = _uniform(gen, (n_samples,), device, -2.0, 2.0)
    return x, p, o_prev


def _price_rows(bank, x, p, o_prev) -> tuple[float, float]:
    """Mean per-MVM-event energy (J) / latency (ns) of one 32x32 macro over
    the rows ``(x, p, o_prev)``: one fetch of both means."""
    n = x.shape[0]
    v = x.new_zeros((n,))
    tau = x.new_full((n,), CrossbarRow().clock_ns)
    base = torch.cat([x, v[:, None], tau[:, None], p], dim=1)
    o_new = bank.predict("M_O", base)
    feats = torch.cat([base, o_prev[:, None], o_new[:, None]], dim=1)
    means = torch.stack([bank.predict("M_ED", feats).mean(),
                         bank.predict("M_L", feats).mean()])
    e, lat = means.cpu().tolist()
    return e, lat


def tile_energy_latency(bank, *, seed=0, n_samples=2048):
    """Mean per-MVM-event energy (J) / latency (ns) of one 32x32 macro, on
    ``n_samples`` testbench rows drawn on the bank's device."""
    bank = _crossbar_surrogate(bank)
    return _price_rows(bank, *_sample_rows(seed, n_samples, bank.device))


def _arch_report(cfg: ModelConfig, e_tile: float,
                 l_tile: float) -> TileReport:
    """The tile walk of :func:`explore_arch` at a given per-tile energy and
    latency."""
    from repro_torch.models.model import Model
    specs = Model(cfg).param_specs()
    n_tiles = 0
    n_matrices = 0
    analog_params = 0
    total_params = 0
    energy_token = 0.0
    by_comp: dict[str, int] = {}
    for pstr, spec in _keyed_leaves(specs):
        count_elems = int(np.prod(spec.shape))
        total_params += count_elems
        if not _is_analog(pstr, spec):
            continue
        count, rows, cols = _matrix_dims(spec)
        tiles = count * (-(-rows // TILE)) * (-(-cols // TILE))
        n_tiles += tiles
        n_matrices += count
        analog_params += count_elems
        # leaf weight name (w_gate, wq, ...) so MoE expert banks report
        # their exact per-matrix tile counts instead of a stack aggregate
        comp = pstr.split("'")[-2] if "'" in pstr else pstr
        by_comp[comp] = by_comp.get(comp, 0) + tiles
        # every token fires each tile once per forward pass; MoE scales by
        # the active-expert fraction
        util = 1.0
        if cfg.moe is not None and "moe" in pstr and "shared" not in pstr \
                and "router" not in pstr:
            util = (cfg.moe.top_k) / cfg.moe.n_experts
        energy_token += tiles * e_tile * util

    # digital-FLOP share: attention scores (seq-dependent) + unmapped params.
    # At S=4096: score flops/token = 4*S*H*Dh per layer.
    s_ref = 4096
    if cfg.attention.value != "none":
        score = 4 * s_ref * cfg.n_heads * cfg.head_dim * cfg.n_layers
    else:
        score = 0
    analog_flops = 2 * analog_params
    if cfg.moe is not None:
        act = cfg.active_param_count()
        analog_flops = int(analog_flops * act / max(cfg.param_count(), 1))
    digital_flops = 2 * (total_params - analog_params) + score
    frac = analog_flops / max(analog_flops + digital_flops, 1)

    return TileReport(
        arch=cfg.name,
        n_matrices=n_matrices,
        n_tiles=n_tiles,
        analog_params=analog_params,
        total_params=total_params,
        analog_flop_fraction=frac,
        energy_per_token_j=energy_token,
        latency_critical_ns=l_tile,
        tile_energy_j=e_tile,
        tiles_by_component=by_comp,
    )


def explore_arch(cfg: ModelConfig, bank) -> TileReport:
    """Map one zoo architecture onto 32x32 crossbar macros.

    ``bank`` is a trained crossbar predictor in any accepted form (see
    :func:`_crossbar_surrogate`), priced on its own device; every config
    of the zoo walks its ``Model(cfg).param_specs()`` (the Griffin
    interleave's list of layers and the ``encoder`` / ``mtp`` subtrees
    included). For thousand-point candidate sweeps use
    :func:`evaluate_candidates`."""
    bank = _crossbar_surrogate(bank)
    return _arch_report(cfg, *tile_energy_latency(bank))


# --- batched candidate space ----------------------------------------------------

# (field, default, dtype) — the knobs a DSE candidate carries
_CANDIDATE_FIELDS = (
    ("d_model", 512, np.int64),       # residual width
    ("d_ff", 2048, np.int64),         # FFN (or per-expert) hidden width
    ("n_layers", 8, np.int64),
    ("n_heads", 8, np.int64),
    ("n_kv_heads", 8, np.int64),      # GQA: kv head count
    ("n_experts", 0, np.int64),       # 0 -> dense FFN
    ("top_k", 0, np.int64),           # active experts per token (MoE only)
    ("tile", TILE, np.int64),         # crossbar macro edge (TxT)
    ("v_dd", VDD_REF, np.float32),    # analog supply rail (V)
    ("analog_attn", 1, np.int64),     # 1: QKVO projections map to crossbars
    ("analog_ffn", 1, np.int64),      # 1: FFN/expert matmuls map to crossbars
    ("vocab", 32000, np.int64),       # embedding + LM head (always digital)
)


@dataclasses.dataclass(frozen=True)
class CandidateSpec:
    """A batch of candidate accelerator/architecture configurations.

    Every field is a ``(C,)`` array — candidate ``i`` is row ``i`` across
    all fields. Build one with :meth:`of` (broadcasting scalars),
    :meth:`sample` (randomized sweep) or :meth:`grid` (cartesian product),
    then price the whole batch with :func:`evaluate_candidates` /
    ``lasana.explore``. Knobs:

    ``d_model``/``d_ff``/``n_layers``/``n_heads``/``n_kv_heads``
        transformer layer widths (GQA kv heads; ``head_dim = d_model //
        n_heads``)
    ``n_experts``/``top_k``
        MoE shape; ``n_experts == 0`` is a dense FFN. Expert matrices tile
        per expert and consume energy at the ``top_k / n_experts``
        utilization.
    ``tile``
        crossbar macro edge T (a TxT tile = (T/32)^2 of the trained 32x32
        macro; energy scales with that area, rows settle in parallel)
    ``v_dd``
        analog supply rail; enters the surrogate through the DAC
        full-scale input drive (``v_dd / 1.2`` relative to the training
        rail)
    ``analog_attn``/``analog_ffn``
        circuit mix: which weight-stationary matmul groups map to analog
        crossbars (0 keeps them digital)
    ``vocab``
        embedding/LM-head size — always digital (gather), counts toward
        the digital FLOP share only
    """

    d_model: np.ndarray
    d_ff: np.ndarray
    n_layers: np.ndarray
    n_heads: np.ndarray
    n_kv_heads: np.ndarray
    n_experts: np.ndarray
    top_k: np.ndarray
    tile: np.ndarray
    v_dd: np.ndarray
    analog_attn: np.ndarray
    analog_ffn: np.ndarray
    vocab: np.ndarray

    def __post_init__(self):
        """Broadcast every field to one common ``(C,)`` length and check
        the knobs are self-consistent (positive widths, ``top_k`` within
        ``n_experts``)."""
        arrays = {}
        c = 1
        for name, _, dtype in _CANDIDATE_FIELDS:
            a = np.atleast_1d(np.asarray(getattr(self, name), dtype))
            if a.ndim != 1:
                raise ValueError(f"CandidateSpec.{name} must be scalar or "
                                 f"1-D, got shape {a.shape}")
            arrays[name] = a
            c = max(c, a.shape[0])
        for name, a in arrays.items():
            if a.shape[0] not in (1, c):
                raise ValueError(
                    f"CandidateSpec.{name} has {a.shape[0]} entries but the "
                    f"batch has {c}")
            object.__setattr__(self, name,
                               np.broadcast_to(a, (c,)).copy())
        if np.any(self.d_model < 1) or np.any(self.d_ff < 1) \
                or np.any(self.n_layers < 1) or np.any(self.n_heads < 1) \
                or np.any(self.n_kv_heads < 1) or np.any(self.tile < 1):
            raise ValueError("CandidateSpec widths/tile must be >= 1")
        if np.any(self.v_dd <= 0):
            raise ValueError("CandidateSpec.v_dd must be positive")
        moe = self.n_experts > 0
        if np.any(moe & ((self.top_k < 1) | (self.top_k > self.n_experts))):
            raise ValueError("MoE candidates need 1 <= top_k <= n_experts")

    def __len__(self) -> int:
        return int(self.d_model.shape[0])

    @classmethod
    def of(cls, **knobs) -> "CandidateSpec":
        """Build a batch from scalars/arrays; unspecified knobs take the
        documented defaults, scalars broadcast to the batch length."""
        vals = {name: knobs.pop(name, default)
                for name, default, _ in _CANDIDATE_FIELDS}
        if knobs:
            raise TypeError(f"unknown candidate knob(s): {sorted(knobs)}")
        return cls(**vals)

    @classmethod
    def sample(cls, n: int, *, seed: int = 0, moe_fraction: float = 0.4,
               v_dd_range: tuple = (0.9, 1.5)) -> "CandidateSpec":
        """Randomized ``n``-candidate design space (the sweep generator).

        Widths are drawn from hardware-plausible menus (power-of-two
        ``d_model``, 2-4x FFN expansion, GQA ratios), ``moe_fraction`` of
        candidates get an expert bank, tile sizes span 16-128, and
        ``v_dd`` is uniform over ``v_dd_range``. Deterministic in
        ``seed`` (numpy's ``default_rng``, so the reference draws the same
        candidates)."""
        rng = np.random.default_rng(seed)
        d_model = rng.choice([256, 512, 768, 1024, 2048, 4096], n)
        d_ff = d_model * rng.choice([2, 3, 4], n)
        n_layers = rng.choice([4, 8, 12, 16, 24, 32], n)
        n_heads = np.maximum(d_model // 64, 1)
        n_kv_heads = np.maximum(n_heads // rng.choice([1, 1, 2, 4], n), 1)
        moe = rng.random(n) < moe_fraction
        n_experts = np.where(moe, rng.choice([8, 16, 32, 64], n), 0)
        top_k = np.where(moe, np.minimum(rng.choice([1, 2, 4, 8], n),
                                         np.maximum(n_experts, 1)), 0)
        # routed experts are thinner than dense FFNs
        d_ff = np.where(moe, np.maximum(d_model // 2, TILE), d_ff)
        tile = rng.choice([16, 32, 64, 128], n)
        v_dd = rng.uniform(v_dd_range[0], v_dd_range[1], n).astype(np.float32)
        analog_attn = rng.choice([0, 1], n, p=[0.25, 0.75])
        analog_ffn = rng.choice([0, 1], n, p=[0.1, 0.9])
        return cls.of(d_model=d_model, d_ff=d_ff, n_layers=n_layers,
                      n_heads=n_heads, n_kv_heads=n_kv_heads,
                      n_experts=n_experts, top_k=top_k, tile=tile, v_dd=v_dd,
                      analog_attn=analog_attn, analog_ffn=analog_ffn)

    @classmethod
    def grid(cls, **axes) -> "CandidateSpec":
        """Cartesian product over the given per-knob value lists.

        ``CandidateSpec.grid(d_model=[512, 1024], v_dd=[1.0, 1.2])`` is a
        4-candidate batch; unspecified knobs take their defaults."""
        names = [n for n, _, _ in _CANDIDATE_FIELDS if n in axes]
        unknown = set(axes) - set(names)
        if unknown:
            raise TypeError(f"unknown candidate knob(s): {sorted(unknown)}")
        lists = [np.atleast_1d(np.asarray(axes[n])) for n in names]
        mesh = np.meshgrid(*lists, indexing="ij") if lists else []
        return cls.of(**{n: m.reshape(-1) for n, m in zip(names, mesh)})

    def take(self, idx) -> "CandidateSpec":
        """Sub-batch at integer indices ``idx`` (fancy-indexes every knob
        array) — e.g. ``cands.take(report.pareto())``."""
        idx = np.asarray(idx)
        return CandidateSpec(**{name: getattr(self, name)[idx]
                                for name, _, _ in _CANDIDATE_FIELDS})

    def row(self, i: int) -> dict:
        """Candidate ``i`` as a plain ``{knob: python scalar}`` dict."""
        return {name: getattr(self, name)[i].item()
                for name, _, _ in _CANDIDATE_FIELDS}


def _ceil_div(a, b):
    return -(-a // b)


def _tile_table(c: CandidateSpec) -> dict:
    """Pure vectorized tile math over a candidate batch -> (C,) arrays.

    All counts are exact ``int64`` array ops (no surrogate involved):
    per-layer tile/param counts for the attention (QKVO) and FFN/expert
    groups, active-vs-total parameter counts, and the digital score-FLOP
    term at the reference sequence length."""
    d, f, t = c.d_model, c.d_ff, c.tile
    dh = np.maximum(c.d_model // np.maximum(c.n_heads, 1), 1)
    kv = c.n_kv_heads * dh
    td, tf, tkv = _ceil_div(d, t), _ceil_div(f, t), _ceil_div(kv, t)

    # per-layer tile counts per mapped group
    tiles_attn = 2 * td * td + 2 * td * tkv             # wq, wo + wk, wv
    moe = c.n_experts > 0
    tiles_ffn_dense = 3 * td * tf                        # gate/up/down
    tiles_ffn = np.where(moe, c.n_experts * tiles_ffn_dense, tiles_ffn_dense)
    # MoE fires only the routed top-k fraction of expert tiles per token
    util = np.where(moe, c.top_k / np.maximum(c.n_experts, 1), 1.0)

    # per-layer parameter counts (matrix elements, not padded tiles)
    p_attn = 2 * d * d + 2 * d * kv
    p_ffn_act = np.where(moe, c.top_k, 1) * 3 * d * f
    p_router = np.where(moe, d * c.n_experts, 0)         # always digital

    a_attn, a_ffn = c.analog_attn.astype(np.int64), \
        c.analog_ffn.astype(np.int64)
    n_tiles = c.n_layers * (a_attn * tiles_attn + a_ffn * tiles_ffn)
    # energy-weighted tiles fired per token
    tiles_token = c.n_layers * (a_attn * tiles_attn
                                + a_ffn * tiles_ffn * util)
    analog_active = c.n_layers * (a_attn * p_attn + a_ffn * p_ffn_act)
    total_active = c.n_layers * (p_attn + p_ffn_act + p_router) \
        + 2 * c.vocab * d
    # digital score flops/token at the reference sequence length
    s_ref = 4096
    score = 4 * s_ref * c.n_heads * dh * c.n_layers
    analog_flops = 2 * analog_active
    digital_flops = 2 * (total_active - analog_active) + score
    frac = analog_flops / np.maximum(analog_flops + digital_flops, 1)
    # sequential analog stages per token: QKV->O, up/gate->down
    stages = c.n_layers * (2 * a_attn + 2 * a_ffn)
    return {
        "n_tiles": n_tiles.astype(np.int64),
        "tiles_token": tiles_token.astype(np.float64),
        "analog_params": analog_active.astype(np.int64),
        "total_params": total_active.astype(np.int64),
        "analog_flop_fraction": frac.astype(np.float64),
        "stages": stages.astype(np.int64),
    }


# --- the vectorized DSE engine --------------------------------------------------

@dataclasses.dataclass
class DSEReport:
    """Batched exploration result: one row per candidate, plus frontier.

    Array fields are ``(C,)`` host arrays aligned with ``candidates``;
    ``pareto()`` extracts the non-dominated set over (energy/token,
    critical-path latency, analog-FLOP fraction). ``compile_count`` is the
    number of distinct sweep programs (feature workspaces) the
    :class:`DSEEngine` has set up — a whole sweep (any retrained surrogate
    of equal structure) holds at one per candidate count.
    """

    candidates: CandidateSpec
    n_tiles: np.ndarray              # (C,) int64 mapped crossbar tiles
    analog_params: np.ndarray        # (C,) int64 active analog matrix params
    total_params: np.ndarray         # (C,) int64 active params incl. digital
    analog_flop_fraction: np.ndarray # (C,) float64 in [0, 1]
    energy_per_token_j: np.ndarray   # (C,) float64 J per forward token
    latency_critical_ns: np.ndarray  # (C,) float64 analog critical path
    tile_energy_j: np.ndarray        # (C,) float64 per-tile MVM energy
    tile_latency_ns: np.ndarray      # (C,) float64 per-tile settle latency
    compile_count: int = 0
    wall_seconds: float = 0.0

    def __len__(self) -> int:
        return len(self.candidates)

    def pareto(self) -> np.ndarray:
        """Indices of the Pareto frontier: minimize energy/token and
        critical-path latency, maximize analog-FLOP fraction."""
        objs = np.stack([self.energy_per_token_j, self.latency_critical_ns,
                         -self.analog_flop_fraction], axis=1)
        return np.flatnonzero(pareto_mask(objs))

    def summary(self, i: int) -> str:
        """One-line human-readable report row for candidate ``i``."""
        c = self.candidates.row(i)
        moe = (f" E{c['n_experts']}k{c['top_k']}" if c["n_experts"] else "")
        return (f"d{c['d_model']}xf{c['d_ff']}xL{c['n_layers']}{moe} "
                f"T={c['tile']} Vdd={c['v_dd']:.2f}: "
                f"{int(self.n_tiles[i]):,} tiles | "
                f"analog {self.analog_flop_fraction[i]:.1%} | "
                f"{self.energy_per_token_j[i] * 1e9:.3f} nJ/tok | "
                f"{self.latency_critical_ns[i]:.1f} ns")

    def as_dict(self, idx=None) -> dict:
        """JSON-ready ``{column: list}`` table (optionally only rows
        ``idx``)."""
        idx = np.arange(len(self)) if idx is None else np.asarray(idx)
        out = {name: getattr(self.candidates, name)[idx].tolist()
               for name, _, _ in _CANDIDATE_FIELDS}
        for col in ("n_tiles", "analog_flop_fraction", "energy_per_token_j",
                    "latency_critical_ns"):
            out[col] = getattr(self, col)[idx].tolist()
        return out


def pareto_mask(objectives: np.ndarray) -> np.ndarray:
    """Non-dominated mask of ``(C, K)`` objective rows (all minimized).

    Row i is dominated when some row j is <= on every objective and
    strictly < on at least one. O(C^2) broadcasting — fine for the
    10^3-10^4-point spaces this engine targets."""
    o = np.asarray(objectives, np.float64)
    le = np.all(o[:, None, :] <= o[None, :, :], axis=-1)    # j dominates-ish i
    lt = np.any(o[:, None, :] < o[None, :, :], axis=-1)
    dominated = np.any(le & lt, axis=0)
    return ~dominated


@dataclasses.dataclass
class _Workspace:
    """One sweep program's feature matrices, ``C * n_samples`` rows each,
    the columns that do not change between sweeps written once:
    ``act`` (x, v = 0, tau, params, derived) and ``tr`` (x, v, tau,
    params, o_prev, o_new, derived), both already augmented."""

    act: torch.Tensor
    tr: torch.Tensor


class DSEEngine:
    """Set-up-once vectorized evaluator for candidate sweeps, on ``device``
    (default ``cuda``).

    Per (candidate count, sample count, surrogate structure) the engine
    sets up one program: the augmented feature matrices of all ``C *
    n_samples`` testbench rows, whose parameter, state, pole and
    previous-output columns never change. Each evaluation writes the
    candidates' V_dd-scaled input voltages and their derived row drive
    into it, runs the single-head ``M_O`` group, splices its prediction
    into the transition matrix and runs the stacked ``M_ED``/``M_L`` heads
    over the whole ``(C * n_samples)`` matrix at once (one
    ``mlp_surrogate_heads`` launch for MLP heads), then fetches the
    per-candidate means once. Retrained weights of equal structure set up
    nothing (``compile_count`` stays put).

    The base rows ``_base_x`` / ``_base_p`` / ``_base_o`` come from a
    ``torch.Generator`` seeded ``seed``; a program reads them when it is
    set up.
    """

    def __init__(self, *, n_samples: int = 256, seed: int = 0, device=None):
        self.n_samples = int(n_samples)
        self.seed = int(seed)
        self.device = ops.resolve_device(device)
        self.compile_count = 0           # distinct sweep programs set up
        self._programs: dict = {}
        self._circ = CrossbarRow()
        self._base_x, self._base_p, self._base_o = _sample_rows(
            self.seed, self.n_samples, self.device)

    # -- the sweep program ---------------------------------------------------
    def _setup(self, c: int) -> _Workspace:
        """Allocate the two feature matrices for ``c`` candidates and write
        their fixed columns."""
        n, n_in = self.n_samples, self._circ.n_inputs
        n_p = self._circ.n_params
        rows = c * n
        f = n_in + 2 + n_p                       # raw (x, v, tau, params)
        act = torch.empty((rows, f + 1), dtype=torch.float32,
                          device=self.device)
        tr = torch.empty((rows, f + 3), dtype=torch.float32,
                         device=self.device)
        for m in (act, tr):
            m[:, n_in] = 0.0                                   # v
            m[:, n_in + 1] = self._circ.clock_ns               # tau
            m[:, n_in + 2:f].view(c, n, n_p).copy_(
                self._base_p.expand(c, n, n_p))                # params
        tr[:, f].view(c, n).copy_(self._base_o.expand(c, n))   # o_prev
        return _Workspace(act=act, tr=tr)

    def _program(self, surrogate: Surrogate, c: int) -> _Workspace:
        """The sweep program for this cache key, set up once."""
        key = (c, self.n_samples, structure_key(surrogate))
        ws = self._programs.get(key)
        if ws is None:
            ws = self._setup(c)
            self._programs[key] = ws
            self.compile_count += 1
        return ws

    def _tile_eval(self, surrogate, v_dd, tile, ws: _Workspace):
        """(2, C) float32 per-candidate tile energy and latency, on the
        device (the caller fetches them once)."""
        n, n_in = self.n_samples, self._circ.n_inputs
        c = v_dd.shape[0]
        f = ws.act.shape[1] - 1
        drive = ops.div(v_dd, VDD_REF)[:, None, None]          # (C,1,1)
        x = self._base_x[None] * drive                         # (C,n,n_in)
        ws.act[:, :n_in].view(c, n, n_in).copy_(x)
        ws.tr[:, :n_in].view(c, n, n_in).copy_(x)
        # the circuit's derived feature (row drive), as predict_heads'
        # augmentation computes it
        derived = self._circ.surrogate_features(
            ws.act[:, :n_in], ws.act[:, n_in + 2:f])[:, 0]
        ws.act[:, f] = derived
        ws.tr[:, f + 2] = derived
        o_new = surrogate.predict_heads(
            feats_act=ws.act, heads={"act": ("M_O",)},
            augmented=True)["act"]["M_O"]
        ws.tr[:, f + 1] = o_new
        out = surrogate.predict_heads(
            feats_tr=ws.tr, heads={"tr": ("M_ED", "M_L")},
            augmented=True)["tr"]
        e32 = out["M_ED"].reshape(c, n).mean(dim=1)
        l32 = out["M_L"].reshape(c, n).mean(dim=1)
        # a TxT tile is (T/32)^2 of the trained 32x32 macro area; its rows
        # (and 32-wide row segments) settle in parallel, so energy scales
        # with area while the settle latency stays the macro's
        area = torch.square(tile.float() / TILE)
        return torch.stack([e32 * area, l32])

    # -- public evaluation ---------------------------------------------------
    def evaluate(self, candidates: CandidateSpec, surrogates,
                 *, compiled: bool = True) -> DSEReport:
        """Price every candidate in one vectorized pass -> DSEReport.

        ``surrogates`` is a crossbar :class:`Surrogate` (or library /
        ``PredictorBank``; resolved like :func:`explore_arch`), moved to
        the engine's device. ``compiled=False`` sets up a fresh program
        for this call alone (not cached, not counted)."""
        sur = as_surrogate(_crossbar_surrogate(surrogates))
        if sur.circuit != "crossbar":
            raise ValueError(
                f"DSE tiles are crossbar macros; got a surrogate trained "
                f"for circuit {sur.circuit!r}")
        sur = sur.to(self.device)
        c = len(candidates)
        v_dd = torch.as_tensor(candidates.v_dd, dtype=torch.float32,
                               device=self.device)
        tile = torch.as_tensor(candidates.tile, dtype=torch.int32,
                               device=self.device)
        t0 = time.perf_counter()
        ws = self._program(sur, c) if compiled else self._setup(c)
        res = self._tile_eval(sur, v_dd, tile, ws).cpu().numpy()
        e_tile, l_tile = res[0].astype(np.float64), res[1].astype(np.float64)
        wall = time.perf_counter() - t0

        tt = _tile_table(candidates)
        return DSEReport(
            candidates=candidates,
            n_tiles=tt["n_tiles"],
            analog_params=tt["analog_params"],
            total_params=tt["total_params"],
            analog_flop_fraction=tt["analog_flop_fraction"],
            energy_per_token_j=tt["tiles_token"] * e_tile,
            latency_critical_ns=tt["stages"] * l_tile,
            tile_energy_j=e_tile,
            tile_latency_ns=l_tile,
            compile_count=self.compile_count,
            wall_seconds=wall,
        )


# one process-wide engine behind lasana.explore: sweeps share its program
# cache (and compile_count), mirroring the facade's network-engine cache
_DEFAULT_ENGINE: Optional[DSEEngine] = None


def dse_engine() -> DSEEngine:
    """The process-wide :class:`DSEEngine` serving ``lasana.explore`` (on
    ``cuda``)."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = DSEEngine()
    return _DEFAULT_ENGINE


def evaluate_candidates(candidates: CandidateSpec, surrogates,
                        *, engine: Optional[DSEEngine] = None) -> DSEReport:
    """Vectorized sweep: price ``candidates`` with the shared engine (or
    ``engine``). See :class:`DSEEngine` for the set-up-once contract and
    :class:`DSEReport` for the output table/Pareto API."""
    return (engine or dse_engine()).evaluate(candidates, surrogates)
