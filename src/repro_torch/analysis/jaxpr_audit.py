"""Program auditor for the port's hot paths, the JAX package's
``analysis/jaxpr_audit.py`` (``:1-811``) in PyTorch. The name is kept so
that a reader finds the counterpart; there is no jaxpr here. The port runs
eagerly, so this module audits the aten ops an entrypoint dispatches: it
runs each registered entrypoint under a ``TorchDispatchMode`` (the
counterpart of the reference's trace, as ``launch/hlo_cost.py``'s
``Counter`` is of its cost analysis) and checks, before anything runs on
the card:

  * **dispatch budgets** — ``Surrogate.predict`` / ``predict_heads`` and
    the whole-tick ``megakernel_step`` report each dispatch through
    ``ops.record_dispatch``. Each entrypoint runs over one, two and three
    ticks, so the per-tick part and the fixed part (a pack built once a
    block, the idle-energy flush) come out exact; ``dispatches`` is the
    count at one tick, per tick plus fixed, as the reference's trace
    count is. Architectural ceilings (fused <= 3, annotation and
    megakernel == 1, per-call == 7) are hard-coded per entrypoint and
    cannot be regenerated away.
  * **kernel calls** — every kernel entry point of ``kernels/ops.py``
    records ``kernel:<name>`` on every route, so a CPU run counts the
    calls the card would launch (routes come from shapes alone); the
    ``*_kernel`` entrypoints run the port's own default (fused kernel on)
    and hold hard kernel ceilings: a packed tick launches
    ``network_tick`` exactly once per packed layer, the stacked tick at
    most 3 head kernels, the behavioral slot step none.
  * **dot and op counts** — products (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``matmul``, ``linear``) and every aten op per tick,
    counted outside kernel entry points (a kernel's plain version is the
    kernel's work, one launch on the card): what the host enqueues a tick.
    Frozen per entrypoint in ``program_budgets.json`` beside this module
    (drift fails, ``--regen`` accepts). The frozen ``ops`` and ``dots``
    are CPU counts: on the card the same kernels come with other aten ops
    around them (a copy, a fill), so a run there holds only the
    device-independent ``dispatches``, ``kernels`` and ``writes``.
  * **writes** — argument tensors whose ``_version`` moved across the
    call. The runners promise that the caller's carries are read, never
    written (a stream checkpoint snapshots them): the counterpart of the
    reference's donation check. The reference's ``scans`` and ``donated``
    columns have no eager counterpart and the port's row drops them.
  * **dtype and sync hygiene** — no float64 / complex128 output, and no
    host sync (``_local_scalar_dense``, ``is_nonzero``, ``nonzero``,
    ``equal``, a copy to the CPU: the counterpart of the reference's
    callback primitives); a sync that grows with the ticks is reported as
    inside the tick loop. Counts not linear in the ticks are a finding.
  * **cache-key completeness** — a registry of every engine and runner
    cache whose key function must mention its declared discriminators and
    must never call ``id(...)``, plus a dynamic check that flips each
    knob and asserts that the network runner key changes.
  * **environment discipline** — ``kernels/ops.py`` is the single module
    that touches ``os.environ`` under ``src/repro_torch`` and in
    ``chip_smoke.py``, reads and writes alike (the reference allows writes
    anywhere; this module pins knobs through ``ops.env_override``).

Entrypoints are built from **synthetic surrogates** (zero-weight MLP
heads of the production 3-layer shape): their structure, and so every
metric here, is exactly that of a trained artifact. Like every entry
point of the port, the audit runs on the card unless the caller asks for
the CPU (``device="cpu"``, as the tests and the CI gate do: the frozen
rows are counted there); ``chip_smoke.py`` runs the same entrypoints on
the card and also holds ``ops.LAUNCHES`` per tick to the frozen
``kernels`` row.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import functools
import importlib
import inspect
import json
import pathlib
import textwrap

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import ops

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

# ops that wait for the card (the counterpart of the reference's
# CALLBACK_PRIMITIVES): a hidden sync per call, fatal inside a tick loop
SYNC_OPS = frozenset({"_local_scalar_dense", "item", "is_nonzero",
                      "nonzero", "equal"})
WIDE_DTYPES = (torch.float64, torch.complex128)
DOT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "matmul", "linear"})
TICKS = (1, 2, 3)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One auditor violation: the check that fired, on what, and why."""

    check: str     # e.g. "dispatch-budget", "carry-write", "cache-key"
    entry: str     # entrypoint / cache / file the finding names
    message: str

    def __str__(self):
        return f"[{self.check}] {self.entry}: {self.message}"


# --- counting one run ---------------------------------------------------------

def _to_host(name, args, kwargs) -> bool:
    """Whether an op copies a tensor off a device onto the CPU."""
    if name == "_to_copy":
        dst = kwargs.get("device")
        return (dst is not None and torch.device(dst).type == "cpu"
                and args[0].device.type != "cpu")
    if name == "copy_":
        return args[0].device.type == "cpu" and args[1].device.type != "cpu"
    return False


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched inside it outside kernel entry
    points: all of them, the products, the syncs by name, and the wide
    outputs."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.dots = 0
        self.syncs = collections.Counter()
        self.wide = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if ops.in_kernel():
            return out
        name = func.overloadpacket.__name__
        self.ops += 1
        if name in DOT_OPS:
            self.dots += 1
        if name in SYNC_OPS or _to_host(name, args, kwargs):
            self.syncs[name] += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype in WIDE_DTYPES:
                self.wide.add((str(t.dtype).replace("torch.", ""), name))
        return out


def _tensor_leaves(obj, out=None) -> dict:
    """id -> tensor for every tensor reachable from an argument: through
    tuples, lists, dicts and a surrogate's (or library's) parameters."""
    from repro_torch.core.surrogate import Surrogate, SurrogateLibrary
    out = {} if out is None else out
    if isinstance(obj, torch.Tensor):
        out[id(obj)] = obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _tensor_leaves(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensor_leaves(x, out)
    elif isinstance(obj, SurrogateLibrary):
        for _, s in obj.items():
            _tensor_leaves(s, out)
    elif isinstance(obj, Surrogate):
        _tensor_leaves(obj.params, out)
    return out


@dataclasses.dataclass
class _Run:
    """The counts of one run of an entrypoint."""

    dispatches: collections.Counter
    kernels: collections.Counter
    launches: collections.Counter
    dots: int
    ops: int
    syncs: collections.Counter
    wide: set
    writes: int


def _run_once(entry, around) -> _Run:
    leaves = _tensor_leaves(entry.args)
    versions = {k: t._version for k, t in leaves.items()}
    launched = dict(ops.LAUNCHES)
    counter = _OpCounter()
    with around(), ops.dispatch_scope() as log, counter:
        entry.fn(*entry.args)
    kernels = collections.Counter(n[len("kernel:"):] for n in log
                                  if n.startswith("kernel:"))
    return _Run(
        dispatches=collections.Counter(n for n in log
                                       if not n.startswith("kernel:")),
        kernels=kernels,
        launches=collections.Counter({k: v - launched[k]
                                      for k, v in ops.LAUNCHES.items()
                                      if v != launched[k]}),
        dots=counter.dots, ops=counter.ops, syncs=counter.syncs,
        wide=counter.wide,
        writes=sum(t._version != versions[k] for k, t in leaves.items()))


# --- the frozen row -----------------------------------------------------------

@dataclasses.dataclass
class ProgramMetrics:
    """What one entrypoint dispatches (its frozen-budget row, and what the
    checks read). ``kernels`` and ``launches`` (``ops.LAUNCHES``' moves:
    zero on the CPU) are ``{"per_tick": {...}, "fixed": {...}}``."""

    dispatches: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    dots: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    writes: int = 0
    syncs: list = dataclasses.field(default_factory=list)
    wide_dtypes: list = dataclasses.field(default_factory=list)
    nonlinear: list = dataclasses.field(default_factory=list)

    def budget_row(self) -> dict:
        """The JSON-stable slice frozen in program_budgets.json."""
        return {"dispatches": dict(sorted(self.dispatches.items())),
                "kernels": self.kernels, "dots": self.dots,
                "ops": self.ops, "writes": self.writes}


def _split(values, label, nonlinear):
    """``(per_tick, fixed)`` of one count at 1, 2 and 3 ticks; a count
    that is not affine in the ticks is logged in ``nonlinear``."""
    c1, c2, c3 = values
    per = c2 - c1
    if c3 - c2 != per or c1 - per < 0:
        nonlinear.append(f"{label} {c1}, {c2}, {c3}")
    return per, c1 - per


def _split_counters(runs, attr, nonlinear):
    names = sorted(set().union(*(getattr(r, attr) for r in runs)))
    per, fixed = {}, {}
    for n in names:
        p, f = _split([getattr(r, attr)[n] for r in runs], f"{attr} {n}",
                      nonlinear)
        if p:
            per[n] = p
        if f:
            fixed[n] = f
    return {"per_tick": per, "fixed": fixed}


def metrics_of(runs) -> ProgramMetrics:
    """One entrypoint's metrics from its runs at 1, 2 and 3 ticks."""
    m = ProgramMetrics()
    m.dispatches = {n: c for n, c in sorted(runs[0].dispatches.items())}
    for n in set().union(*(r.dispatches for r in runs)):
        _split([r.dispatches[n] for r in runs], f"dispatches {n}",
               m.nonlinear)
    m.kernels = _split_counters(runs, "kernels", m.nonlinear)
    m.launches = _split_counters(runs, "launches", m.nonlinear)
    per, fixed = _split([r.dots for r in runs], "dots", m.nonlinear)
    m.dots = {"per_tick": per, "fixed": fixed}
    m.ops = _split([r.ops for r in runs], "ops", m.nonlinear)[0]
    m.writes = max(r.writes for r in runs)
    syncs = _split_counters(runs, "syncs", m.nonlinear)
    m.syncs = sorted([(n, "inside the tick loop")
                      for n in syncs["per_tick"]]
                     + [(n, "in the fixed part") for n in syncs["fixed"]
                        if n not in syncs["per_tick"]])
    m.wide_dtypes = sorted(set().union(*(r.wide for r in runs)))
    return m


# --- synthetic surrogates -----------------------------------------------------

def synthetic_surrogate(circuit_name: str, *, family: str = "mlp",
                        hidden: tuple = (8, 4), gbdt: tuple = (),
                        device=None):
    """A structurally-production :class:`Surrogate` with zero weights.

    Carries all five Algorithm-1 predictors as ``family`` heads sized to
    the circuit's augmented feature widths (so the megakernel pack
    eligibility, head stacking and runner cache keys behave exactly as
    for a trained artifact), the predictors named in ``gbdt`` as GBDT
    heads of ``lif_unpackable``'s shape (44 trees of depth 8), without
    golden simulation or fitting, on ``device`` (the card unless the
    caller asks for another). The reference's
    ``jaxpr_audit.py:153-201``."""
    from repro_torch.core.circuits import augment_features, get_circuit
    from repro_torch.core.surrogate import (FORMAT_VERSION, Manifest,
                                            Surrogate, _feature_names)
    circ = get_circuit(circuit_name)
    device = ops.resolve_device(device)
    f_raw = circ.n_inputs + 2 + circ.n_params
    f_aug = int(augment_features(circ, torch.zeros((1, f_raw))).shape[1])
    f_tr = int(augment_features(circ, torch.zeros((1, f_raw + 2))).shape[1])
    h1, h2 = hidden
    predictors = ("M_ED", "M_ES", "M_L", "M_O", "M_V")
    transition = ("M_ED", "M_L")
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    one = functools.partial(torch.ones, dtype=torch.float32, device=device)

    def head(f, family):
        if family == "gbdt":
            return {"feat": torch.zeros((44, 255), dtype=torch.int32,
                                        device=device),
                    "thr": z((44, 255)), "leaf": z((44, 256)), "base": z(())}
        if family == "linear":
            return {"mu": z((f,)), "sd": one((f,)), "w": z((f + 1,))}
        if family == "mlp":
            return {"x_mu": z((f,)), "x_sd": one((f,)), "y_mu": z((1,)),
                    "y_sd": one((1,)), "w0": z((f, h1)), "b0": z((h1,)),
                    "w1": z((h1, h2)), "b1": z((h2,)), "w2": z((h2, 1)),
                    "b2": z((1,))}
        raise ValueError(f"unsupported synthetic family: {family!r}")

    families = tuple((p, "gbdt" if p in gbdt else family)
                     for p in predictors)
    params = {p: head(f_tr if p in transition else f_aug, fam)
              for p, fam in families}
    manifest = Manifest(
        circuit=circuit_name, format_version=FORMAT_VERSION,
        families=families,
        scales=tuple((p, 1.0) for p in predictors),
        features=_feature_names(circuit_name))
    return Surrogate(manifest=manifest, params=params, fit_info=None)


# --- the entrypoint registry --------------------------------------------------

_ENTRYPOINTS: dict = {}


def register_entrypoint(name: str):
    """Decorator: register an audit entrypoint builder under ``name``."""
    def deco(builder):
        _ENTRYPOINTS[name] = builder
        return builder
    return deco


def registered_entrypoints() -> dict:
    """Name -> builder snapshot of the audit entrypoint registry."""
    return dict(_ENTRYPOINTS)

@dataclasses.dataclass
class TracedEntry:
    """What one registered builder hands the auditor for ``n`` ticks: a
    callable, its arguments (built outside the counted run), and hard
    ceilings checked at every regen: ``max_dispatch`` on the count at one
    tick, ``max_kernels`` on kernel calls per tick, ``exact_kernels`` as
    ``{name: (per tick, fixed)}``."""

    fn: object
    args: tuple
    max_dispatch: dict = dataclasses.field(default_factory=dict)
    max_kernels: dict = dataclasses.field(default_factory=dict)
    exact_kernels: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AuditContext:
    """Shared fixtures every entrypoint builder draws from."""

    lif: object                        # synthetic lif Surrogate
    xbar: object                       # synthetic crossbar Surrogate
    wide: object                       # lif MLP(200, 50), M_ES a GBDT
    spec: object                       # tiny 2-layer LIF NetworkSpec
    spec1: object                      # its first layer alone
    device: torch.device
    b: int = 2


def build_context(device=None) -> AuditContext:
    """The reference's context (``:228-235``) on ``device`` (the card
    unless the caller asks for another), plus the unpackable surrogate and
    the one-layer spec of the kernel routes."""
    from repro_torch.core.network import snn_spec
    device = ops.resolve_device(device)
    w1 = np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(2, 3)
    w2 = np.linspace(1.0, -1.0, 6, dtype=np.float32).reshape(3, 2)
    params = [np.asarray([0.58, 0.5, 0.5, 0.5], np.float32)] * 2
    return AuditContext(
        lif=synthetic_surrogate("lif", device=device),
        xbar=synthetic_surrogate("crossbar", device=device),
        wide=synthetic_surrogate("lif", hidden=(200, 50), gbdt=("M_ES",),
                                 device=device),
        spec=snn_spec([w1, w2], params), spec1=snn_spec([w1], params[:1]),
        device=device)


NO_KERNEL = {"network_tick": (0, 0), "network_tick_chunk": (0, 0),
             "mlp_surrogate_heads": (0, 0), "mlp_surrogate": (0, 0),
             "gbdt_walk": (0, 0)}


def _tick_entry(ctx, n, sur, circuit_name, annotate=False, **kw):
    """``n`` chained ``wrapper.lasana_step`` ticks of one bank of four
    circuits, annotation mode's known outputs an argument after the tick
    times; the reference's ``_tick_args`` (``:238-246``)."""
    from repro_torch.core import wrapper
    from repro_torch.core.circuits import get_circuit
    circ = get_circuit(circuit_name)
    f32 = dict(dtype=torch.float32, device=ctx.device)
    rows = 4
    state = wrapper.init_state(rows, torch.zeros((rows, circ.n_params),
                                                 **f32))
    changed = torch.ones((rows,), dtype=torch.bool, device=ctx.device)
    x = torch.zeros((rows, circ.n_inputs), **f32)
    ts = (torch.arange(n, **f32) + 3.0) * circ.clock_ns

    def fn(sur, state, changed, x, ts, *known):
        for k in range(n):
            state, _, _, _ = wrapper.lasana_step(
                sur, state, changed, x, ts[k], circ.clock_ns,
                known_out=known[0] if known else None, **kw)
        return state

    known = (torch.zeros((rows,), **f32),) if annotate else ()
    return fn, (sur, state, changed, x, ts, *known)


@register_entrypoint("tick_fused_standalone")
def _entry_tick_fused(ctx: AuditContext, n: int) -> TracedEntry:
    """Single-bank Algorithm-1 tick, fused predict_heads path."""
    fn, args = _tick_entry(ctx, n, ctx.lif, "lif", spiking=True, fused=True,
                           fused_kernel=False)
    return TracedEntry(fn=fn, args=args,
                       max_dispatch={"predict_heads": 3, "predict": 0,
                                     "megakernel_step": 0})


@register_entrypoint("tick_fused_annotation")
def _entry_tick_annotation(ctx: AuditContext, n: int) -> TracedEntry:
    """Annotation-mode tick: no data dependencies -> ONE stacked pass."""
    fn, args = _tick_entry(ctx, n, ctx.lif, "lif", spiking=True, fused=True,
                           fused_kernel=False, annotate=True)
    return TracedEntry(fn=fn, args=args,
                       max_dispatch={"predict_heads": 1, "predict": 0})


@register_entrypoint("tick_percall")
def _entry_tick_percall(ctx: AuditContext, n: int) -> TracedEntry:
    """Per-predict baseline: seven dispatches, the A/B comparison arm."""
    fn, args = _tick_entry(ctx, n, ctx.lif, "lif", spiking=True,
                           fused=False)
    return TracedEntry(fn=fn, args=args,
                       max_dispatch={"predict": 7, "predict_heads": 0},
                       exact_kernels=NO_KERNEL)


@register_entrypoint("tick_megakernel")
def _entry_tick_megakernel(ctx: AuditContext, n: int) -> TracedEntry:
    """Whole-tick megakernel: the entire tick is ONE dispatch, one
    ``network_tick`` launch."""
    fn, args = _tick_entry(ctx, n, ctx.lif, "lif", spiking=True, fused=True,
                           fused_kernel=True)
    return TracedEntry(fn=fn, args=args,
                       max_dispatch={"megakernel_step": 1,
                                     "predict_heads": 0, "predict": 0},
                       exact_kernels={**NO_KERNEL, "network_tick": (1, 0)})


@register_entrypoint("tick_xbar_fused")
def _entry_tick_xbar(ctx: AuditContext, n: int) -> TracedEntry:
    """Crossbar-bank tick on the fused path (mixed-graph second kind)."""
    fn, args = _tick_entry(ctx, n, ctx.xbar, "crossbar", spiking=False,
                           fused=True, fused_kernel=False)
    return TracedEntry(fn=fn, args=args,
                       max_dispatch={"predict_heads": 3, "predict": 0})


@register_entrypoint("explore_pricing")
def _entry_explore(ctx: AuditContext, n: int) -> TracedEntry:
    """The DSE sweep's pricing pass, ``n`` times: two fused passes (act:
    M_O, then tr: M_ED/M_L chained on the resolved output)."""
    from repro_torch.core.explore import DSEEngine
    eng = DSEEngine(n_samples=8, device=ctx.device)
    ws = eng._program(ctx.xbar, 4)

    def fn(sur, v_dd, tile):
        for _ in range(n):
            eng._tile_eval(sur, v_dd, tile, ws)
    return TracedEntry(
        fn=fn, args=(ctx.xbar,
                     torch.full((4,), 1.5, device=ctx.device),
                     torch.full((4,), 32, dtype=torch.int32,
                                device=ctx.device)),
        max_dispatch={"predict_heads": 2, "predict": 0})


def _network_engine(ctx, spec=None, **kw):
    from repro_torch.core.network import NetworkEngine
    return NetworkEngine(spec or ctx.spec, backend=kw.pop("backend",
                                                          "lasana"),
                         record_hidden=False, device=ctx.device, **kw)


def _network_state(eng, ctx, n):
    """``(banks, carries, prev0, x_seq)`` of ``n`` ticks, as the engine's
    own callers build them (no banks off the lasana backend)."""
    spec = eng.spec
    banks = eng._runtime_banks(ctx.lif if eng.backend == "lasana"
                               else None)
    carries = [eng._init_carry(i, ctx.b) for i in range(spec.n_layers)]
    prev0 = [torch.zeros((ctx.b, l.n_out), device=ctx.device)
             for l in spec.layers]
    x_seq = torch.zeros((n, ctx.b, spec.layers[0].fan_in),
                        device=ctx.device)
    return banks, carries, prev0, x_seq


@register_entrypoint("network_mono")
def _entry_network_mono(ctx: AuditContext, n: int) -> TracedEntry:
    """The monolithic network runner (lasana.simulate)."""
    eng = _network_engine(ctx)
    banks, carries, _, x_seq = _network_state(eng, ctx, n)
    L = ctx.spec.n_layers
    # the runner ends with the idle-energy flush: one per-predict M_ES
    # pass per layer on top of the fused ticks
    return TracedEntry(fn=eng._build_sim(ctx.b, n),
                       args=(x_seq, carries, banks),
                       max_dispatch={"predict_heads": 3 * L, "predict": L})


@register_entrypoint("network_stream_chunk")
def _entry_stream_chunk(ctx: AuditContext, n: int) -> TracedEntry:
    """The stream's chunk runner (lasana.stream), ``k0`` a Python int as
    the stream driver passes it."""
    eng = _network_engine(ctx)
    banks, carries, prev0, x_seq = _network_state(eng, ctx, n)
    L = ctx.spec.n_layers
    return TracedEntry(fn=eng._build_stream_step(n),
                       args=(x_seq, 0, carries, prev0, banks),
                       max_dispatch={"predict_heads": 3 * L, "predict": 0})


@register_entrypoint("network_stream_flush")
def _entry_stream_flush(ctx: AuditContext, n: int) -> TracedEntry:
    """End-of-stream idle-energy flush (one M_ES pass per LIF layer)."""
    eng = _network_engine(ctx)
    banks, carries, _, _ = _network_state(eng, ctx, n)
    L = ctx.spec.n_layers
    return TracedEntry(fn=eng._build_flush(),
                       args=(carries, [0.0] * L, banks),
                       max_dispatch={"predict": L, "predict_heads": 0})


@register_entrypoint("serve_slot_step")
def _entry_slot_step(ctx: AuditContext, n: int) -> TracedEntry:
    """The serving layer's slot-masked chunk runner (Lane.step): ``k0`` a
    Python float, ``end_ks`` on the device, as the lane passes them."""
    eng = _network_engine(ctx)
    banks, carries, prev0, x_seq = _network_state(eng, ctx, n)
    L = ctx.spec.n_layers
    end_ks = torch.zeros((ctx.b,), device=ctx.device)
    return TracedEntry(fn=eng._build_slot_step(ctx.b, n),
                       args=(x_seq, 0.0, end_ks, carries, prev0, banks),
                       max_dispatch={"predict_heads": 3 * L, "predict": 0})


@register_entrypoint("serve_slot_flush")
def _entry_slot_flush(ctx: AuditContext, n: int) -> TracedEntry:
    """Per-slot leave-time flush (Lane leavers' trailing idle energy)."""
    eng = _network_engine(ctx)
    banks, carries, _, _ = _network_state(eng, ctx, n)
    L = ctx.spec.n_layers
    t_ends = torch.zeros((L, ctx.b), device=ctx.device)
    return TracedEntry(fn=eng._build_slot_flush(ctx.b),
                       args=(carries, t_ends, banks),
                       max_dispatch={"predict": L, "predict_heads": 0})


@register_entrypoint("serve_slot_step_behavioral")
def _entry_slot_step_behavioral(ctx: AuditContext, n: int) -> TracedEntry:
    """Graceful-degradation slot chunk: the behavioral-backend lane the
    server falls back to after repeated surrogate faults. No surrogate
    banks: zero predict dispatches and zero surrogate kernels are the
    ceiling AND the point."""
    eng = _network_engine(ctx, backend="behavioral")
    banks, carries, prev0, x_seq = _network_state(eng, ctx, n)
    end_ks = torch.zeros((ctx.b,), device=ctx.device)
    return TracedEntry(fn=eng._build_slot_step(ctx.b, n),
                       args=(x_seq, 0.0, end_ks, carries, prev0, banks),
                       max_dispatch={"predict_heads": 0, "predict": 0},
                       exact_kernels=NO_KERNEL)


@register_entrypoint("serve_slot_join")
def _entry_slot_join(ctx: AuditContext, n: int) -> TracedEntry:
    """Masked slot (re)initialization at a chunk boundary (Lane.admit)."""
    eng = _network_engine(ctx)
    _, carries, prev0, _ = _network_state(eng, ctx, n)
    mask = torch.zeros((ctx.b,), dtype=torch.bool, device=ctx.device)
    return TracedEntry(fn=eng._build_slot_join(ctx.b),
                       args=(carries, prev0, mask,
                             torch.zeros((), device=ctx.device)),
                       max_dispatch={"predict": 0, "predict_heads": 0})


# the port's kernel routes, at its own default (fused kernel on)

@register_entrypoint("network_mono_kernel")
def _entry_network_mono_kernel(ctx: AuditContext, n: int) -> TracedEntry:
    """The packable 2-layer LIF network on the kernel route: one
    ``network_tick`` launch per layer per tick, the flush on the host."""
    eng = _network_engine(ctx, fused_kernel=True)
    banks, carries, _, x_seq = _network_state(eng, ctx, n)
    L = ctx.spec.n_layers
    return TracedEntry(fn=eng._build_sim(ctx.b, n),
                       args=(x_seq, carries, banks),
                       max_dispatch={"megakernel_step": L,
                                     "predict_heads": 0, "predict": L},
                       exact_kernels={**NO_KERNEL, "network_tick": (L, 0)})


@register_entrypoint("network_stream_chunk_kernel")
def _entry_stream_chunk_kernel(ctx: AuditContext, n: int) -> TracedEntry:
    """A one-LIF-layer stream chunk: ONE ``network_tick_chunk`` launch per
    chunk, whatever its length."""
    eng = _network_engine(ctx, ctx.spec1, fused_kernel=True)
    banks, carries, prev0, x_seq = _network_state(eng, ctx, n)
    return TracedEntry(fn=eng._build_stream_step(n),
                       args=(x_seq, 0, carries, prev0, banks),
                       max_dispatch={"megakernel_step": 0,
                                     "predict_heads": 0, "predict": 0},
                       exact_kernels={**NO_KERNEL,
                                      "network_tick_chunk": (0, 1)})


@register_entrypoint("tick_xbar_kernel")
def _entry_tick_xbar_kernel(ctx: AuditContext, n: int) -> TracedEntry:
    """A crossbar-bank tick on the kernel route: one ``network_tick``."""
    fn, args = _tick_entry(ctx, n, ctx.xbar, "crossbar", spiking=False,
                           fused=True, fused_kernel=True)
    return TracedEntry(fn=fn, args=args,
                       max_dispatch={"megakernel_step": 1,
                                     "predict_heads": 0, "predict": 0},
                       exact_kernels={**NO_KERNEL, "network_tick": (1, 0)})


@register_entrypoint("tick_unpackable_kernel")
def _entry_tick_unpackable_kernel(ctx: AuditContext, n: int) -> TracedEntry:
    """Heads ``network_tick`` does not take (MLP(200, 50), M_ES a GBDT,
    as ``lif_unpackable``'s): the stacked tick, its MLP groups through
    at most 3 ``mlp_surrogate_heads`` launches a tick, the idle and the
    active M_ES through one ``gbdt_walk`` each."""
    fn, args = _tick_entry(ctx, n, ctx.wide, "lif", spiking=True,
                           fused=True, fused_kernel=True)
    return TracedEntry(fn=fn, args=args,
                       max_dispatch={"predict_heads": 3, "predict": 0,
                                     "megakernel_step": 0},
                       max_kernels={"mlp_surrogate_heads": 3},
                       exact_kernels={"network_tick": (0, 0),
                                      "network_tick_chunk": (0, 0),
                                      "gbdt_walk": (2, 0)})


# --- auditing one entrypoint --------------------------------------------------

def audit_entry(name: str, build, around=contextlib.nullcontext):
    """-> (ProgramMetrics, [Finding]) for one entrypoint: ``build(n)``
    gives its :class:`TracedEntry` for ``n`` ticks. One uncounted run
    first fills what outlives a call (a surrogate's head stacks, the
    kernel libraries); then each counted run is made inside ``around()``
    (the card's sync debug mode, on the card)."""
    warm = build(TICKS[0])
    warm.fn(*warm.args)
    entries = [build(n) for n in TICKS]
    m = metrics_of([_run_once(e, around) for e in entries])
    spec = entries[0]
    findings = []
    for counter, ceiling in sorted(spec.max_dispatch.items()):
        got = m.dispatches.get(counter, 0)
        if got > ceiling:
            findings.append(Finding(
                "dispatch-budget", name,
                f"{got} {counter} dispatches per tick; the architectural "
                f"ceiling is {ceiling} (a frozen-budget regen cannot lift "
                "this — the program structure regressed)"))
    per, fixed = m.kernels["per_tick"], m.kernels["fixed"]
    for kernel, ceiling in sorted(spec.max_kernels.items()):
        if per.get(kernel, 0) > ceiling:
            findings.append(Finding(
                "kernel-budget", name,
                f"{per[kernel]} {kernel} calls per tick; the ceiling is "
                f"{ceiling}"))
    for kernel, want in sorted(spec.exact_kernels.items()):
        got = (per.get(kernel, 0), fixed.get(kernel, 0))
        if got != tuple(want):
            findings.append(Finding(
                "kernel-budget", name,
                f"{kernel}: {got[0]} calls per tick and {got[1]} fixed; "
                f"the route launches exactly {want[0]} per tick and "
                f"{want[1]} fixed"))
    for op, where in m.syncs:
        findings.append(Finding(
            "host-sync", name,
            f"host-sync op '{op}' {where}: every call would stall on a "
            "host round trip"))
    for dtype in sorted({d for d, _ in m.wide_dtypes}):
        made_by = ", ".join(op for d, op in m.wide_dtypes if d == dtype)
        findings.append(Finding(
            "fp64-promotion", name,
            f"wide dtype {dtype} out of {made_by}: the hot path is "
            "fp32-only (an fp64 leak doubles bandwidth and silently "
            "changes records)"))
    if m.writes:
        findings.append(Finding(
            "carry-write", name,
            f"{m.writes} argument tensor(s) written in place: the runners "
            "read the caller's carries and never write them (a stream "
            "checkpoint snapshots them)"))
    for what in m.nonlinear:
        findings.append(Finding(
            "nonlinear-count", name,
            f"{what} at 1, 2, 3 ticks: not a fixed part plus a per-tick "
            "part"))
    return m, findings


# --- frozen budgets -----------------------------------------------------------

BUDGETS_PATH = pathlib.Path(__file__).resolve().parent / \
    "program_budgets.json"


@contextlib.contextmanager
def pinned_env():
    """Pin the knobs that select runner bodies, as the reference's
    ``pinned_env`` (``:521``): the fused kernel OFF (the port's default is
    ON; its ``*_kernel`` entrypoints opt in explicitly) and no fault plan
    ("" reads as none through ``ops.fault_plan_path``)."""
    with ops.env_override({"REPRO_FUSED_KERNEL": "0",
                           "REPRO_FAULT_PLAN": ""}):
        yield


def _audit_all(ctx, around=contextlib.nullcontext):
    """{name: (metrics, findings)} over the registry, in name order."""
    return {name: audit_entry(name, functools.partial(builder, ctx), around)
            for name, builder in sorted(_ENTRYPOINTS.items())}


def collect_budgets(device=None) -> dict:
    """Run every registered entrypoint on ``device`` -> {name: budget
    row}. Only rows counted on the CPU are frozen (``save_budgets``)."""
    with pinned_env():
        ctx = build_context(device)
        return {name: m.budget_row()
                for name, (m, _) in _audit_all(ctx).items()}


def load_budgets(path=BUDGETS_PATH) -> dict:
    with open(path) as f:
        return json.load(f)["entries"]


def save_budgets(rows: dict, path=BUDGETS_PATH) -> None:
    """Freeze ``rows``, which ``collect_budgets(device="cpu")`` counted."""
    payload = {
        "_comment": [
            "Frozen per-entrypoint budgets of the port's hot paths: surrogate",
            "dispatches at one tick (per tick + fixed, the reference's trace",
            "count), kernel calls and products per tick and fixed, aten ops",
            "per tick outside kernel entry points, and argument tensors",
            "written, all counted on the CPU (a run on the card holds only",
            "dispatches, kernels and writes: ops and dots differ there).",
            "Checked by python -m repro_torch.analysis --device cpu;",
            "regenerate an intentional change with:",
            "  PYTHONPATH=src python -m repro_torch.analysis --device cpu --regen",
            "and review the diff. Ceilings are hard-coded in",
            "repro_torch/analysis/jaxpr_audit.py and cannot be regenerated",
            "away.",
        ],
        "entries": {k: rows[k] for k in sorted(rows)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


# what a run on another device than the CPU is held to: the frozen ``ops``
# and ``dots`` are CPU counts
DEVICE_FIELDS = ("dispatches", "kernels", "writes")


def compare_budgets(rows: dict, frozen: dict, device) -> list:
    """Findings where ``rows``, counted on ``device``, differ from the
    frozen CPU rows: every field on the CPU, ``DEVICE_FIELDS`` elsewhere."""
    if torch.device(device).type != "cpu":
        rows = {k: {f: r[f] for f in DEVICE_FIELDS} for k, r in rows.items()}
        frozen = {k: {f: r[f] for f in DEVICE_FIELDS}
                  for k, r in frozen.items()}
    findings = []
    for name in sorted(set(rows) | set(frozen)):
        if name not in frozen:
            findings.append(Finding(
                "program-budget", name,
                "entrypoint has no frozen budget — run python -m "
                "repro_torch.analysis --device cpu --regen and review the "
                "new row"))
        elif name not in rows:
            findings.append(Finding(
                "program-budget", name,
                "frozen budget exists but the entrypoint is no longer "
                "registered — regen to drop it"))
        elif rows[name] != frozen[name]:
            findings.append(Finding(
                "program-budget", name,
                f"dispatched program drifted from the frozen budget: now "
                f"{rows[name]}, frozen {frozen[name]} (intentional? regen "
                "with python -m repro_torch.analysis --device cpu --regen)"))
    return findings


# --- cache-key completeness ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheKeySpec:
    """One registered cache: where its key is built and what the key must
    discriminate on."""

    name: str
    module: str
    qualname: str
    required: tuple


# The port has no REPRO_TICK_PALLAS knob (a CUDA tensor always launches
# the kernel), so the network runner key has no tick_pallas_enabled; the
# engine cache adds the device, which the reference's has no need of.
CACHE_KEY_REGISTRY = (
    CacheKeySpec(
        "engine-cache", "repro_torch.lasana", "engine",
        required=("backend", "mode", "mesh", "record_hidden", "fused",
                  "fused_kernel", "device")),
    CacheKeySpec(
        "network-program-cache", "repro_torch.core.network",
        "NetworkEngine._program_key",
        required=("kind", "fused", "fused_kernel_enabled", "b", "t_steps",
                  "structure_key")),
    CacheKeySpec(
        "dse-program-cache", "repro_torch.core.explore",
        "DSEEngine._program",
        required=("c", "n_samples", "structure_key")),
    CacheKeySpec(
        "serve-lane-table", "repro_torch.serve.server", "SimServer._lane_for",
        required=("bucket", "sur_token", "mode", "degraded")),
)


def check_cache_key_source(src: str, required, name: str) -> list:
    """AST-check one cache-key function's source: every declared
    discriminator must appear, and ``id(...)`` must never be called —
    object identity is not value equality, and a recycled address aliases
    the cache onto the wrong entry."""
    findings = []
    tree = ast.parse(textwrap.dedent(src))
    seen = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            seen.add(node.id)
        elif isinstance(node, ast.Attribute):
            seen.add(node.attr)
        elif isinstance(node, ast.arg):
            seen.add(node.arg)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "id"):
            findings.append(Finding(
                "cache-key", name,
                f"id(...) used in a cache-key expression (line "
                f"{node.lineno}): identity keys alias recycled objects — "
                "key by value/structure instead"))
    for field in required:
        if field not in seen:
            findings.append(Finding(
                "cache-key", name,
                f"declared key field '{field}' does not appear in the "
                "key-building function — the cache cannot discriminate "
                "on it (stale-runner aliasing)"))
    return findings


def check_cache_keys() -> list:
    findings = []
    for spec in CACHE_KEY_REGISTRY:
        obj = importlib.import_module(spec.module)
        for part in spec.qualname.split("."):
            obj = getattr(obj, part)
        findings.extend(check_cache_key_source(
            inspect.getsource(obj), spec.required,
            f"{spec.module}.{spec.qualname}"))
    return findings


def check_program_key_sensitivity(ctx: AuditContext) -> list:
    """Dynamic completeness check on the network runner cache: flip each
    knob that selects a different runner body and assert the key moves
    (the static registry's runtime shadow: an AST check can see a name,
    only this proves the key discriminates)."""
    findings = []
    banks = _network_engine(ctx)._runtime_banks(ctx.lif)
    small = _network_engine(ctx)._runtime_banks(
        synthetic_surrogate("lif", hidden=(6, 3), device=ctx.device))

    def key(*, fused=True, fused_kernel=False, b=2, t_steps=3,
            kind="stream", banks=banks, env=None):
        with ops.env_override(env or {}):
            eng = _network_engine(ctx, fused=fused,
                                  fused_kernel=fused_kernel)
            return eng._program_key(kind, b, t_steps, banks)

    base = key()
    pairs = {
        "fused": (base, key(fused=False)),
        "fused_kernel": (base, key(fused_kernel=True)),
        "REPRO_FUSED_KERNEL": (
            key(fused_kernel=None, env={"REPRO_FUSED_KERNEL": "0"}),
            key(fused_kernel=None, env={"REPRO_FUSED_KERNEL": "1"})),
        "batch": (base, key(b=4)),
        "t_steps": (base, key(t_steps=5)),
        "kind": (base, key(kind="slot")),
        "surrogate-structure": (base, key(banks=small)),
    }
    for knob, (a, b) in pairs.items():
        if a == b:
            findings.append(Finding(
                "cache-key", "NetworkEngine._program_key",
                f"flipping '{knob}' does not change the runner cache key — "
                "the stale runner would be silently reused"))
    return findings


# --- environment discipline ---------------------------------------------------

# Stricter than the reference, which lets any module write the environment
# and its auditor read it: here kernels/ops.py alone touches it, reads
# through its accessors and writes through ops.env_override / child_env.
ENV_ALLOWLIST = ("src/repro_torch/kernels/ops.py",)
ENV_NAMES = ("environ", "getenv", "putenv", "unsetenv")


def _env_violations(tree: ast.AST, rel: str) -> list:
    """Flag every touch of the environment: ``os.environ`` in any use
    (a read, a write, passed on), ``os.getenv`` / ``putenv`` /
    ``unsetenv``, and importing one of them from ``os``."""
    parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
    findings = []
    for node in ast.walk(tree):
        what = None
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            names = [a.name for a in node.names if a.name in ENV_NAMES]
            if names:
                what = f"from os import {', '.join(names)}"
        elif (isinstance(node, ast.Attribute) and node.attr in ENV_NAMES
                and isinstance(node.value, ast.Name)
                and node.value.id == "os"):
            up = parents.get(node)
            if node.attr != "environ":
                what = f"os.{node.attr}(...)"
            elif isinstance(up, ast.Subscript):
                what = "os.environ[...] " + (
                    "read" if isinstance(up.ctx, ast.Load) else "written")
            elif isinstance(up, ast.Attribute):
                what = f"os.environ.{up.attr}(...)"
            else:
                what = "os.environ"
        if what:
            findings.append(Finding(
                "env-discipline", rel,
                f"{what} at line {node.lineno}: only kernels/ops.py touches "
                "the environment (reads through its accessors, writes "
                "through ops.env_override / ops.child_env: the auditor's "
                "single choke point)"))
    return findings


def check_env_discipline(root=REPO_ROOT) -> list:
    """Touches of the environment outside the allowlist, over
    ``src/repro_torch`` and ``chip_smoke.py`` under ``root``."""
    root = pathlib.Path(root)
    base = root / "src" / "repro_torch"
    paths = sorted(base.rglob("*.py")) if base.is_dir() else []
    if (root / "chip_smoke.py").is_file():
        paths.append(root / "chip_smoke.py")
    findings = []
    for path in paths:
        rel = path.relative_to(root).as_posix()
        if rel not in ENV_ALLOWLIST:
            findings.extend(_env_violations(ast.parse(path.read_text()),
                                            rel))
    return findings


# --- the whole audit ----------------------------------------------------------

def run_audit(budgets: dict | None = None, device=None) -> list:
    """Run every pass on ``device`` (the card unless the caller asks for
    another); returns the (possibly empty) list of findings.

    ``budgets``: frozen rows to diff against (pass ``load_budgets()``;
    None skips the frozen comparison — ceilings, writes, dtype and sync,
    cache-key and environment checks still run)."""
    findings = []
    with pinned_env():
        ctx = build_context(device)
        rows = {}
        for name, (m, entry_findings) in _audit_all(ctx).items():
            rows[name] = m.budget_row()
            findings.extend(entry_findings)
        if budgets is not None:
            findings.extend(compare_budgets(rows, budgets, ctx.device))
        findings.extend(check_program_key_sensitivity(ctx))
    findings.extend(check_cache_keys())
    findings.extend(check_env_discipline())
    return findings
