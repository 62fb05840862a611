"""Whole-tick LASANA megakernel: Algorithm 1 as ONE kernel launch.

Port of ``repro.kernels.tick_megakernel``. :func:`pack_heads` lifts a
surrogate's five predictors into two canonical stacks — A (idle/active
width: ``M_ES``, ``M_V``, ``M_O``) and T (transition width: ``M_ED``,
``M_L``) — each a uniform ``(P, F, H1)/(P, H1, H2)/(P, H2, 1)`` layout plus
standardizers, whatever the family; :class:`PackLayout` carries the
per-head family tags so that evaluation stays native-cost (a mean head is
one broadcast, a linear head one dot).

:func:`network_tick` is the kernel entry: ``_tick_arrays`` (the
reference's body with ``skip=False``, which its docstring states is
exact) on CPU tensors, ``csrc/network_tick.cu`` on CUDA tensors.
:func:`network_tick_chunk` runs T ticks in one launch (LIF rows, v / o /
t_last resident); its plain version is a loop of the plain tick. Both
kernels are persistent grids of row tiles that spread each head's
products over a block's threads (the chunk kernel loops over the ticks
inside the tile), and both run the same device functions, so a chunk
equals T one-tick launches bit for bit. The kernels take the stacks as
they are (they pad rows only in shared memory); they derive the feature
row of a LIF neuron or a crossbar row themselves, and stage only the
launching kind's heads of a cross-kind :func:`pack_library` pack.

Routes are decided from shapes alone, the same on every device:
:func:`kernel_takes` is the one-tick kernel's own layout rule and
:func:`chunk_takes` the chunk kernel's, transcribed from the CUDA source.
:func:`pack_heads` and :func:`pack_library` build no pack the kernel
refuses, so an engine given wider heads takes the stacked-dispatch tick
(whose MLP groups launch ``mlp_surrogate_heads``), and a stream whose pack
the chunk kernel refuses takes one ``network_tick`` launch per tick.

:func:`work` and :func:`chunk_work` reckon a call's operations and bytes
from its shapes and the rows the data sends through each stage. In
``ops.dry_run`` both entry points take meta tensors, return meta outputs
and record the work of the worst case, every row changed, stale and
firing: the reference's ``hlo_cost`` likewise takes the costlier branch
of a ``lax.cond``, and the kernel's stage skips are block-wide votes on
data a meta tensor does not hold.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.circuits import augment_features, get_circuit
from repro_torch.core.wrapper import (LasanaState, _features, _finish_tick,
                                      _resolve_output, _splice_transition)
from repro_torch.kernels import _build, ops

PACK_HEADS_A = ("M_ES", "M_V", "M_O")
PACK_HEADS_T = ("M_ED", "M_L")
_PACKABLE = ("mean", "linear", "mlp")
_FAMILY_CODE = {"mean": 0, "linear": 1, "mlp": 2}    # csrc/heads.cuh Family
_STACK_KEYS = ("x_mu", "x_sd", "y_mu", "y_sd",
               "w0", "b0", "w1", "b1", "w2", "b2", "scale")
# csrc/network_tick.cu row kinds: LifRow::kCode, XbarRow::kCode
_CIRCUIT_CODE = {"lif": 0, "crossbar": 1}


# --- the work of a call ------------------------------------------------------

def _stage_flops(layout, circuit: str, n_in: int, n_params: int, h1: int,
                 h2: int) -> tuple:
    """(one row's active heads, its idle heads, its transition heads), in
    operations."""
    from repro_torch.kernels.mlp_surrogate import head_flops
    f_row = n_in + 2 + n_params + 1
    fa = [head_flops(fm, f_row, h1, h2) for fm in layout.a_fams]
    ft = [head_flops(fm, f_row + 2, h1, h2) for fm in layout.t_fams]
    return sum(fa), sum(fa[:2]), sum(ft)


def _pack_elems(pack) -> int:
    return sum(a.numel() for s in pack.values() for a in s.values())


def work(pack, layout, circuit: str, n: int, n_in: int, n_params: int,
         rows=None) -> ops.Work:
    """One ``network_tick`` over ``n`` rows: the active heads on each
    changed row, the idle heads on each stale one and the transition heads
    where the output changed (``rows`` = (changed, stale, output changed)
    counts, every row by default); state, inputs, params, the mask and the
    pack read, the five outputs written."""
    h1, h2 = pack["a"]["w0"].shape[2], pack["a"]["w1"].shape[2]
    act, idle, tr = _stage_flops(layout, circuit, n_in, n_params, h1, h2)
    n_ch, n_st, n_tr = (n, n, n) if rows is None else rows
    return ops.Work(n_ch * act + n_st * idle + n_tr * tr,
                    n * (3 * 4 + 4 * (n_in + n_params) + 1) + n * 5 * 4
                    + _pack_elems(pack) * 4)


def chunk_work(pack, layout, n: int, t_steps: int, rows=None) -> ops.Work:
    """One ``network_tick_chunk`` of ``t_steps`` LIF ticks over ``n``
    rows: ``rows`` a (changed, stale, output changed) count per tick
    (every row every tick by default); the state and params read once,
    each tick's mask, inputs and time read and its three sequences
    written, the state written once."""
    circ = get_circuit("lif")
    h1, h2 = pack["a"]["w0"].shape[2], pack["a"]["w1"].shape[2]
    act, idle, tr = _stage_flops(layout, "lif", circ.n_inputs,
                                 circ.n_params, h1, h2)
    rows = [(n, n, n)] * t_steps if rows is None else rows
    flops = sum(c * act + s * idle + f * tr for c, s, f in rows)
    return ops.Work(flops, n * (3 + 4) * 4 + t_steps * n * (1 + 3 * 4)
                    + t_steps * 4 + n * 3 * 4 + t_steps * n * 3 * 4
                    + _pack_elems(pack) * 4)


# --- the kernels' layout rule -------------------------------------------------
#
# csrc/network_tick.cu's tick_widths_ok, make_pad, work_floats and
# tick_smem, transcribed, so that a route is decided from a pack's shapes
# before any launch and on the CPU alike; chip_smoke.py holds this copy to
# the compiled rule (network_tick_park_floats, network_tick_chunk_takes)
# over a sweep of widths.

_MAX_SMEM = 232448              # csrc/heads.cuh kMaxSmem, bytes
_MIN_ROWS, _MAX_ROWS = 32, 128  # network_tick.cu kMinRows, kMaxRows
MAX_H1 = 128                    # network_tick.cu kMaxH1


def _up4(x: int) -> int:
    return (x + 3) & ~3


def _pad_floats(fs: int, h1: int, h2: int) -> int:
    """floats of one head in the kernels' padded layout (make_pad.per)"""
    return 2 * _up4(fs) + fs * _up4(h1) + _up4(h1) + h1 * _up4(h2) \
        + 2 * _up4(h2) + 4


def _work_floats(rows: int, f_t: int, h1: int, h2: int) -> int:
    return rows * (max(f_t, h2) + h1 + 12) + f_t * (rows + 1) + rows + 8


@functools.cache
def _row_width(circuit: str) -> int:
    """The kernels' feature-row width of ``circuit`` (Row::kFa): inputs,
    v, tau, params and the derived column."""
    circ = get_circuit(circuit)
    return circ.n_inputs + 2 + circ.n_params + 1


@functools.cache
def _tick_layout(circuit: str, h1: int, h2: int):
    """``(together, rows)``: whether both stacks fit in shared memory
    beside a tile of the kernel's fewest rows, and the most rows a tile
    then holds (0: not even 4)."""
    fa = _row_width(circuit)
    a, t = 3 * _pad_floats(fa, h1, h2), 2 * _pad_floats(fa + 2, h1, h2)
    room = _MAX_SMEM // 4
    together = a + t + _work_floats(_MIN_ROWS, fa + 2, h1, h2) <= room
    work = a + t if together else max(a, t)
    cap = _MAX_ROWS
    while cap > 0 and work + _work_floats(cap, fa + 2, h1, h2) > room:
        cap -= 4
    return together, cap


def kernel_takes(circuit: str, f_a: int, f_t: int, h1: int, h2: int) -> bool:
    """Whether ``network_tick`` takes ``circuit`` rows with A / T stacks
    of feature widths ``f_a`` / ``f_t`` and hidden widths ``h1``, ``h2``:
    a kind it has a feature row for, stacks at least the row's widths,
    H1 <= :data:`MAX_H1`, and room in shared memory for a 4-row tile
    beside the stacks (staged together or one after the other)."""
    if circuit not in _CIRCUIT_CODE:
        return False
    fa = _row_width(circuit)
    if f_a < fa or f_t < fa + 2 or h1 > MAX_H1:
        return False
    return _tick_layout(circuit, h1, h2)[1] > 0


def chunk_takes(circuit: str, f_a: int, f_t: int, h1: int, h2: int) -> bool:
    """Whether ``network_tick_chunk`` takes the same: LIF rows whose two
    stacks ``network_tick`` takes and stages together (LIF MLP(100, 50):
    yes; LIF MLP(128, 128), two phases: no)."""
    return (circuit == "lif" and kernel_takes(circuit, f_a, f_t, h1, h2)
            and _tick_layout(circuit, h1, h2)[0])


def _widths(pack):
    """``(f_a, f_t, h1, h2)`` of a pack's stacks."""
    _, f_a, h1 = pack["a"]["w0"].shape
    return f_a, pack["t"]["w0"].shape[1], h1, pack["a"]["w1"].shape[2]


def pack_chunk_takes(circuit: str, pack) -> bool:
    """:func:`chunk_takes` of a built pack."""
    return chunk_takes(circuit, *_widths(pack))


@dataclasses.dataclass(frozen=True)
class PackLayout:
    """Static metadata of one circuit kind's slice of a pack: per-head
    family tags in stack order and the kind's first stack indices."""

    a_fams: tuple
    t_fams: tuple
    a_off: int = 0
    t_off: int = 0


def _canonical(arrays, fam, f, h1, h2, scale, device):
    """One head's params in the uniform (F, H1)/(H1, H2)/(H2, 1) layout;
    unused slots hold zeros, and x_sd holds ONES (a zero would divide by
    zero and poison the row with NaNs)."""
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    out = {
        "x_mu": z((f,)), "x_sd": torch.ones((f,), device=device),
        "y_mu": z((1,)), "y_sd": torch.ones((1,), device=device),
        "w0": z((f, h1)), "b0": z((h1,)), "w1": z((h1, h2)), "b1": z((h2,)),
        "w2": z((h2, 1)), "b2": z((1,)),
        "scale": torch.full((1,), scale, device=device),
    }
    if fam == "mean":
        out["b2"] = arrays["mu"].reshape(1).float()
    elif fam == "linear":
        out["x_mu"] = arrays["mu"].float()
        out["x_sd"] = arrays["sd"].float()
        out["w0"][:, 0] = arrays["w"][:-1]
        out["b2"] = arrays["w"][-1:].float()
    else:
        out["x_mu"] = arrays["x_mu"].float()
        out["x_sd"] = arrays["x_sd"].float()
        out["y_mu"] = arrays["y_mu"].reshape(1).float()
        out["y_sd"] = arrays["y_sd"].reshape(1).float()
        w0, w1 = arrays["w0"], arrays["w1"]
        out["w0"][:, :w0.shape[1]] = w0
        out["b0"][:w0.shape[1]] = arrays["b0"]
        out["w1"][:w1.shape[0], :w1.shape[1]] = w1
        out["b1"][:w1.shape[1]] = arrays["b1"]
        out["w2"][:w1.shape[1]] = arrays["w2"]
        out["b2"] = arrays["b2"].reshape(1).float()
    return out


def _mlp_layers(arrays) -> int:
    return sum(1 for k in arrays if k.startswith("w"))


def pack_heads(surrogate):
    """Build ``(pack, PackLayout)`` for one surrogate, or ``(None, None)``
    when its heads do not pack: all five Algorithm-1 predictors present,
    every family mean/linear/3-layer MLP, the circuit registered, the
    trained feature widths equal to the circuit's augmented widths, and
    the widths ones the kernel takes (:func:`kernel_takes`)."""
    man, params = surrogate.manifest, surrogate.params
    try:
        circ = get_circuit(man.circuit)
    except KeyError:
        return None, None
    names = PACK_HEADS_A + PACK_HEADS_T
    if not set(names) <= set(man.predictors):
        return None, None
    fams = {p: man.family_of(p) for p in names}
    if any(f not in _PACKABLE for f in fams.values()):
        return None, None
    f_raw = circ.n_inputs + 2 + circ.n_params
    f_aug = int(augment_features(circ, torch.zeros((1, f_raw))).shape[1])
    f_tr = int(augment_features(circ, torch.zeros((1, f_raw + 2))).shape[1])

    def native_width(p):
        a, fam = params[p], fams[p]
        if fam == "mlp":
            return int(a["w0"].shape[0]) if _mlp_layers(a) == 3 else None
        if fam == "linear":
            return int(a["mu"].shape[0])
        return f_aug if p in PACK_HEADS_A else f_tr    # mean: width-free

    if any(native_width(p) != f_aug for p in PACK_HEADS_A):
        return None, None
    if any(native_width(p) != f_tr for p in PACK_HEADS_T):
        return None, None
    h1 = max([int(params[p]["w0"].shape[1])
              for p in names if fams[p] == "mlp"], default=1)
    h2 = max([int(params[p]["w1"].shape[1])
              for p in names if fams[p] == "mlp"], default=1)
    if not kernel_takes(man.circuit, f_aug, f_tr, h1, h2):
        return None, None
    device = surrogate.device

    def stack(pnames, f):
        heads = [_canonical(params[p], fams[p], f, h1, h2, man.scale_of(p),
                            device) for p in pnames]
        return {k: torch.stack([h[k] for h in heads]) for k in _STACK_KEYS}

    pack = {"a": stack(PACK_HEADS_A, f_aug), "t": stack(PACK_HEADS_T, f_tr)}
    layout = PackLayout(a_fams=tuple(fams[p] for p in PACK_HEADS_A),
                        t_fams=tuple(fams[p] for p in PACK_HEADS_T))
    return pack, layout


def _pad_stack(s, f, h1, h2):
    """Pad one canonical stack to (f, h1, h2); exact by construction
    (zero weights, ones x_sd — see :func:`_canonical`)."""
    def pad(a, dim, n, value=0.0):
        extra = n - a.shape[dim]
        if extra <= 0:
            return a
        spec = [0, 0] * (a.dim() - 1 - dim) + [0, extra]
        return F.pad(a, spec, value=value)
    return {
        "x_mu": pad(s["x_mu"], 1, f),
        "x_sd": pad(s["x_sd"], 1, f, value=1.0),
        "y_mu": s["y_mu"], "y_sd": s["y_sd"], "scale": s["scale"],
        "w0": pad(pad(s["w0"], 1, f), 2, h1),
        "b0": pad(s["b0"], 1, h1),
        "w1": pad(pad(s["w1"], 1, h1), 2, h2),
        "b1": pad(s["b1"], 1, h2),
        "w2": pad(s["w2"], 1, h2),
        "b2": s["b2"],
    }


def pack_library(banks):
    """Cross-kind head stacking: one pack for a whole library,
    ``(pack, {kind: PackLayout})``, or ``(None, {})`` if any kind does not
    pack or the kernel refuses a kind at the library-wide widths. Every
    kind's A/T stacks pad to those widths and concatenate along the head
    axis, kinds in sorted order; each kind addresses its heads through
    ``a_off``/``t_off``."""
    kinds = banks.kinds()
    packs, layouts = {}, {}
    for kind in kinds:
        p, lo = pack_heads(banks[kind])
        if p is None:
            return None, {}
        packs[kind], layouts[kind] = p, lo
    if len(kinds) == 1:
        return packs[kinds[0]], layouts
    f_a = max(p["a"]["w0"].shape[1] for p in packs.values())
    f_t = max(p["t"]["w0"].shape[1] for p in packs.values())
    h1 = max(p["a"]["w0"].shape[2] for p in packs.values())
    h2 = max(p["a"]["w1"].shape[2] for p in packs.values())
    if not all(kernel_takes(k, f_a, f_t, h1, h2) for k in kinds):
        return None, {}
    parts = {s: [_pad_stack(packs[k][s], f, h1, h2) for k in kinds]
             for s, f in (("a", f_a), ("t", f_t))}
    pack = {s: {k: torch.cat([p[k] for p in ps]) for k in _STACK_KEYS}
            for s, ps in parts.items()}
    offs = {}
    for i, kind in enumerate(kinds):
        offs[kind] = dataclasses.replace(
            layouts[kind], a_off=i * len(PACK_HEADS_A),
            t_off=i * len(PACK_HEADS_T))
    return pack, offs


def _pad_cols(x, f):
    """Zero-pad feature columns up to a stack's width (inert: padded
    columns carry x_sd = 1 and zero weights)."""
    return F.pad(x, (0, f - x.shape[1])) if x.shape[1] < f else x


def _eval_stack(s, x, off: int, fams):
    """Heads ``off .. off+len(fams)-1`` of stack ``s`` on augmented
    features ``x`` (N, F), each at its family's native cost."""
    n = x.shape[0]
    ys = []
    for j, fam in enumerate(fams):
        i = off + j
        if fam == "mean":
            y = s["b2"][i, 0].expand(n)
        elif fam == "linear":
            xs = (x - s["x_mu"][i]) / s["x_sd"][i]
            y = xs @ s["w0"][i, :, 0] + s["b2"][i, 0]
        else:
            xs = (x - s["x_mu"][i]) / s["x_sd"][i]
            h = torch.relu(xs @ s["w0"][i] + s["b0"][i])
            h = torch.relu(h @ s["w1"][i] + s["b1"][i])
            y = (h @ s["w2"][i])[:, 0] + s["b2"][i, 0]
        ys.append((y * s["y_sd"][i, 0] + s["y_mu"][i, 0]) / s["scale"][i, 0])
    return ys


def _tick_arrays(sA, sT, v, o, t_last, params, changed, x, t, *, circuit,
                 clock_ns, out_eps, spiking, vdd, annotate, known_out,
                 layout):
    """The whole-tick dataflow on raw tensors — the plain version of the
    kernel. Returns ``(v', o', t_last', e, l, o_hat)``; ``o_hat`` (the
    M_O prediction, or ``known_out``) lets a caller find the rows that sit
    at the spike threshold."""
    circ = get_circuit(circuit)
    n = v.shape[0]
    f_a = sA["w0"].shape[1]
    f_t = sT["w0"].shape[1]
    ia, it = layout.a_off, layout.t_off

    # --- idle stage (Algorithm 1 lines 3-9): one merged catch-up event
    stale = changed & (t_last < t - clock_ns)
    tau_idle = torch.clamp_min(t - t_last - clock_ns, 0.0)
    n_idle_heads = 1 if annotate else 2      # annotation never catches up v
    fi = _features(torch.zeros_like(x), v, tau_idle, params)
    ai = _pad_cols(augment_features(circ, fi), f_a)
    ys = _eval_stack(sA, ai, ia, layout.a_fams[:n_idle_heads])
    e_s_idle = ys[0]
    v_hat = v.new_zeros((n,)) if annotate else ys[1]

    # --- active stage (lines 10-22) on the caught-up state
    v_cur = v if annotate else torch.where(stale, v_hat, v)
    tau_act = v.new_full((n,), clock_ns)
    feats = _features(x, v_cur, tau_act, params)
    aug_act = augment_features(circ, feats)
    aa = _pad_cols(aug_act, f_a)
    if annotate:
        (e_s,) = _eval_stack(sA, aa, ia, layout.a_fams[:1])
        o_hat = known_out
        v_new = v_cur                        # caller substitutes behavioral v
    else:
        e_s, v_new, o_hat = _eval_stack(sA, aa, ia, layout.a_fams)

    # --- transition stage (lines 23-29): splice the resolved output in
    out_changed, o_resolved = _resolve_output(
        o_hat, o, out_eps=out_eps, spiking=spiking, vdd=vdd)
    aug_tr = _splice_transition(aug_act, feats.shape[1], o, o_resolved)
    e_d, lat = _eval_stack(sT, _pad_cols(aug_tr, f_t), it, layout.t_fams)

    state = LasanaState(v=v, o=o, t_last=t_last, params=params)
    new_state, e, l, _ = _finish_tick(
        state, changed, stale, e_s_idle, e_d, e_s, lat, out_changed,
        o_hat, v_cur, v_new, t, spiking=spiking, vdd=vdd)
    return new_state.v, new_state.o, new_state.t_last, e, l, o_hat


def megakernel_step(pack, circuit, state, changed, x, t, clock_ns, *,
                    out_eps: float = 0.02, spiking: bool = False,
                    known_out=None, vdd: float = 1.5, layout: PackLayout):
    """One whole LASANA tick through the megakernel path; drop-in for
    ``wrapper.lasana_step`` given a pack. Returns ``(new_state, e, l, o)``."""
    ops.record_dispatch("megakernel_step")
    annotate = known_out is not None
    v, o, tl, e, l = ops.network_tick(
        pack, state.v, state.o, state.t_last, state.params, changed, x, t,
        known_out, circuit=circuit, clock_ns=clock_ns, layout=layout,
        out_eps=out_eps, spiking=spiking, vdd=vdd, annotate=annotate)
    new_state = LasanaState(v=v, o=o, t_last=tl, params=state.params)
    return new_state, e, l, new_state.o


def chunk_plain(pack, circuit, state, changed_seq, x_seq, t_seq, clock_ns,
                *, out_eps: float = 0.02, spiking: bool = True,
                vdd: float = 1.5, layout: PackLayout):
    """T ticks as a loop of the plain tick: ``(new_state, o_seq, e_seq,
    l_seq)``, the sequences ``(T, N)`` (the reference's ``pallas=False``
    body, a ``lax.scan`` of ``megakernel_step``)."""
    os_, es, ls = [], [], []
    for ch, x, t in zip(changed_seq, x_seq, t_seq):
        v, o, tl, e, l, _ = _tick_arrays(
            pack["a"], pack["t"], state.v, state.o, state.t_last,
            state.params, ch, x, t, circuit=circuit, clock_ns=clock_ns,
            out_eps=out_eps, spiking=spiking, vdd=vdd, annotate=False,
            known_out=None, layout=layout)
        state = LasanaState(v=v, o=o, t_last=tl, params=state.params)
        os_.append(o)
        es.append(e)
        ls.append(l)
    n = state.v.shape[0]
    seq = lambda xs: torch.stack(xs) if xs else state.v.new_zeros((0, n))
    return state, seq(os_), seq(es), seq(ls)


def megakernel_chunk(pack, circuit, state, changed_seq, x_seq, t_seq,
                     clock_ns, *, out_eps: float = 0.02, spiking: bool = True,
                     vdd: float = 1.5, layout: PackLayout):
    """A whole chunk of standalone ticks: ``(new_state, o_seq, e_seq,
    l_seq)`` with ``(T, N)`` sequences. ``changed_seq`` (T, N) bool,
    ``x_seq`` (T, N, n_in), ``t_seq`` (T,) tick times."""
    v, o, tl, o_seq, e_seq, l_seq = ops.network_tick_chunk(
        pack, state.v, state.o, state.t_last, state.params, changed_seq,
        x_seq, t_seq, circuit=circuit, clock_ns=clock_ns, layout=layout,
        out_eps=out_eps, spiking=spiking, vdd=vdd)
    return (LasanaState(v=v, o=o, t_last=tl, params=state.params), o_seq,
            e_seq, l_seq)


# --- the CUDA launchers --------------------------------------------------------


class _TickScalars(ctypes.Structure):
    """csrc/network_tick.cu TickScalars, field for field (all 4 bytes)."""

    _fields_ = [("n", ctypes.c_int), ("a_heads", ctypes.c_int),
                ("t_heads", ctypes.c_int), ("f_a", ctypes.c_int),
                ("f_t", ctypes.c_int), ("h1", ctypes.c_int),
                ("h2", ctypes.c_int), ("a_off", ctypes.c_int),
                ("t_off", ctypes.c_int), ("a_fam", ctypes.c_int * 3),
                ("t_fam", ctypes.c_int * 2), ("circuit", ctypes.c_int),
                ("n_in", ctypes.c_int), ("n_p", ctypes.c_int),
                ("spiking", ctypes.c_int), ("annotate", ctypes.c_int),
                ("device", ctypes.c_int), ("clock", ctypes.c_float),
                ("out_eps", ctypes.c_float), ("vdd", ctypes.c_float),
                ("half_vdd", ctypes.c_float), ("v_bias", ctypes.c_float)]


@functools.cache
def _kernel(name: str = "network_tick"):
    lib = _build.library("network_tick")
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(_TickScalars)]
                   + ([ctypes.c_int] if name == "network_tick_chunk"
                      else [ctypes.c_void_p])       # park
                   + [ctypes.c_void_p])
    return lib, fn


@functools.cache
def _park_floats(circuit: str, h1: int, h2: int) -> int:
    """Floats a row of ``network_tick``'s scratch takes for ``circuit``
    rows and hidden widths (h1, h2), as the kernel's own layout rule gives
    them: 8 where the two stacks do not fit in shared memory together (the
    kernel then parks the rows whose output changed between its A and T
    phases), else 0; -1 where it refuses the widths."""
    lib = _build.library("network_tick")
    fn = lib.network_tick_park_floats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn(_CIRCUIT_CODE[circuit], h1, h2)


# one park scratch per (device, stream), grown to the largest N seen:
# launches on one stream run in order, so no tick reads another's rows
_PARK: dict = {}


def _park(dev, stream: int, floats: int):
    buf = _PARK.get((dev.index, stream))
    if buf is None or buf.numel() < floats:
        buf = torch.empty((floats,), dtype=torch.float32, device=dev)
        _PARK[(dev.index, stream)] = buf
    return buf


def _check_pack(kernel, pack, circuit, layout):
    """Validate a pack for ``circuit`` rows; returns the stacks' widths
    ``(p_a, p_t, f_a, f_t, h1, h2)``. :func:`pack_heads` builds no pack
    the kernel refuses; this guards a caller that builds its own."""
    if circuit not in _CIRCUIT_CODE:
        raise ValueError(f"{kernel} kernel: no feature row for circuit "
                         f"{circuit!r}; it takes {sorted(_CIRCUIT_CODE)}")
    sA, sT = pack["a"], pack["t"]
    p_a, f_a, h1 = sA["w0"].shape
    p_t, f_t, _ = sT["w0"].shape
    h2 = sA["w1"].shape[2]
    takes = chunk_takes if kernel == "network_tick_chunk" else kernel_takes
    if not takes(circuit, f_a, f_t, h1, h2):
        fa_row = _row_width(circuit)
        raise ValueError(f"{kernel} kernel refuses {circuit} stacks of F="
                         f"{f_a}/{f_t}, MLP({h1}, {h2}) heads: it takes F >= "
                         f"{fa_row}/{fa_row + 2}, H1 <= {MAX_H1} and heads "
                         "that leave shared memory for a row tile"
                         + (" (LIF rows, both stacks staged together)"
                            if takes is chunk_takes else ""))
    if layout.a_off + len(PACK_HEADS_A) > p_a or \
            layout.t_off + len(PACK_HEADS_T) > p_t:
        raise ValueError(f"{kernel} kernel: offsets {layout.a_off}/"
                         f"{layout.t_off} outside stacks of {p_a}/{p_t} heads")
    for s, p, f in ((sA, p_a, f_a), (sT, p_t, f_t)):
        for k, shape in (("x_mu", (p, f)), ("x_sd", (p, f)), ("y_mu", (p, 1)),
                         ("y_sd", (p, 1)), ("w0", (p, f, h1)),
                         ("b0", (p, h1)), ("w1", (p, h1, h2)),
                         ("b1", (p, h2)), ("w2", (p, h2, 1)), ("b2", (p, 1)),
                         ("scale", (p, 1))):
            ops.check(s[k], k, shape)
    return p_a, p_t, f_a, f_t, h1, h2


def _scalars(n, widths, circuit, layout, *, clock_ns, out_eps, spiking, vdd,
             annotate, dev):
    p_a, p_t, f_a, f_t, h1, h2 = widths
    circ = get_circuit(circuit)
    return _TickScalars(
        n=n, a_heads=p_a, t_heads=p_t, f_a=f_a, f_t=f_t, h1=h1, h2=h2,
        a_off=layout.a_off, t_off=layout.t_off,
        a_fam=(ctypes.c_int * 3)(*(_FAMILY_CODE[f] for f in layout.a_fams)),
        t_fam=(ctypes.c_int * 2)(*(_FAMILY_CODE[f] for f in layout.t_fams)),
        circuit=_CIRCUIT_CODE[circuit], n_in=circ.n_inputs,
        n_p=circ.n_params, spiking=int(spiking), annotate=int(annotate),
        device=dev.index or 0, clock=clock_ns, out_eps=out_eps, vdd=vdd,
        half_vdd=0.5 * vdd, v_bias=getattr(circ, "v_bias", 0.0))


def _stack_ptrs(pack):
    return tuple((ctypes.c_void_p * 11)(*(pack[s][k].data_ptr()
                                          for k in _STACK_KEYS))
                 for s in ("a", "t"))


def _launch(pack, v, o, t_last, params, changed, x, t, known, *, circuit,
            clock_ns, layout, out_eps, spiking, vdd, annotate):
    widths = _check_pack("network_tick", pack, circuit, layout)
    circ = get_circuit(circuit)
    n = v.shape[0]
    if not isinstance(t, torch.Tensor):
        t = v.new_full((), t)
    known_ = known if annotate else None
    io_in = [v, o, t_last, params, changed, x, t] + (
        [known_] if annotate else [])
    dev = ops.same_cuda_device(*io_in, *pack["a"].values(),
                               *pack["t"].values())
    for name, a in (("v", v), ("o", o), ("t_last", t_last)):
        ops.check(a, name, (n,))
    ops.check(params, "params", (n, circ.n_params))
    ops.check(x, "x", (n, circ.n_inputs))
    ops.check(changed, "changed", (n,), dtype=torch.bool)
    ops.check(t, "t", ())
    if annotate:
        ops.check(known_, "known", (n,))
    outs = [torch.empty((n,), dtype=torch.float32, device=dev)
            for _ in range(5)]
    if n:
        lib, fn = _kernel()
        io = (ctypes.c_void_p * 13)(
            v.data_ptr(), o.data_ptr(), t_last.data_ptr(), params.data_ptr(),
            changed.data_ptr(), x.data_ptr(), t.data_ptr(),
            known_.data_ptr() if annotate else None,
            *(a.data_ptr() for a in outs))
        sc = _scalars(n, widths, circuit, layout, clock_ns=clock_ns,
                      out_eps=out_eps, spiking=spiking, vdd=vdd,
                      annotate=annotate, dev=dev)
        per_row = _park_floats(circuit, *widths[4:])
        stream = torch.cuda.current_stream(dev).cuda_stream
        park = _park(dev, stream, n * per_row).data_ptr() if per_row else None
        code = fn(*_stack_ptrs(pack), io, ctypes.byref(sc), park, stream)
        _build.raise_on_error(lib, code, "network_tick")
        ops.count_launch("network_tick")
    return tuple(outs)


def _launch_chunk(pack, v, o, t_last, params, changed_seq, x_seq, t_seq, *,
                  circuit, clock_ns, layout, out_eps, spiking, vdd):
    widths = _check_pack("network_tick_chunk", pack, circuit, layout)
    circ = get_circuit(circuit)
    n = v.shape[0]
    t_steps = changed_seq.shape[0]
    dev = ops.same_cuda_device(v, o, t_last, params, changed_seq, x_seq,
                               t_seq, *pack["a"].values(),
                               *pack["t"].values())
    for name, a in (("v", v), ("o", o), ("t_last", t_last)):
        ops.check(a, name, (n,))
    ops.check(params, "params", (n, circ.n_params))
    ops.check(changed_seq, "changed_seq", (t_steps, n), dtype=torch.bool)
    ops.check(x_seq, "x_seq", (t_steps, n, circ.n_inputs))
    ops.check(t_seq, "t_seq", (t_steps,))
    f32 = dict(dtype=torch.float32, device=dev)
    state = [torch.empty((n,), **f32) for _ in range(3)]
    seqs = [torch.empty((t_steps, n), **f32) for _ in range(3)]
    if n and t_steps:
        lib, fn = _kernel("network_tick_chunk")
        io = (ctypes.c_void_p * 13)(
            v.data_ptr(), o.data_ptr(), t_last.data_ptr(), params.data_ptr(),
            changed_seq.data_ptr(), x_seq.data_ptr(), t_seq.data_ptr(),
            *(a.data_ptr() for a in state + seqs))
        sc = _scalars(n, widths, circuit, layout, clock_ns=clock_ns,
                      out_eps=out_eps, spiking=spiking, vdd=vdd,
                      annotate=False, dev=dev)
        code = fn(*_stack_ptrs(pack), io, ctypes.byref(sc), t_steps,
                  torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on_error(lib, code, "network_tick_chunk")
        ops.count_launch("network_tick_chunk")
    else:
        for dst, src in zip(state, (v, o, t_last)):
            dst.copy_(src)
    return (*state, *seqs)


def network_tick(pack, v, o, t_last, params, changed, x, t, known, *,
                 circuit, clock_ns, layout: PackLayout,
                 out_eps: float = 0.02, spiking: bool = False,
                 vdd: float = 1.5, annotate: bool = False):
    """One whole LASANA tick for N circuits: ``(v', o', t_last', e, l)``,
    each ``(N,)``. ``changed`` is a bool mask, ``t`` this tick's time (a
    0-d float32 tensor on the same device, or a Python float) and
    ``known`` the behavioral outputs in annotation mode (else ignored)."""
    kw = dict(circuit=circuit, clock_ns=clock_ns, out_eps=out_eps,
              spiking=spiking, vdd=vdd, annotate=annotate, layout=layout)
    tensors = (v, o, t_last, params, changed, x)
    if ops.dry_route(*tensors):
        n = v.shape[0]
        ops.record_work("network_tick", work(pack, layout, circuit, n,
                                             x.shape[1], params.shape[1]))
        return tuple(torch.empty((n,), dtype=torch.float32, device="meta")
                     for _ in range(5))
    if all(a.device.type == "cpu" for a in tensors):
        return _tick_arrays(pack["a"], pack["t"], v, o, t_last, params,
                            changed, x, t, known_out=known if annotate
                            else None, **kw)[:5]
    return _launch(pack, v, o, t_last, params, changed, x, t, known, **kw)


def network_tick_chunk(pack, v, o, t_last, params, changed_seq, x_seq, t_seq,
                       *, circuit, clock_ns, layout: PackLayout,
                       out_eps: float = 0.02, spiking: bool = True,
                       vdd: float = 1.5):
    """T standalone ticks in one launch: ``(v', o', t_last', o_seq, e_seq,
    l_seq)``, the sequences ``(T, N)``. ``changed_seq`` (T, N) bool,
    ``x_seq`` (T, N, n_in), ``t_seq`` (T,) float32 tick times. The kernel
    takes the LIF packs :func:`chunk_takes` accepts; its plain version is T
    plain ticks."""
    kw = dict(out_eps=out_eps, spiking=spiking, vdd=vdd, layout=layout)
    tensors = (v, o, t_last, params, changed_seq, x_seq, t_seq)
    if ops.dry_route(*tensors):
        t_steps, n = changed_seq.shape
        ops.record_work("network_tick_chunk",
                        chunk_work(pack, layout, n, t_steps))
        f32 = dict(dtype=torch.float32, device="meta")
        return (*(torch.empty((n,), **f32) for _ in range(3)),
                *(torch.empty((t_steps, n), **f32) for _ in range(3)))
    if all(a.device.type == "cpu" for a in tensors):
        st, o_seq, e_seq, l_seq = chunk_plain(
            pack, circuit, LasanaState(v=v, o=o, t_last=t_last,
                                       params=params),
            changed_seq, x_seq, t_seq, clock_ns, **kw)
        return st.v, st.o, st.t_last, o_seq, e_seq, l_seq
    return _launch_chunk(pack, v, o, t_last, params, changed_seq, x_seq,
                         t_seq, circuit=circuit, clock_ns=clock_ns, **kw)
