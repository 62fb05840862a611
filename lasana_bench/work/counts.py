"""The yardstick's operation and byte counts, and the H100's peaks.

A frozen copy of the port's ``work`` arithmetic (``kernels/
tick_megakernel.py`` ``work``, ``kernels/mlp_surrogate.py``
``head_flops`` / ``heads_work``, as of the port's first benchmark) fed with
the rows these inputs need: the changed, stale and output-changed rows of
each tick. A later change to the program does not move this yardstick.
Heads are described by :func:`head_shapes` from the artifact itself, so
nothing here reads the program's packs.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# circuits' interface widths: inputs, params (the artifacts' circuits)
CIRCUIT_WIDTHS = {"lif": (3, 4), "crossbar": (32, 33)}
PACK_HEADS_A = ("M_ES", "M_V", "M_O")
PACK_HEADS_T = ("M_ED", "M_L")


def row_width(circuit: str) -> int:
    """A feature row: inputs, v, tau, params and the derived column."""
    n_in, n_p = CIRCUIT_WIDTHS[circuit]
    return n_in + 2 + n_p + 1


def mlp_head_flops(f: int, h1: int, h2: int) -> int:
    """One row through one standardized 3-layer head (a multiply-add
    counts 2)."""
    return 2 * f + 2 * (f * h1 + h1 * h2 + h2) + 2 * (h1 + h2) + 4


def head_flops(fam: str, f: int, h1: int, h2: int) -> int:
    """One row through one head of family ``fam`` as the kernels evaluate
    it (mean, linear or MLP)."""
    if fam == "mean":
        return 3
    if fam == "linear":
        return 2 * f + 2 * f + 4
    return mlp_head_flops(f, h1, h2)


def head_shapes(families: dict, arrays: dict) -> dict:
    """``{pname: (family, h1, h2, trees, depth)}`` of an artifact's heads
    (``arrays[pname][key]`` give ``.shape``)."""
    out = {}
    for p, fam in families.items():
        a = arrays[p]
        h1 = a["w0"].shape[1] if fam == "mlp" else 0
        h2 = a["w1"].shape[1] if fam == "mlp" else 0
        trees = a["feat"].shape[0] if fam == "gbdt" else 0
        depth = int(round(math.log2(a["feat"].shape[1] + 1))) \
            if fam == "gbdt" else 0
        out[p] = (fam, h1, h2, trees, depth)
    return out


def _pack_widths(shapes: dict) -> tuple:
    h1 = max([s[1] for s in shapes.values() if s[0] == "mlp"], default=1)
    h2 = max([s[2] for s in shapes.values() if s[0] == "mlp"], default=1)
    return h1, h2


def pack_elems(circuit: str, shapes: dict) -> int:
    """Floats of the tick kernel's two stacks (A: 3 heads at the row's
    width, T: 2 heads two columns wider), every head at the pack's widths:
    x_mu, x_sd, y_mu, y_sd, w0, b0, w1, b1, w2, b2 and the scale."""
    h1, h2 = _pack_widths(shapes)
    per = lambda f: 2 * f + 4 + f * h1 + h1 + h1 * h2 + 2 * h2
    fa = row_width(circuit)
    return len(PACK_HEADS_A) * per(fa) + len(PACK_HEADS_T) * per(fa + 2)


def network_tick(circuit: str, shapes: dict, n: int, rows) -> tuple:
    """``(flops, bytes)`` of one ``network_tick`` over ``n`` rows, ``rows``
    = (changed, stale, output changed): the active heads on each changed
    row, the idle heads (M_ES, M_V) on each stale one and the transition
    heads where the output changed; state, inputs, params, the mask and
    the pack read, the five outputs written."""
    n_in, n_p = CIRCUIT_WIDTHS[circuit]
    h1, h2 = _pack_widths(shapes)
    f = row_width(circuit)
    fa = [head_flops(shapes[p][0], f, h1, h2) for p in PACK_HEADS_A]
    ft = [head_flops(shapes[p][0], f + 2, h1, h2) for p in PACK_HEADS_T]
    n_ch, n_st, n_tr = rows
    flops = n_ch * sum(fa) + n_st * sum(fa[:2]) + n_tr * sum(ft)
    nbytes = (n * (3 * 4 + 4 * (n_in + n_p) + 1) + n * 5 * 4
              + pack_elems(circuit, shapes) * 4)
    return flops, nbytes


def mlp_heads(n: int, f: int, p: int, h1: int, h2: int) -> tuple:
    """``(flops, bytes)`` of one ``mlp_surrogate_heads`` call over ``n``
    rows of width ``f`` and ``p`` stacked heads: rows and arrays read
    once, the (p, n) outputs written once."""
    arrays = p * (2 * f + 3 + f * h1 + h1 + h1 * h2 + 2 * h2)
    return n * p * mlp_head_flops(f, h1, h2), (n * f + arrays + p * n) * 4


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the fp32 peak and the bytes over the HBM peak."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def own_head_flops(shape: tuple, f: int) -> int:
    """One row through one head at its own widths; a GBDT head counts a
    comparison per level and an add per tree."""
    fam, h1, h2, trees, depth = shape
    if fam == "gbdt":
        return trees * (depth + 1)
    return head_flops(fam, f, h1, h2)


def simulate_flops(circuit: str, shapes: dict, rows,
                   drive_flops: int = 0) -> int:
    """What Algorithm 1 needs for one layer and tick, whatever runs it:
    the active heads (M_ES, M_V, M_O) on each changed row, the idle heads
    (M_ES, M_V) on each stale one, the transition heads (M_ED, M_L) where
    the output changed, plus ``drive_flops`` for the layer's synaptic
    products."""
    f = row_width(circuit)
    n_ch, n_st, n_tr = rows
    act = sum(own_head_flops(shapes[p], f) for p in PACK_HEADS_A)
    idle = sum(own_head_flops(shapes[p], f) for p in PACK_HEADS_A[:2])
    tr = sum(own_head_flops(shapes[p], f + 2) for p in PACK_HEADS_T)
    return n_ch * act + n_st * idle + n_tr * tr + drive_flops
