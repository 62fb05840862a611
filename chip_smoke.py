#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one output line each (JSON where it helps):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at a ragged N, and time both on the device
   (CUDA events, median of 25 calls after warm-up);
4. drive the main paths through ``repro_torch.lasana.simulate``, each run
   with the kernel launch counters reset before it and read after it, a
   second (steady) run enqueued with host synchronisation forbidden, and
   its records compared with the JAX reference record committed beside
   the artifacts:
   - the 784-128-10 spiking-MNIST SNN on 100 synthetic digits for 100
     ticks: golden, lasana with a packable and with an unpackable
     surrogate;
   - the ternary 400-120-84-10 crossbar MNIST net on 200 digits as one
     combinational wave (385,200 crossbar rows): golden, lasana packable,
     lasana unpackable;
   - the 144-24-10 crossbar -> LIF net with lateral inhibition on 64
     digits held for 30 ticks: golden, behavioral, lasana with the
     {crossbar, lif} library (one cross-kind head pack);
5. a ``{"kernels": [...]}`` line: per kernel its launches on the main
   paths (summed, and by run), its largest difference from the plain
   version, its time, the plain version's time and its lower bound on
   this card (crossbar-width times of the head kernels beside the LIF
   ones);
6. ``{"ok": true, "device": {...}}`` as the last line.

``--profile`` adds, to each main-path line, the device time by kernel of
one more steady run under ``torch.profiler``.

Any failed phase raises, and the script exits non-zero. It needs CUDA and
the repository's ``src/``; without either it fails before printing a
result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ART = ROOT / "src" / "repro_torch" / "artifacts"
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

N_MAIN = 12800          # layer-1 neurons on the main path (100 x 128)
N_RAGGED = 12837        # not a multiple of any block size
N_XBAR = 312000         # crossbar MNIST layer-1 rows (200 x 120 x 13)
N_XBAR_RAGGED = 312037
N_MIXED_XBAR = 7680     # mixed-net crossbar rows per tick (64 x 24 x 5)
XBAR_IMAGES = 200
MIXED_IMAGES = 64
MIXED_TICKS = 30
LIF_KNOBS = (0.58, 0.5, 0.5, 0.5)   # examples/snn_mnist.py's per-layer knobs
RTOL = 1e-5
REPS = 25
BUSY_CYCLES = 100_000_000   # ~50 ms of spinning at the H100's clocks
T_STEPS = 100
N_IMAGES = 100
# ULPs of 0.5 * vdd within which a spike may flip: M_O's kernel and plain
# outputs differ by up to ~1e-6 (~17 ULPs at 0.75 V), summed in two orders
HALF_VDD_BAND = 64
# absolute band around a crossbar threshold (|o_hat - o| = out_eps, the
# settle test, |v_end - v0| = 0.02) within which kernel and plain version
# may decide differently: values reach 2 V (ULP 2.4e-7), and a head's dot
# products differ by up to ~1e-6 between the two summation orders
XBAR_BAND = 1e-5


def fail(msg: str):
    raise RuntimeError(msg)


def line(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def time_ms(fn, torch) -> float:
    """Median device time of REPS calls of ``fn``, each between two CUDA
    events, after warm-up. A spin kernel ahead of the start event keeps
    the stream busy while the host enqueues the call, so the events time
    the device's work and not the host's (a call that enqueues more
    launches than the stream's queue holds still shows some host time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BUSY_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(got, want, name, mask=None):
    """rtol 1e-5 with an atol at 1e-5 of the field's scale; returns the
    largest absolute difference. ``mask`` selects the rows compared.

    The kernels sum each dot product in index order with fused
    multiply-adds, the plain versions in cuBLAS's blocked order, so a head
    output that cancels to near zero differs by the rounding of its
    unit-scale partial sums (~1e-6), not by 1e-5 of itself; the
    reference's own kernel tests allow atol 1e-5 at unit scale for the
    same reason (tests/test_kernels.py)."""
    import numpy as np
    g = got.detach().double().cpu().numpy()
    w = want.detach().double().cpu().numpy()
    if mask is not None:
        g, w = g[mask], w[mask]
    err = np.abs(g - w)
    atol = 1e-5 * float(np.max(np.abs(w), initial=0.0))
    bad = err > atol + RTOL * np.abs(w)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} values off by more than rtol "
             f"{RTOL} (max abs err {err.max():.3e})")
    return float(err.max(initial=0.0))


def bound_ms(n_bytes: float, n_flops: float):
    """The least time the card could take: the larger of bytes over the
    memory rate and fp32 operations over the fp32 peak."""
    t_b, t_f = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# --- operation counts (fp32; a fused multiply-add counts 2) ---------------

# one LIF substep (lif_step.cu loop body): update 2, clamp 2, threshold 2,
# compare 1, refractory 2, adaptation 2, t_now 1, static energy 2+1+3,
# integration energy 5, accumulate 2
LIF_FLOPS_PER_SUBSTEP = 27
LIF_FLOPS_SETUP = 25


def mlp_head_flops(f, h1, h2):
    """Standardize, three layers with bias and relu, destandardize."""
    return 2 * f + 2 * (f * h1 + h1 * h2 + h2) + 2 * (h1 + h2) + 4


def head_flops(fam, f, h1, h2):
    if fam == "mean":
        return 3
    if fam == "linear":
        return 2 * f + 2 * f + 4
    return mlp_head_flops(f, h1, h2)


# --- phase 3: each kernel against its plain version -------------------------

def check_lif(torch, np, dev):
    from repro_torch.core.circuits import LIFNeuron
    from repro_torch.kernels import lif_scan
    circ = LIFNeuron()
    out = {"shape": f"state ({N_MAIN}, 3), x ({N_MAIN}, 3), "
                    f"params ({N_MAIN}, 4)", "max_abs_err": 0.0}
    for n in (N_MAIN, N_RAGGED):
        rng = np.random.default_rng(n)
        state = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 0.3, n),
                          rng.uniform(0, 3, n) * (rng.random(n) < 0.3)], 1)
        x = np.stack([rng.uniform(-1, 1, n), np.full(n, 1.5),
                      np.full(n, 5.0)], 1)
        params = rng.uniform(0.5, 0.8, (n, 4))
        args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (state, x, params)]
        new_state, obs = lif_scan.lif_step(*args, circ=circ)
        got = (new_state, obs["output"], obs["energy"], obs["latency"],
               obs["spiked"])
        want = lif_scan._period_math(circ, *args)
        torch.cuda.synchronize()
        if not torch.equal(got[4], want[4]):
            fail(f"lif_step n={n}: spiked differs on "
                 f"{int((got[4] != want[4]).sum())} neurons")
        for name, g, w in zip(("state", "output", "energy", "latency"),
                              got[:4], want[:4]):
            out["max_abs_err"] = max(out["max_abs_err"],
                                     compare(g, w, f"lif_step {name}"))
        if n == N_MAIN:
            out["spiking_share"] = float(got[4].float().mean())
            out["ms"] = time_ms(lambda: lif_scan.lif_step(*args, circ=circ),
                                torch)
            out["plain_ms"] = time_ms(
                lambda: lif_scan._period_math(circ, *args), torch)
            n_bytes = n * (3 + 3 + 4) * 4 + n * (3 + 3) * 4 + n
            flops = n * (LIF_FLOPS_SETUP
                         + circ.n_substeps * LIF_FLOPS_PER_SUBSTEP)
            out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, flops)
    return out


# one crossbar row (crossbar_step.cu): target 4 per input + 8, resistive
# power 6 per input, one exp and a division; each substep 14 (update 3,
# capacitor power 5, energy 4, settle test 2)
XBAR_FLOPS_PER_INPUT = 10
XBAR_FLOPS_SETUP = 20
XBAR_FLOPS_PER_SUBSTEP = 14


def xbar_rows(np, n, seed):
    """Crossbar rows as the engine drives them: DAC volts (70% analog
    levels, 30% full-swing digital), ternary weights with a zero bias
    column, previous outputs in [-2, 2] V."""
    rng = np.random.default_rng(seed)
    uni = rng.uniform(-0.8, 0.8, (n, 32))
    dig = rng.integers(-1, 2, (n, 32)) * 0.8
    v = np.where(rng.random((n, 1)) < 0.3, dig, uni)
    w = np.concatenate([rng.integers(-1, 2, (n, 32)), np.zeros((n, 1))], 1)
    state = rng.uniform(-2, 2, (n, 1))
    return v, w, state


def settle_margin(torch, circ, state, v, w):
    """Per row, the least distance over the substeps between |v - v_tgt|
    and the 90% settling band, and |v_end - v0| from 0.02: how far each
    discrete decision of ``CrossbarRow.step`` sits from its threshold."""
    from repro_torch.kernels import crossbar_mvm
    v_tgt, tau = crossbar_mvm.target_plain(circ, v, w)
    dt = circ.clock_ns / circ.n_substeps
    a = torch.exp(tau.new_full((), -dt) / tau)
    v0 = state[:, 0]
    band = 0.1 * torch.abs(v_tgt - v0) + 1e-6
    vv, margin = v0, torch.full_like(v0, float("inf"))
    for _ in range(circ.n_substeps):
        vv = v_tgt + (vv - v_tgt) * a
        margin = torch.minimum(margin, torch.abs(torch.abs(vv - v_tgt) - band))
    return margin, torch.abs(torch.abs(vv - v0) - 0.02)


def check_crossbar(torch, np, dev):
    """Both entry points of crossbar_step.cu against their plain versions
    at the crossbar MNIST layer-1 rows and at a ragged N; the fused period
    (the golden backend's launch) is timed."""
    from repro_torch.core.circuits import CrossbarRow
    from repro_torch.kernels import crossbar_mvm
    circ = CrossbarRow()
    out = {"shape": f"v ({N_XBAR}, 32), w ({N_XBAR}, 33), state "
                    f"({N_XBAR}, 1): the fused period", "max_abs_err": 0.0,
           "threshold_rows": 0}
    for n in (N_XBAR, N_XBAR_RAGGED):
        v, w, state = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                       for a in xbar_rows(np, n, n))
        tag = f"crossbar_target n={n}"
        got = crossbar_mvm.crossbar_target(v, w, circ=circ)
        want = crossbar_mvm.target_plain(circ, v, w)
        new_state, obs = crossbar_mvm.crossbar_step(state, v, w, circ=circ)
        plain = crossbar_mvm.step_plain(circ, state, v, w)
        torch.cuda.synchronize()
        for name, g, p in (("v_tgt", got[0], want[0]), ("tau", got[1],
                                                         want[1])):
            out["max_abs_err"] = max(out["max_abs_err"],
                                     compare(g, p, f"{tag} {name}"))
        margin, spike_margin = settle_margin(torch, circ, state, v, w)
        flip = (obs["spiked"] != plain[4]) | (obs["latency"] != plain[3])
        near = (margin <= XBAR_BAND) | (spike_margin <= XBAR_BAND)
        if (flip & ~near).any():
            fail(f"{tag} step: spiked or t90 differs on "
                 f"{int((flip & ~near).sum())} rows away from a threshold")
        out["threshold_rows"] += int(flip.sum())
        keep = (~flip).cpu().numpy()
        for name, g, p in (("state", new_state[:, 0], plain[1]),
                           ("energy", obs["energy"], plain[2])):
            out["max_abs_err"] = max(out["max_abs_err"], compare(
                g, p, f"{tag} step {name}", mask=keep))
        if n == N_XBAR:
            out["spiked_share"] = float(obs["spiked"].float().mean())
            out["ms"] = time_ms(
                lambda: crossbar_mvm.crossbar_step(state, v, w, circ=circ),
                torch)
            out["plain_ms"] = time_ms(
                lambda: crossbar_mvm.step_plain(circ, state, v, w), torch)
            out["target_ms"] = time_ms(
                lambda: crossbar_mvm.crossbar_target(v, w, circ=circ), torch)
            out["target_plain_ms"] = time_ms(
                lambda: crossbar_mvm.target_plain(circ, v, w), torch)
            n_bytes = n * (32 + 33 + 1) * 4 + n * (3 * 4 + 1)
            flops = n * (XBAR_FLOPS_SETUP + 32 * XBAR_FLOPS_PER_INPUT
                         + circ.n_substeps * XBAR_FLOPS_PER_SUBSTEP)
            out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, flops)
            out["target_bound_ms"] = bound_ms(
                n * (32 + 33) * 4 + n * 8, n * (4 * 32 + 8))[0]
    return out


def check_mlp_heads(torch, np, dev, unpackables):
    """The stacked groups the unpackable artifacts launch on the main
    paths: (M_O, M_V) at the active width and (M_ED, M_L) at the
    transition width, for LIF rows (F = 10/12, N = 12,800: the timed
    entry) and crossbar rows (F = 68/70, N = 312,000: ``crossbar``)."""
    from repro_torch.kernels import mlp_surrogate
    keys = ("x_mu", "x_sd", "y_mu", "y_sd", "w0", "b0", "w1", "b1", "w2",
            "b2")
    res = {}
    for kind, (sur, sizes) in unpackables.items():
        out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
        flops = n_bytes = 0.0
        shapes = []
        for pnames in (("M_O", "M_V"), ("M_ED", "M_L")):
            s = sur._stacked(pnames)
            stacks = [s[k] for k in keys]
            p, f, h1 = s["w0"].shape
            h2 = s["w1"].shape[2]
            for n in sizes:
                x = torch.as_tensor(np.random.default_rng(n + f).normal(
                    0, 1, (n, f)), dtype=torch.float32, device=dev)
                got = mlp_surrogate.mlp_surrogate_heads(x, *stacks)
                want = mlp_surrogate.mlp_heads_plain(x, *stacks)
                torch.cuda.synchronize()
                out["max_abs_err"] = max(out["max_abs_err"], compare(
                    got, want, f"mlp_surrogate_heads {kind} {pnames} n={n}"))
                if n != sizes[0]:
                    continue
                shapes.append(f"x ({n}, {f}), P={p}, H1={h1}, H2={h2}")
                out["ms"] += time_ms(
                    lambda: mlp_surrogate.mlp_surrogate_heads(x, *stacks),
                    torch)
                out["plain_ms"] += time_ms(
                    lambda: mlp_surrogate.mlp_heads_plain(x, *stacks), torch)
                flops += n * p * mlp_head_flops(f, h1, h2)
                n_bytes += (n * f + sum(a.numel() for a in stacks)
                            + p * n) * 4
        out["shape"] = "; ".join(shapes) + " (one launch each, times summed)"
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, flops)
        res[kind] = out
    lif = res.pop("lif")
    lif["max_abs_err"] = max(lif["max_abs_err"],
                             res["crossbar"].pop("max_abs_err"))
    return {**lif, **res}


def mean_linear_surrogate(np, dev):
    """A packable LIF surrogate of mean and linear heads with random
    weights from a seed, so the kernel's native-cost mean and linear
    paths run on the card too (the trained artifacts are linear + MLP)."""
    from repro_torch.convert import surrogate_from_numpy
    from repro_torch.core.surrogate import FORMAT_VERSION
    rng = np.random.default_rng(11)
    fams = {"M_ES": "mean", "M_V": "linear", "M_O": "linear",
            "M_ED": "linear", "M_L": "mean"}
    arrays = {}
    for p, fam in fams.items():
        f = 12 if p in ("M_ED", "M_L") else 10      # transition / active
        arrays[p] = ({"mu": np.asarray(rng.uniform(0.5, 2.0), np.float32)}
                     if fam == "mean" else
                     {"w": rng.normal(0, 0.5, f + 1).astype(np.float32),
                      "mu": rng.normal(0, 0.3, f).astype(np.float32),
                      "sd": rng.uniform(0.5, 2.0, f).astype(np.float32)})
    meta = {"format_version": FORMAT_VERSION, "circuit": "lif",
            "families": fams, "scales": {p: 1.0 for p in fams},
            "features": [], "fit_info": None}
    return surrogate_from_numpy(meta, arrays, dev)


def tick_inputs(torch, np, dev, n, seed, vdd):
    """One tick's inputs on the card: (v, o, t_last, params, changed, x,
    known); the first block of 128 rows has no event."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    changed = rng.random(n) < 0.7
    changed[:128] = False
    return (f32(rng.uniform(0, 1, n)), f32((rng.random(n) < 0.3) * vdd),
            f32(rng.choice([0.0, 20.0, 25.0], n)),
            f32(rng.uniform(0.5, 0.8, (n, 4))),
            torch.as_tensor(changed, device=dev),
            f32(np.stack([rng.uniform(-1, 1, n), np.full(n, 1.5),
                          np.full(n, 5.0)], 1)),
            f32((rng.random(n) < 0.4) * vdd))


def xbar_tick_inputs(torch, np, dev, n, seed):
    """One crossbar tick's inputs on the card, as ``tick_inputs``: DAC
    volts, ternary row weights, outputs in [-2, 2] V; the first block of
    128 rows has no event."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    changed = rng.random(n) < 0.7
    changed[:128] = False
    v, w, _ = xbar_rows(np, n, seed)
    return (f32(rng.uniform(-2, 2, n)), f32(rng.uniform(-2, 2, n)),
            f32(rng.choice([0.0, 20.0, 24.0], n)), f32(w),
            torch.as_tensor(changed, device=dev), f32(v),
            f32(rng.uniform(-2, 2, n)))


def tick_case(torch, np, dev, circuit, n, seed):
    """(inputs, t, clock, kwargs) of one network_tick check."""
    if circuit == "lif":
        vdd, clock, t_now = 1.5, 5.0, 30.0
        ins = tick_inputs(torch, np, dev, n, seed, vdd)
        kw = dict(spiking=True, vdd=vdd)
    else:
        clock, t_now = 4.0, 28.0
        ins = xbar_tick_inputs(torch, np, dev, n, seed)
        kw = dict(spiking=False, vdd=1.5)
    return ins, torch.full((), t_now, device=dev), clock, kw


def check_network_tick(torch, np, dev, cases):
    """Standalone and annotation ticks for each ``(label, circuit, pack,
    layout, sizes, timed_as)`` case: the trained packable artifacts
    (timed at the first size), a mean/linear pack, and both kinds of a
    unified {crossbar, lif} pack, whose lif heads sit at nonzero offsets."""
    from repro_torch.kernels import tick_megakernel as mk
    out = {"max_abs_err": 0.0, "threshold_rows": 0}
    ulp = float(np.spacing(np.float32(0.75)))
    for label, circuit, pk, ly, sizes, timed_as in cases:
        p_a, f_a, h1 = pk["a"]["w0"].shape
        p_t, f_t, _ = pk["t"]["w0"].shape
        h2 = pk["a"]["w1"].shape[2]
        for annotate in (False, True):
            for n in sizes:
                ins, t, clock, ckw = tick_case(torch, np, dev, circuit, n,
                                               n + annotate)
                v, o, t_last, params, ch, x, known = ins
                kw = dict(circuit=circuit, clock_ns=clock, layout=ly,
                          out_eps=0.02, annotate=annotate, **ckw)
                args = (pk, v, o, t_last, params, ch, x, t, known)
                tag = f"network_tick {label} n={n} annotate={annotate}"
                got = mk.network_tick(*args, **kw)
                *want, o_hat = mk._tick_arrays(
                    pk["a"], pk["t"], v, o, t_last, params, ch, x, t,
                    known_out=known if annotate else None, **kw)
                torch.cuda.synchronize()
                if circuit == "lif":
                    # spikes resolve at 0.5 * vdd
                    flip = (got[1] != want[1]).cpu().numpy()
                    near = (torch.abs(o_hat - 0.75) <= HALF_VDD_BAND * ulp
                            ).cpu().numpy()
                else:
                    # an event where |o_hat - o| > out_eps: its class
                    # shows in which energy head was read
                    ev_g = ch & (torch.abs(got[1] - o) > 0.02)
                    ev_w = ch & (torch.abs(want[1] - o) > 0.02)
                    flip = (ev_g != ev_w).cpu().numpy()
                    near = (torch.abs(torch.abs(o_hat - o) - 0.02)
                            <= XBAR_BAND).cpu().numpy()
                    out["max_abs_err"] = max(out["max_abs_err"], compare(
                        got[1], want[1], f"{tag} o"))
                if (flip & ~near).any():
                    fail(f"{tag}: output event differs on "
                         f"{int((flip & ~near).sum())} rows away from its "
                         "threshold")
                out["threshold_rows"] += int(flip.sum())
                if not torch.equal(got[2], want[2]):
                    fail(f"{tag}: t_last differs")
                for name, g, w in zip(("v", "e", "l"),
                                      (got[0], got[3], got[4]),
                                      (want[0], want[3], want[4])):
                    out["max_abs_err"] = max(out["max_abs_err"], compare(
                        g, w, f"{tag} {name}", mask=~flip))
                if timed_as is None or n != sizes[0] or annotate:
                    continue
                res = {"shape": f"N={n}, {circuit} rows, A stack "
                                f"{p_a}x({f_a},{h1},{h2}), T stack "
                                f"{p_t}x({f_t},{h1},{h2})"}
                res["ms"] = time_ms(lambda: mk.network_tick(*args, **kw),
                                    torch)
                res["plain_ms"] = time_ms(lambda: mk._tick_arrays(
                    pk["a"], pk["t"], v, o, t_last, params, ch, x, t,
                    known_out=None, **kw), torch)
                # the work this data needs: active heads on changed rows,
                # idle heads on stale ones, transition heads where the
                # output changed; idle rows are copied through
                stale = ch & (t_last < float(t) - clock)
                if circuit == "lif":
                    fired = ch & (o_hat > 0.75)
                else:
                    fired = ch & (torch.abs(o_hat - o) > 0.02)
                n_ch, n_st, n_tr = (int(m.sum()) for m in (ch, stale, fired))
                f_row = x.shape[1] + 2 + params.shape[1] + 1
                fa = [head_flops(fm, f_row, h1, h2) for fm in ly.a_fams]
                ft = [head_flops(fm, f_row + 2, h1, h2) for fm in ly.t_fams]
                flops = n_ch * sum(fa) + n_st * sum(fa[:2]) \
                    + n_tr * sum(ft)
                weights = sum(a.numel() for s in pk.values()
                              for a in s.values())
                n_bytes = n * (3 * 4 + 4 * (x.shape[1] + params.shape[1])
                               + 1) + n * 5 * 4 + weights * 4
                res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, flops)
                res["rows"] = {"changed": n_ch, "stale": n_st,
                               "output_changed": n_tr}
                if timed_as == "lif":
                    out.update(res)
                else:
                    out[timed_as] = res
    return out


# --- phase 4: the main path -------------------------------------------------

def profile_run(torch, eng, x, surrogates) -> dict:
    """Device time by kernel over one more steady run (``torch.profiler``):
    the device's busy and idle share of the run's wall time (the profiler
    adds host time of its own) and the five kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.dispatch(x, surrogates=surrogates).result()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, fills): a host op's
        # own entry carries its kernels' time again
        us = getattr(ev, "self_device_time_total", 0)
        if ev.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, ev.key[:60], ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top": [{"kernel": k, "ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:5]]}


def drive(torch, spec, x, kw, profile):
    """One main-path run through ``lasana.simulate`` with the launch
    counters reset just before it and read just after it, then a steady
    run of the same engine enqueued with host syncs forbidden. Returns
    (first run, launch counts, the line's common fields)."""
    import repro_torch.lasana as lasana
    from repro_torch.kernels import ops
    ops.reset_launches()
    run = lasana.simulate(spec, x, **kw)
    counts = dict(ops.LAUNCHES)
    eng = lasana.engine(spec, **{k: v for k, v in kw.items()
                                 if k != "surrogates"})
    # steady state: the whole tick loop enqueued with host syncs
    # forbidden; any synchronising call in it raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = eng.dispatch(x, surrogates=kw.get("surrogates"))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rep = pending.result().report()["network"]
    res = {"phase": "main_path", "launches": counts,
           "wall_s": rep["wall_seconds"],
           "events_per_s": rep["events_per_sec"], "events": rep["events"],
           "sync_debug_mode": "error"}
    if profile:
        res["profile"] = profile_run(torch, eng, x, kw.get("surrogates"))
    return run, counts, res


def energy_diff(np, run, rec, key):
    """Total energy (ticks + flush) of the port's run and its relative
    difference from the reference record's."""
    e_port = float(run.energy.sum() + run.flush_energy.sum())
    e_ref = float(rec[f"{key}/energy"].sum() + rec[f"{key}/flush_energy"].sum())
    return e_port, abs(e_port - e_ref) / max(abs(e_ref), 1e-30)


def check_launches(name, counts, want):
    """``want``: kernel -> exact count, or (">=", count)."""
    for kernel, n in want.items():
        got = counts[kernel]
        ok = got >= n[1] if isinstance(n, tuple) else got == n
        if not ok:
            fail(f"{name}: {kernel} launched {got} times, expected {n}")


def snn_runs(torch, np, dev, surs, profile):
    """The 784-128-10 SNN, 100 digits x 100 ticks (slice 1's main path)."""
    from repro_torch.convert import spec_from_numpy
    from repro_torch.data.mnist import make_digits, poisson_encode
    with np.load(ART / "snn_784_128_10.npz") as z:
        ws = [z["w0"], z["w1"]]
    knobs = [np.array(LIF_KNOBS, np.float32)] * 2
    spec = spec_from_numpy(ws, knobs)
    imgs, labels = make_digits(N_IMAGES, size=28, seed=777)
    x = torch.as_tensor(poisson_encode(imgs, T_STEPS, seed=5) * 1.5,
                        dtype=torch.float32, device=dev)
    rec = dict(np.load(ART / "snn_ref_record.npz"))
    total = {}
    runs = (("golden", dict(backend="golden"), {"lif_step": 2 * T_STEPS}),
            ("lasana", dict(surrogates=surs["lif"]),
             {"network_tick": 2 * T_STEPS}),
            ("lasana_unpackable", dict(surrogates=surs["lif_unpackable"]),
             {"mlp_surrogate_heads": (">=", T_STEPS)}))
    for name, kw, want in runs:
        run, counts, res = drive(torch, spec, x, kw, profile)
        check_launches(f"snn {name}", counts, want)
        spikes = (run.out_spikes > 0.75).astype(np.uint8)
        agree = float(np.mean(spikes == rec[f"{name}/out_spikes"]))
        e_port, e_diff = energy_diff(np, run, rec, name)
        if not np.isfinite(run.energy).all() or run.outputs.shape != (
                N_IMAGES, 10):
            fail(f"snn {name}: non-finite energy or outputs of shape "
                 f"{run.outputs.shape}")
        line({**res, "workload": "snn_784_128_10", "run": name,
              "accuracy": float(np.mean(np.argmax(run.outputs, -1)
                                        == labels)),
              "spike_agreement_vs_ref": agree, "energy_j": e_port,
              "energy_rel_diff_vs_ref": e_diff})
        if agree < 0.99 or e_diff > 0.01:
            fail(f"snn {name}: spike agreement {agree:.4f} (< 0.99) or "
                 f"energy difference {e_diff:.4%} (> 1%) against the "
                 "reference")
        add_counts(total, f"snn/{name}", counts)
    return total


def xbar_runs(torch, np, dev, surs, profile):
    """The ternary 400-120-84-10 crossbar MNIST net, 200 digits as one
    combinational wave of DAC volts."""
    from repro_torch.convert import crossbar_spec_from_numpy
    from repro_torch.core.circuits import CrossbarRow
    from repro_torch.data.mnist import make_digits
    with np.load(ART / "xbar_400_120_84_10.npz") as z:
        ws = [z[f"w{i}"].astype(np.float32) for i in range(3)]
    spec = crossbar_spec_from_numpy(ws)
    imgs, labels = make_digits(XBAR_IMAGES, size=20, seed=999)
    x = torch.as_tensor(imgs * 1.6 - 0.8, dtype=torch.float32, device=dev)
    rec = dict(np.load(ART / "xbar_ref_record.npz"))
    circ = CrossbarRow()
    # one ADC step of a row, in the output's gain-compensated units: two
    # outputs whose codes agree differ by float rounding only
    step = 2 * circ.v_sat / 255 / (circ.r_f * circ.g_unit)
    n_layers = len(ws)
    total = {}
    runs = (("golden", dict(backend="golden"),
             {"crossbar_target": n_layers}),
            ("lasana", dict(surrogates=surs["crossbar"]),
             {"network_tick": n_layers}),
            ("lasana_unpackable", dict(surrogates=surs["crossbar_unpackable"]),
             {"mlp_surrogate_heads": 2 * n_layers}))
    for name, kw, want in runs:
        run, counts, res = drive(torch, spec, x, kw, profile)
        check_launches(f"xbar {name}", counts, want)
        ref = rec[f"{name}/outputs"]
        if not np.isfinite(run.outputs).all() or run.outputs.shape != (
                XBAR_IMAGES, 10) or not np.isfinite(run.energy).all():
            fail(f"xbar {name}: non-finite records or outputs of shape "
                 f"{run.outputs.shape}")
        codes = float(np.mean(np.abs(run.outputs - ref) < 0.5 * step))
        argmax = float(np.mean(np.argmax(run.outputs, -1)
                               == np.argmax(ref, -1)))
        e_port, e_diff = energy_diff(np, run, rec, name)
        line({**res, "workload": "xbar_400_120_84_10", "run": name,
              "accuracy": float(np.mean(np.argmax(run.outputs, -1)
                                        == labels)),
              "argmax_agreement_vs_ref": argmax,
              "code_agreement_vs_ref": codes,
              "events_equal_ref": bool(np.array_equal(
                  run.events, rec[f"{name}/events"])),
              "energy_j": e_port, "energy_rel_diff_vs_ref": e_diff})
        if argmax < 0.99 or codes < 0.99 or e_diff > 0.01:
            fail(f"xbar {name}: argmax agreement {argmax:.4f}, code "
                 f"agreement {codes:.4f} (< 0.99) or energy difference "
                 f"{e_diff:.4%} (> 1%) against the reference")
        add_counts(total, f"xbar/{name}", counts)
    return total


def mixed_runs(torch, np, dev, surs, profile):
    """The 144-24-10 crossbar -> LIF net with lateral inhibition, 64
    digits held for 30 ticks."""
    from repro_torch.convert import graph_spec_from_numpy
    from repro_torch.core.surrogate import SurrogateLibrary
    from repro_torch.data.mnist import make_digits
    with np.load(ART / "mixed_144_24_10.npz") as z:
        w1, w2 = z["w1"].astype(np.float32), z["w2"].astype(np.float32)
    inhib = -0.4 * (1.0 - np.eye(10, dtype=np.float32))
    spec = graph_spec_from_numpy(
        [{"circuit": "crossbar", "weight": w1},
         {"circuit": "lif", "weight": w2, "params": LIF_KNOBS}],
        edges=[(1, 1, inhib)])
    imgs, labels = make_digits(MIXED_IMAGES, size=12, seed=777)
    volts = torch.as_tensor(imgs * 1.6 - 0.8, dtype=torch.float32,
                            device=dev)
    x = volts[None].expand(MIXED_TICKS, *volts.shape).contiguous()
    rec = dict(np.load(ART / "mixed_ref_record.npz"))
    library = SurrogateLibrary({"crossbar": surs["crossbar"],
                                "lif": surs["lif"]})
    total = {}
    runs = (("golden", dict(backend="golden"),
             {"crossbar_target": MIXED_TICKS, "lif_step": MIXED_TICKS}),
            ("behavioral", dict(backend="behavioral"),
             {"crossbar_target": MIXED_TICKS}),
            ("lasana", dict(surrogates=library),
             {"network_tick": 2 * MIXED_TICKS}))
    for name, kw, want in runs:
        run, counts, res = drive(torch, spec, x, kw, profile)
        check_launches(f"mixed {name}", counts, want)
        spikes = (run.out_spikes > 0.75).astype(np.uint8)
        agree = float(np.mean(spikes == rec[f"{name}/out_spikes"]))
        e_port, e_diff = energy_diff(np, run, rec, name)
        if not np.isfinite(run.energy).all() or run.outputs.shape != (
                MIXED_IMAGES, 10):
            fail(f"mixed {name}: non-finite energy or outputs of shape "
                 f"{run.outputs.shape}")
        line({**res, "workload": "mixed_144_24_10", "run": name,
              "accuracy": float(np.mean(np.argmax(run.outputs, -1)
                                        == labels)),
              "spike_agreement_vs_ref": agree, "energy_j": e_port,
              "energy_rel_diff_vs_ref": e_diff})
        if agree < 0.99 or (name != "behavioral" and e_diff > 0.01):
            fail(f"mixed {name}: spike agreement {agree:.4f} (< 0.99) or "
                 f"energy difference {e_diff:.4%} (> 1%) against the "
                 "reference")
        add_counts(total, f"mixed/{name}", counts)
    return total


def add_counts(total, run_name, counts):
    """Fold one run's launch counts into ``{kernel: {run: n}}``."""
    for kernel, n in counts.items():
        if n:
            total.setdefault(kernel, {})[run_name] = n


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one steady run of each main-path "
                         "simulation and print device time by kernel")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core.surrogate import SurrogateLibrary
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import tick_megakernel as mk
    from repro_torch.lasana import load

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    line(smi)
    dev = ops.resolve_device("cuda")
    line({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})

    secs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.SOURCES}
    line({"phase": "build", "seconds": secs, "ptxas": ptxas})

    surs = {name: load(str(ART / f"{file}.npz")) for name, file in (
        ("lif", "lif_packable"), ("lif_unpackable", "lif_unpackable"),
        ("crossbar", "crossbar_packable"),
        ("crossbar_unpackable", "crossbar_unpackable"))}
    lib_pack, lib_layouts = mk.pack_library(SurrogateLibrary(
        {"crossbar": surs["crossbar"], "lif": surs["lif"]}))
    tick_cases = [
        ("lif packable", "lif", *mk.pack_heads(surs["lif"]),
         (N_MAIN, N_RAGGED), "lif"),
        ("lif mean_linear", "lif",
         *mk.pack_heads(mean_linear_surrogate(np, dev)),
         (N_MAIN, N_RAGGED), None),
        ("crossbar packable", "crossbar", *mk.pack_heads(surs["crossbar"]),
         (N_XBAR, N_XBAR_RAGGED), "crossbar"),
        ("lif in {crossbar, lif}", "lif", lib_pack, lib_layouts["lif"],
         (N_MAIN, N_RAGGED), None),
        ("crossbar in {crossbar, lif}", "crossbar", lib_pack,
         lib_layouts["crossbar"], (N_MIXED_XBAR, N_MIXED_XBAR + 19),
         "crossbar_in_unified_pack"),
    ]
    checks = {
        "crossbar_target": check_crossbar(torch, np, dev),
        "lif_step": check_lif(torch, np, dev),
        "mlp_surrogate_heads": check_mlp_heads(torch, np, dev, {
            "lif": (surs["lif_unpackable"], (N_MAIN, N_RAGGED)),
            "crossbar": (surs["crossbar_unpackable"],
                         (N_XBAR, N_XBAR_RAGGED))}),
        "network_tick": check_network_tick(torch, np, dev, tick_cases),
    }
    for name, c in checks.items():
        line({"phase": "kernel_check", "kernel": name, **c})

    launches = {}
    for runs in (snn_runs, xbar_runs, mixed_runs):
        for kernel, by_run in runs(torch, np, dev, surs,
                                   args.profile).items():
            launches.setdefault(kernel, {}).update(by_run)

    meta = {
        "crossbar_target": ("src/repro_torch/kernels/csrc/crossbar_step.cu",
                            "src/repro/kernels/crossbar_mvm.py:35"),
        "lif_step": ("src/repro_torch/kernels/csrc/lif_step.cu",
                     "src/repro/kernels/lif_scan.py:154"),
        "mlp_surrogate_heads": ("src/repro_torch/kernels/csrc/mlp_heads.cu",
                                "src/repro/kernels/mlp_surrogate.py:89"),
        "network_tick": ("src/repro_torch/kernels/csrc/network_tick.cu",
                         "src/repro/kernels/tick_megakernel.py:508"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        c = checks[name]
        by_run = launches.get(name, {})
        if not by_run:
            fail(f"{name}: no main-path run launched it")
        extra = {k: v for k, v in c.items()
                 if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by")}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_run.values()),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None,
            "launches_by_run": by_run, **extra})
    line({"kernels": kernels})
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
