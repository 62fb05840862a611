#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one output line each (JSON where it helps):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at a ragged N, and time both on the device
   (CUDA events, median of 25 calls after warm-up);
4. drive the main path — the 784-128-10 spiking-MNIST SNN on 100 synthetic
   digits for 100 ticks — through ``repro_torch.lasana.simulate`` on the
   golden backend and on the lasana backend with a packable and an
   unpackable surrogate, with the kernel launch counters reset before
   each run and read after it, a second (steady) run enqueued with host
   synchronisation forbidden, and compare the records with the JAX
   reference record committed beside the artifacts;
5. a ``{"kernels": [...]}`` line: per kernel its launches on the main
   path, its largest difference from the plain version, its time, the
   plain version's time and its lower bound on this card;
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
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

N_MAIN = 12800          # layer-1 neurons on the main path (100 x 128)
N_RAGGED = 12837        # not a multiple of any block size
RTOL = 1e-5
REPS = 25
BUSY_CYCLES = 100_000_000   # ~50 ms of spinning at the H100's clocks
T_STEPS = 100
N_IMAGES = 100
# ULPs of 0.5 * vdd within which a spike may flip: M_O's kernel and plain
# outputs differ by up to ~1e-6 (~17 ULPs at 0.75 V), summed in two orders
HALF_VDD_BAND = 64


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


def check_mlp_heads(torch, np, dev, unpackable):
    """The stacked groups the unpackable artifact launches on the main
    path: (M_O, M_V) at the active width and (M_ED, M_L) at the
    transition width."""
    from repro_torch.kernels import mlp_surrogate
    keys = ("x_mu", "x_sd", "y_mu", "y_sd", "w0", "b0", "w1", "b1", "w2",
            "b2")
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    flops = n_bytes = 0.0
    shapes = []
    for pnames in (("M_O", "M_V"), ("M_ED", "M_L")):
        s = unpackable._stacked(pnames)
        stacks = [s[k] for k in keys]
        p, f, h1 = s["w0"].shape
        h2 = s["w1"].shape[2]
        for n in (N_MAIN, N_RAGGED):
            x = torch.as_tensor(np.random.default_rng(n + f).normal(
                0, 1, (n, f)), dtype=torch.float32, device=dev)
            got = mlp_surrogate.mlp_surrogate_heads(x, *stacks)
            want = mlp_surrogate.mlp_heads_plain(x, *stacks)
            torch.cuda.synchronize()
            out["max_abs_err"] = max(out["max_abs_err"], compare(
                got, want, f"mlp_surrogate_heads {pnames} n={n}"))
            if n == N_MAIN:
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
    return out


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


def check_network_tick(torch, np, dev, packable):
    """Standalone and annotation ticks, at N_MAIN and N_RAGGED, for the
    trained packable artifact (timed) and a mean/linear pack."""
    from repro_torch.kernels import tick_megakernel as mk
    pack, layout = mk.pack_heads(packable)
    vdd, clock, t_now = 1.5, 5.0, 30.0
    ulp = float(np.spacing(np.float32(0.5 * vdd)))
    p_a, f_a, h1 = pack["a"]["w0"].shape
    p_t, f_t, _ = pack["t"]["w0"].shape
    h2 = pack["a"]["w1"].shape[2]
    out = {"max_abs_err": 0.0, "threshold_rows": 0,
           "shape": f"N={N_MAIN}, A stack {p_a}x({f_a},{h1},{h2}), "
                    f"T stack {p_t}x({f_t},{h1},{h2})"}
    packs = {"packable": (pack, layout),
             "mean_linear": mk.pack_heads(mean_linear_surrogate(np, dev))}
    for label, (pk, ly) in packs.items():
        for annotate in (False, True):
            for n in (N_MAIN, N_RAGGED):
                v, o, t_last, params, ch, x, known = tick_inputs(
                    torch, np, dev, n, n + annotate, vdd)
                t = torch.full((), t_now, device=dev)
                kw = dict(circuit="lif", clock_ns=clock, layout=ly,
                          out_eps=0.02, spiking=True, vdd=vdd,
                          annotate=annotate)
                args = (pk, v, o, t_last, params, ch, x, t, known)
                tag = f"network_tick {label} n={n} annotate={annotate}"
                got = mk.network_tick(*args, **kw)
                *want, o_hat = mk._tick_arrays(
                    pk["a"], pk["t"], v, o, t_last, params, ch, x, t,
                    known_out=known if annotate else None, **kw)
                torch.cuda.synchronize()
                flip = (got[1] != want[1]).cpu().numpy()
                near = (torch.abs(o_hat - 0.5 * vdd) <= HALF_VDD_BAND * ulp
                        ).cpu().numpy()
                if (flip & ~near).any():
                    fail(f"{tag}: output differs on "
                         f"{int((flip & ~near).sum())} rows away from the "
                         "spike threshold")
                out["threshold_rows"] += int(flip.sum())
                if not torch.equal(got[2], want[2]):
                    fail(f"{tag}: t_last differs")
                for name, g, w in zip(("v", "e", "l"),
                                      (got[0], got[3], got[4]),
                                      (want[0], want[3], want[4])):
                    out["max_abs_err"] = max(out["max_abs_err"], compare(
                        g, w, f"{tag} {name}", mask=~flip))
                if label != "packable" or n != N_MAIN or annotate:
                    continue
                out["ms"] = time_ms(lambda: mk.network_tick(*args, **kw),
                                    torch)
                out["plain_ms"] = time_ms(lambda: mk._tick_arrays(
                    pk["a"], pk["t"], v, o, t_last, params, ch, x, t,
                    known_out=None, **kw), torch)
                # the work this data needs: active heads on changed rows,
                # idle heads on stale ones, transition heads where the
                # output changed; idle rows are copied through
                stale = ch & (t_last < t_now - clock)
                fired = ch & (o_hat > 0.5 * vdd)
                n_ch, n_st, n_tr = (int(m.sum()) for m in (ch, stale, fired))
                fa = [head_flops(fm, f_a, h1, h2) for fm in ly.a_fams]
                ft = [head_flops(fm, f_t, h1, h2) for fm in ly.t_fams]
                flops = n_ch * sum(fa) + n_st * sum(fa[:2]) \
                    + n_tr * sum(ft)
                weights = sum(a.numel() for s in pk.values()
                              for a in s.values())
                n_bytes = n * (3 * 4 + 16 + 1 + 12) + n * 5 * 4 \
                    + weights * 4
                out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, flops)
                out["rows"] = {"changed": n_ch, "stale": n_st,
                               "output_changed": n_tr}
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


def main_path(torch, np, dev, packable, unpackable, profile=False):
    import repro_torch.lasana as lasana
    from repro_torch.convert import spec_from_numpy
    from repro_torch.data.mnist import make_digits, poisson_encode
    from repro_torch.kernels import ops
    art = ROOT / "src" / "repro_torch" / "artifacts"
    with np.load(art / "snn_784_128_10.npz") as z:
        ws = [z["w0"], z["w1"]]
    knobs = [np.array([0.58, 0.5, 0.5, 0.5], np.float32)] * 2
    spec = spec_from_numpy(ws, knobs)
    imgs, labels = make_digits(N_IMAGES, size=28, seed=777)
    x = torch.as_tensor(poisson_encode(imgs, T_STEPS, seed=5) * 1.5,
                        dtype=torch.float32, device=dev)
    rec = dict(np.load(art / "snn_ref_record.npz"))
    launches = {}
    runs = (("golden", "golden", dict(backend="golden"), "lif_step"),
            ("lasana", "lasana", dict(surrogates=packable), "network_tick"),
            ("lasana_unpackable", "lasana_unpackable",
             dict(surrogates=unpackable), "mlp_surrogate_heads"))
    for name, rec_key, kw, kernel in runs:
        ops.reset_launches()
        run = lasana.simulate(spec, x, **kw)
        counts = dict(ops.LAUNCHES)
        eng = lasana.engine(spec, **{k: v for k, v in kw.items()
                                     if k == "backend"})
        # steady state: the whole tick loop enqueued with host syncs
        # forbidden; any synchronising call in it raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = eng.dispatch(x, surrogates=kw.get("surrogates"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        steady = pending.result()
        # two layers: one launch each per tick (lif_step, network_tick);
        # the stacked MLP groups launch at least once per tick
        want = counts[kernel]
        if kernel == "mlp_surrogate_heads":
            ok, need = want >= T_STEPS, f">= {T_STEPS}"
        else:
            ok, need = want == 2 * T_STEPS, f"{2 * T_STEPS}"
        if not ok:
            fail(f"{name}: {kernel} launched {want} times, expected {need}")
        launches[kernel] = want
        spikes = (run.out_spikes > 0.75).astype(np.uint8)
        agree = float(np.mean(spikes == rec[f"{rec_key}/out_spikes"]))
        e_port = float(run.energy.sum() + run.flush_energy.sum())
        e_ref = float(rec[f"{rec_key}/energy"].sum()
                      + rec[f"{rec_key}/flush_energy"].sum())
        e_diff = abs(e_port - e_ref) / max(abs(e_ref), 1e-30)
        if not np.isfinite(run.energy).all() or run.outputs.shape != (
                N_IMAGES, 10):
            fail(f"{name}: non-finite energy or outputs of shape "
                 f"{run.outputs.shape}")
        rep = steady.report()["network"]
        prof = (profile_run(torch, eng, x, kw.get("surrogates"))
                if profile else None)
        res = {"phase": "main_path", "run": name, "launches": counts,
               "wall_s": rep["wall_seconds"],
               "events_per_s": rep["events_per_sec"],
               "events": rep["events"],
               "accuracy": float(np.mean(np.argmax(run.outputs, -1)
                                         == labels)),
               "spike_agreement_vs_ref": agree,
               "energy_j": e_port, "energy_rel_diff_vs_ref": e_diff,
               "sync_debug_mode": "error"}
        if prof is not None:
            res["profile"] = prof
        line(res)
        if agree < 0.99 or e_diff > 0.01:
            fail(f"{name}: spike agreement {agree:.4f} (< 0.99) or energy "
                 f"difference {e_diff:.4%} (> 1%) against the reference")
    return launches


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
    from repro_torch.kernels import _build, ops
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

    art = ROOT / "src" / "repro_torch" / "artifacts"
    packable = load(str(art / "lif_packable.npz"))
    unpackable = load(str(art / "lif_unpackable.npz"))

    checks = {"lif_step": check_lif(torch, np, dev),
              "mlp_surrogate_heads": check_mlp_heads(torch, np, dev,
                                                     unpackable),
              "network_tick": check_network_tick(torch, np, dev, packable)}
    for name, c in checks.items():
        line({"phase": "kernel_check", "kernel": name, **c})

    launches = main_path(torch, np, dev, packable, unpackable,
                            profile=args.profile)

    meta = {
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
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None,
            "shape": c["shape"]})
    line({"kernels": kernels})
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
