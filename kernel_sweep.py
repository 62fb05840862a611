#!/usr/bin/env python3
"""Development sweep of the choices compiled into two kernels of the
PyTorch port, on one CUDA card.

    python3 kernel_sweep.py [--parent DIR] [--only lif|mlp]

For ``lif_chunk`` (``csrc/lif_step.cu``; ``lif_step``, which shares its
period, is timed beside it) and ``mlp_surrogate`` (``csrc/mlp_heads.cu``)
it builds variants of this tree's source, each with one compiled-in
choice replaced in the text (a block size, an unroll factor, a form of
the substep or of the products), all ``nvcc`` runs at once. On the
seeded inputs of ``chip_smoke.py`` it requires every variant's outputs
to equal this tree's kernel bit for bit, except the probes (variants
that stop ``mlp_single`` after a phase, to time the phases), and times
each twice, in order and in reverse order (CUDA events, median of 25
calls, as ``chip_smoke.py`` times kernels). ``--parent DIR`` adds the two
sources under another commit's ``src`` directory as one more variant
each (the parent's ``mlp_surrogate`` takes fp32 rows only: its bf16 time
includes the cast its wrapper made). One JSON line per kernel; the final
tree keeps the winners compiled in, and nothing in the port reads the
variants.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "sweep"

# name: (tree or parent source, [(text, replacement)], probe). A probe
# removes work to time what is left: its outputs are not compared.
# lif_period's loop with a first-spike index kept per substep and an
# adaptation select, unrolled by 16 (the development build before the
# spike mask)
INDEX_LOOP = """  float energy = 0.0f;
  int first = 0;
  float r = ref;
  bool fired = false;
  const int n_sub = S > 0 ? S : c.n_substeps;
#pragma unroll 16
  for (int s = 0; s < n_sub; ++s) {
    const bool in_ref = r > 0.0f;
    const float vc = fminf(fmaxf((v + d.dv) * k.decay, 0.0f), c.vdd);
    const float eff_th = k.thresh + adap * 1.0f;
    const bool fire = (vc >= eff_th) && !in_ref;
    v = fire ? 0.0f : (in_ref ? k.c0 : vc);
    r = fire ? k.tau_ref_ns : r - c.dt;
    adap = adap * k.adap_decay + (fire ? k.adap_gain : 0.0f);
    first = (fire && first == 0) ? s + 1 : first;
    lif_energy(c, k, d.abs_i, v, fire, energy);
    fired = fire;
  }
"""
LIF_VARIANTS = {
    "tree": ("tree", (), False),
    "ref_clamped": ("tree", ((
        "r = fire ? k.tau_ref_ns : r - c.dt;",
        "r = fire ? k.tau_ref_ns : fmaxf(r - c.dt, 0.0f);"),), False),
    "spike_select": ("tree", ((
        "  energy = energy + e_sub;\n  if (fire) energy = energy + c.e_spike;",
        "  energy = energy + e_sub + (fire ? c.e_spike : 0.0f);"),), False),
    "index_loop": ("tree", (
        (("  float energy = 0.0f;\n  int first = 0;\n  float r = ref;",
          "first = s0 + __ffs(spikes);\n  }\n"), INDEX_LOOP),), False),
    "group16": ("tree", (("kGroup = 32;", "kGroup = 16;"),), False),
    "threads64": ("tree", (("kChunkThreads = 32;", "kChunkThreads = 64;"),),
                  False),
    "threads128": ("tree", (("kChunkThreads = 32;", "kChunkThreads = 128;"),),
                   False),
    "parent": ("parent", (), False),
}
UNPIPELINED = """#pragma unroll 2
    for (int k = 0; k < n_k; ++k) {
      float ar[RM], wr[RN];
      tile_load<LD>(ap, wp, k, ldw, ar, wr);
      tile_fma(ar, wr, acc);
    }"""
# a probe returns (once the head has landed) before layer 1, after it,
# or after layer 2
RETURN = "    if (tid >= 0) {\n      wait_group<0>();\n      return;\n    }\n"
MLP_VARIANTS = {
    "tree": ("tree", (), False),
    "unpipelined": ("tree", ((("    float a0[RM], w0[RN], a1[RM], w1[RN];",
                               "    if (k < n_k) tile_fma(a0, w0, acc);"),
                              UNPIPELINED),), False),
    "tile4x4": ("tree", (("kTileUnits = 8;", "kTileUnits = 4;"),), False),
    "tile8x8": ("tree", (("kTileRows = 4,", "kTileRows = 8,"),), False),
    "heads_dense": ("tree", (("dense_tile<ld, kTileRows, kTileUnits>(",
                              "repro::dense_relu<ld>("),), False),
    "probe_empty": ("tree", (
        ("  const int tid = threadIdx.x;\n",
         "  const int tid = threadIdx.x;\n  if (tid >= 0) return;\n"),), True),
    "probe_staged": ("tree", (
        ("    if (!staged) wait_group<1>();   // w0 and b0\n", RETURN),),
        True),
    "probe_layer1": ("tree", (
        ("s.h1, pd.h1p, ld, m, hid);\n",
         "s.h1, pd.h1p, ld, m, hid);\n" + RETURN),), True),
    "probe_layer2": ("tree", (
        ("s.h1, s.h2, pd.h2p, ld, m, xs);\n    __syncthreads();\n",
         "s.h1, s.h2, pd.h2p, ld, m, xs);\n    __syncthreads();\n" + RETURN),),
        True),
    "parent": ("parent", (), False),
}
LIF_SHAPES = ((cs.N_MAIN, cs.T_CHUNK_CHECK), (2000, 125))
LIF_CHECKS = ((cs.N_RAGGED, cs.T_CHUNK_CHECK, 64), (1000, 8, 32),
              (cs.N_RAGGED, 8, 32))
MLP_SHAPES = ((cs.N_MAIN, 41), (cs.N_MAIN, 67))


def build(jobs):
    """``{(kernel, variant): (source text, include dir)}`` -> loaded
    libraries, one ``nvcc`` each, all at once."""
    from repro_torch.kernels import _build
    procs = {}
    for (kernel, variant), (text, inc) in jobs.items():
        d = OUT / f"{kernel}-{variant}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "src.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc), "-o",
               str(d / "lib.so"), str(d / "src.cu")]
        procs[kernel, variant] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed on {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(OUT / f"{key[0]}-{key[1]}" / "lib.so"))
    return libs


def variant_text(path: pathlib.Path, subs) -> str:
    """The source with each (old, new) replaced; old may be a (first,
    last) pair of texts, the span from first to last inclusive."""
    text = path.read_text()
    for old, new in subs:
        first, last = old if isinstance(old, tuple) else (old, old)
        if first not in text or last not in text[text.index(first):]:
            cs.fail(f"{path.name}: '{first}' ... '{last}' not found")
        a = text.index(first)
        b = text.index(last, a) + len(last)
        text = text[:a] + new + text[b:]
    return text


def lif_chunk_fn(lib, torch, circ, state, x_seq, params):
    """``lif_chunk_launch`` of one variant's library, as
    ``lif_scan._launch_chunk`` calls it."""
    from repro_torch.kernels import lif_scan
    fn = lib.lif_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = lif_scan.ARGTYPES["lif_chunk"]
    n, t_steps = state.shape[0], x_seq.shape[0]
    dev = state.device
    outs = [torch.empty_like(state)] + [
        torch.empty((t_steps, n), dtype=torch.float32, device=dev)
        for _ in range(3)] + [torch.empty((t_steps, n), dtype=torch.bool,
                                          device=dev)]

    def call():
        code = fn(state.data_ptr(), x_seq.data_ptr(), params.data_ptr(),
                  *(o.data_ptr() for o in outs), n, t_steps,
                  circ.n_substeps, dev.index or 0, *lif_scan._consts(circ),
                  torch.cuda.current_stream(dev).cuda_stream)
        if code:
            cs.fail(f"lif_chunk_launch returned {code}")
        return outs
    return call


def lif_step_fn(lib, torch, circ, state, x, params):
    """``lif_step_launch`` of one variant's library, as
    ``lif_scan._launch`` calls it."""
    from repro_torch.kernels import lif_scan
    fn = lib.lif_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = lif_scan.ARGTYPES["lif_step"]
    n, dev = state.shape[0], state.device
    outs = [torch.empty_like(state)] + [
        torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3)] \
        + [torch.empty(n, dtype=torch.bool, device=dev)]

    def call():
        code = fn(state.data_ptr(), x.data_ptr(), params.data_ptr(),
                  *(o.data_ptr() for o in outs), n, circ.n_substeps,
                  dev.index or 0, *lif_scan._consts(circ),
                  torch.cuda.current_stream(dev).cuda_stream)
        if code:
            cs.fail(f"lif_step_launch returned {code}")
        return outs
    return call


def mlp_fn(lib, torch, x, w, old_abi):
    """``mlp_surrogate_launch`` of one variant's library on x (fp32 or
    bf16); the old ABI takes fp32 rows, so bf16 rows are cast first."""
    from repro_torch.kernels import mlp_surrogate
    fn = lib.mlp_surrogate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p]) if old_abi else \
        mlp_surrogate.ARGTYPES["mlp_surrogate"]
    n, f = x.shape
    h1, h2 = w[0].shape[1], w[2].shape[1]
    dev = x.device
    ptrs = (ctypes.c_void_p * 6)(*(a.data_ptr() for a in w))
    out = torch.empty((n,), dtype=torch.float32, device=dev)

    def call():
        xx = x.float() if old_abi else x
        head = (xx.data_ptr(),) if old_abi else (
            xx.data_ptr(), int(xx.dtype == torch.bfloat16))
        code = fn(*head, ptrs, out.data_ptr(), n, f, h1, h2, dev.index or 0,
                  torch.cuda.current_stream(dev).cuda_stream)
        if code:
            cs.fail(f"mlp_surrogate_launch returned {code}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another commit's src directory")
    ap.add_argument("--only", choices=("lif", "mlp"),
                    help="sweep one kernel's source only")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.circuits import LIFNeuron
    from repro_torch.kernels import lif_scan, mlp_surrogate, ops
    dev = ops.resolve_device("cuda")
    cs.line(cs.nvidia_smi())
    roots = {"tree": pathlib.Path(lif_scan.__file__).resolve().parent / "csrc"}
    if args.parent:
        roots["parent"] = (pathlib.Path(args.parent).resolve() / "repro_torch"
                           / "kernels" / "csrc")
    jobs, probes = {}, set()
    for kernel, src, variants in (("lif", "lif_step", LIF_VARIANTS),
                                  ("mlp", "mlp_heads", MLP_VARIANTS)):
        for name, (root, subs, probe) in variants.items():
            if root in roots and args.only in (None, kernel):
                jobs[kernel, name] = (
                    variant_text(roots[root] / f"{src}.cu", subs), roots[root])
                if probe:
                    probes.add(name)
    libs = build(jobs)

    def sweep(kernel, label, make_call, want, timed=True):
        """Every variant of ``kernel`` on one case: outputs held to
        ``want`` (this tree's kernel through its wrapper), then, if
        ``timed``, each timed twice, in order and in reverse order (a
        drift of the card's state shows as a gap between the two)."""
        calls = {}
        for (kern, name), lib in libs.items():
            if kern != kernel:
                continue
            calls[name] = make_call(lib, name)
            got = calls[name]()
            torch.cuda.synchronize()
            if name not in probes and not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                cs.fail(f"{label} {name}: differs from this tree's kernel")
        if not timed:
            return None
        ms = {name: [] for name in calls}
        for name in [*calls, *reversed(calls)]:
            ms[name].append(cs.time_ms(calls[name], torch))
        return ms

    def obs(res):
        new_state, o = res
        return [new_state] + [o[k] for k in cs.LIF_OBS]

    circ = LIFNeuron()
    bits = "every variant but the probes equal to this tree's"
    if args.only != "mlp":
        res = {"kernel": "lif_chunk", "ms": {}, "probes": sorted(probes),
               "bits": bits}
        for n, t_steps, subs in tuple((n, t, 64) for n, t in LIF_SHAPES) \
                + LIF_CHECKS:
            c = circ if subs == 64 else LIFNeuron(n_substeps=subs)
            args_ = cs.lif_chunk_inputs(torch, np, dev, n, t_steps, n)
            ms = sweep("lif", f"lif_chunk n={n} T={t_steps} substeps={subs}",
                       lambda lib, _: lif_chunk_fn(lib, torch, c, *args_),
                       obs(lif_scan.lif_chunk(*args_, circ=c)),
                       timed=(n, t_steps) in LIF_SHAPES and subs == 64)
            if ms:
                res["ms"][f"n={n} T={t_steps}"] = ms
        cs.line(res)

        res = {"kernel": "lif_step", "ms": {}, "probes": sorted(probes),
               "bits": bits}
        for n in cs.LIF_SHAPES:
            args_ = cs.lif_inputs(torch, np, dev, n)
            res["ms"][f"n={n}"] = sweep(
                "lif", f"lif_step n={n}",
                lambda lib, _: lif_step_fn(lib, torch, circ, *args_),
                obs(lif_scan.lif_step(*args_, circ=circ)))
        cs.line(res)

    if args.only != "lif":
        res = {"kernel": "mlp_surrogate", "ms": {}, "probes": sorted(probes),
               "bits": bits}
        for n, f in MLP_SHAPES:
            rng = np.random.default_rng(f)
            w = cs.single_head(torch, np, dev, rng, f, 100, 50)
            x = torch.as_tensor(rng.normal(0, 1, (n, f)), dtype=torch.float32,
                                device=dev)
            for xx in (x, x.bfloat16()):
                res["ms"][f"n={n} F={f} {xx.dtype}"] = sweep(
                    "mlp", f"mlp_surrogate n={n} F={f} {xx.dtype}",
                    lambda lib, name: (lambda call: lambda: [call()])(
                        mlp_fn(lib, torch, xx, w, name == "parent")),
                    [mlp_surrogate.mlp_surrogate(xx, *w)])
        cs.line(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
