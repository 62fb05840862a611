"""Readings that the limits of ``correct`` are set from, in one process.

    python3 lasana_bench/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--out FILE]

For each seed, the program's records of one call (a batch cell) or of the
checked chunks (a stream cell) at the cell's own size, against the plain
reference: the lower readings. For each control seed, the control in the
program's place — the reference with every matrix product's operands
rounded to TF32, one precision below the configuration's fp32 — against
the fp32 reference: the upper readings. Each line printed is a JSON
object ``{"seed", "side", "gaps", "correct"}`` judged by the cell's
limits. The benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys
import time
import types

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from lasana_bench import harness  # noqa: E402
from lasana_bench.reference import compare  # noqa: E402


def workload(manifest, cell, seed, device, cfg=None, traffic=None,
             bench=harness.BENCH):
    from lasana_bench.traffic import digits
    import torch
    _, cfg0, traffic0 = harness.resolve_cell(manifest, cell, bench)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=seed, device=torch.device(device),
        net=harness.network(cfg, bench), spans=harness.Spans(),
        gen=digits.generator(seed, device),
        surrogate_path=cfg["surrogate_paths"][traffic["surrogate"]])
    return harness.traffic_kind(traffic, bench).Workload(ctx), traffic


def program_reading(manifest, cell, seed, device="cuda", **kw) -> dict:
    """The program's gaps against the reference on ``seed``."""
    wl, traffic = workload(manifest, cell, seed, device, **kw)
    wl.setup(warm=False)
    wl.window(0.0)
    wl.release()
    per, _ = wl.check()
    gaps = compare.worst(per)
    ok, _ = compare.judge(gaps, traffic["limits"])
    return {"seed": seed, "side": "program", "gaps": gaps, "correct": ok}


def control_reading(manifest, cell, seed, device="cuda", **kw) -> dict:
    """The control's gaps (the TF32 reference in the program's place)
    against the fp32 reference on ``seed``."""
    wl, traffic = workload(manifest, cell, seed, device, **kw)
    wl.setup(warm=False)
    wl.release()
    low, _ = wl.reference_run("tf32")
    want, _ = wl.reference_run("fp32")
    gaps = compare.worst(wl.compare(low, want))
    ok, _ = compare.judge(gaps, traffic["limits"])
    return {"seed": seed, "side": "control", "gaps": gaps, "correct": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    manifest = harness.load_manifest(ROOT / "BENCHMARK.json")
    out = open(args.out, "a") if args.out else None
    try:
        for fn, seeds in ((program_reading, args.seeds),
                          (control_reading, args.control_seeds)):
            for s in seeds:
                t0 = time.perf_counter()
                r = dict(fn(manifest, args.workload, s), cell=args.workload)
                r["seconds"] = time.perf_counter() - t0
                line = json.dumps(r)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
