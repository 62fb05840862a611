"""Run one cell of the port's benchmark once.

    python3 lasana_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and the port (``src/repro_torch``), on a machine with the cell's CUDA
devices. Set-up builds the cell's configuration, makes its stimulus on the
device from ``--seed`` and warms every shape the window uses; the window
then runs the cell's traffic for ``--seconds`` (``--trace 0``: the
end-to-end metrics) or a profiled slice of it (``--trace 1``: the
per-layer metrics). Afterwards the program's records are compared with
the plain reference (``reference/``), which decides ``correct``. The last
line of standard output is one JSON object; the compared numbers and
their limits are also the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from lasana_bench import harness, profiling  # noqa: E402
from lasana_bench.reference import compare, lasana_ref  # noqa: E402
from lasana_bench.work import counts  # noqa: E402


class RunError(RuntimeError):
    """A run that must end without a result, with this exit code."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def _caches():
    """Every compiler cache a run may fill, at fixed paths in the checkout
    (the port builds its kernels under ``build/repro_torch`` itself)."""
    out = BENCH / "out" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(out / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(out / "triton")


def _card(torch) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def run_cell(manifest: dict, cell: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", cfg=None, traffic=None,
             bench=harness.BENCH):
    """One run of ``cell``: ``(result line dict, stderr check lines)``.
    ``cfg`` / ``traffic`` replace the cell's files (the tests' small
    sizes), ``bench`` the benchmark's folder; ``device="cpu"`` runs the
    program's plain versions."""
    import torch
    from repro_torch.kernels import ops
    from lasana_bench.traffic import digits
    w, cfg0, traffic0 = harness.resolve_cell(manifest, cell, bench)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    cuda = device == "cuda"
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=seed, device=torch.device(device),
        net=harness.network(cfg, bench), spans=harness.Spans(),
        gen=digits.generator(seed, device),
        surrogate_path=cfg["surrogate_paths"][traffic["surrogate"]])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = harness.traffic_kind(traffic, bench).Workload(ctx)
    wl.setup()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = time.perf_counter() - T_START
    launches0 = dict(ops.LAUNCHES)
    ctx.trace = None
    if trace:
        sl = profiling.Slice(torch)
        ctx.spans.profiled = True
        units = wl.traced(sl)
        ctx.spans.profiled = False
        ctx.trace = sl.reduce()
    else:
        units = wl.window(seconds)
    ctx.launches = {k: v - launches0.get(k, 0)
                    for k, v in ops.LAUNCHES.items() if v - launches0.get(k, 0)}
    ctx.window_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(setup_peak, ctx.window_peak_bytes)
    wl.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    per_unit, rows = wl.check()
    check_s = time.perf_counter() - t_check
    gaps = compare.worst(per_unit)
    correct, checks = compare.judge(gaps, traffic["limits"])
    failed = sum(1 for g in per_unit
                 if not compare.judge(g, traffic["limits"], partial=True)[0])

    ctx.units = units
    ctx.slice_ticks = sum(u["ticks"] for u in units)
    ctx.slice_rows = wl.slice_rows(rows) if trace else None
    ctx.circuit = ctx.net.CIRCUIT
    heads = lasana_ref.Heads(ctx.surrogate_path, "cpu", lasana_ref.Matmul())
    ctx.shapes = counts.head_shapes(heads.families, heads.arrays)
    ctx.layer_sizes = ctx.net.layer_sizes(cfg, traffic["batch"])
    ctx.drive_flops = ctx.net.drive_flops(cfg, traffic["batch"])
    metrics = {}
    for m in harness.metrics_for(manifest, cell, trace):
        v = harness.reader(m["name"], bench)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": w["chips"] if cuda else 0, "memory_peak_bytes": int(peak)}
    extra = {}
    breakdown = None
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        breakdown = {"device_ops": profiling.top_ops(ctx.trace),
                     "idle_gaps": [[n, s] for n, s in ctx.trace.gaps[:10]]}
    if cuda:
        extra["card"] = _card(torch)
    extra["launches"] = ctx.launches
    if trace:
        # the same launches as the profile saw them: fewer means the
        # profiler lost events
        extra["traced_launches"] = {
            k: ctx.trace.count(lambda n, p=p: p in n and "chunk" not in n)
            for k, p in (("network_tick", "network_tick_tiled"),
                         ("mlp_surrogate_heads", "mlp_heads_tiled"))}
    extra["check_s"] = check_s
    if not trace:
        extra["window_s"] = units[-1]["t1"] - units[0]["t0"]
    extra["setup_peak_bytes"] = int(setup_peak)
    extra["setup_parts"] = dict(wl.setup_parts,
                                before_s=ctx.setup_s - sum(
                                    wl.setup_parts.values()))
    result = dict(correct=correct, attempted=len(units), failed=failed,
                  metrics=metrics, device=dev, checks=checks,
                  breakdown=breakdown, **extra)
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    try:
        manifest = harness.load_manifest(ROOT / "BENCHMARK.json")
        bad = harness.check_manifest(manifest)
        if bad:
            raise RunError("BENCHMARK.json: " + "; ".join(bad), 2)
        w = next((x for x in manifest["workloads"]
                  if x["name"] == args.workload), None)
        if w is None:
            raise RunError(f"no workload {args.workload!r}", 2)
        import torch
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < w["chips"]:
            raise RunError(f"{args.workload} needs {w['chips']} CUDA "
                           "device(s); none or too few are visible", 3)
        try:
            import repro_torch.lasana  # noqa: F401
        except ImportError as e:
            raise RunError(f"the program is not in this checkout: {e}", 4)
        result, lines = run_cell(manifest, args.workload, args.seed,
                                 args.seconds, bool(args.trace))
        # after the window, in the process that prints the result
        found = harness.forbidden_modules()
        if found:
            raise RunError("modules that no run may load are loaded: "
                           + ", ".join(found), 5)
    except RunError as e:
        print(f"lasana_bench: {e}", file=sys.stderr)
        return e.code
    print(json.dumps({"route": result["launches"],
                      "traced": result.get("traced_launches")}))
    sys.stdout.flush()
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(**result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
