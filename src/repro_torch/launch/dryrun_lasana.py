"""LASANA at scale, dry run: one Algorithm-1 simulation tick of N circuits
over the production mesh, run on meta tensors, and its roofline terms —
the paper's §V-D scaling study taken to pod scale. The JAX package's
``launch/dryrun_lasana.py`` (``:1-89``) in PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_lasana [--n 1048576]
                                                              [--multi-pod]

``main`` trains its surrogate with ``repro_torch.lasana.train`` on the card
(``--device cpu`` asks for the CPU); :func:`run` takes any surrogate.
The tick's ``network_tick`` takes its dry-run route: it records its work
(every circuit changed, stale and firing: the worst case) and launches
nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.core.distributed import lower_distributed_step
from repro_torch.launch import hlo_cost
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh, mesh_info

# the reference's "useful" flops: one predictor MLP(41 -> 100 -> 50 -> 1)
# per circuit, 7 predictor invocations a tick
MLP_FLOPS = 2 * (41 * 100 + 100 * 50 + 50)
INVOCATIONS = 7


def run(surrogate, *, n: int = 2 ** 20, mesh=None, multi_pod: bool = False,
        out_dir: str | None = "results/dryrun") -> dict:
    """The record of one tick of ``n`` LIF circuits on ``mesh`` (the
    production mesh by default), written to ``out_dir`` when given."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh_info(mesh)["n_devices"]
    t0 = time.time()
    stats = lower_distributed_step(surrogate, mesh, n, 3, 4, clock_ns=5.0,
                                   spiking=True)
    trace_s = time.time() - t0
    d = hlo_cost.per_device(stats)
    useful = INVOCATIONS * MLP_FLOPS * n
    roof = rf.roofline(
        d.cost.cost_analysis(),
        rf.CollectiveStats(counts=d.cost.collective_counts, operand_bytes={},
                           wire_bytes=d.cost.wire_bytes),
        model_flops_total=useful, n_devices=n_dev)
    rec = {
        "cell": f"lasana-lif-sim__n{n}__"
                + ("multipod" if multi_pod else "singlepod"),
        "status": "ok",
        "n_circuits": n,
        "n_devices": n_dev,
        "lower_s": round(trace_s, 2),
        "memory": {
            "argument_bytes_per_device": d.argument_bytes,
            "temp_bytes_per_device": d.temp_bytes,
            "peak_live_bytes_per_device": d.peak_live_bytes,
        },
        "cost": {"flops_per_device": d.cost.flops,
                 "bytes_per_device": d.cost.bytes,
                 "flops_by_rate_per_device": d.cost.flops_by_rate},
        "collectives": {"counts": d.cost.collective_counts,
                        "wire_bytes_per_device": float(d.cost.wire_bytes)},
        "kernels": d.kernels,
        "roofline": roof.as_dict(),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, rec["cell"] + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--families", default="mlp",
                    help="comma list of model families for the bank")
    ap.add_argument("--bank-runs", type=int, default=200)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default=None,
                    help="where the surrogate trains (the card by default)")
    args = ap.parse_args()

    from repro_torch import lasana
    print(f"[lasana-dryrun] training surrogate ({args.families}) ...")
    surrogate = lasana.train("lif", lasana.TrainConfig(
        n_runs=args.bank_runs, n_steps=80,
        families=tuple(args.families.split(","))), device=args.device)
    rec = run(surrogate, n=args.n, multi_pod=args.multi_pod,
              out_dir=args.out)
    c, r = rec["cost"], rec["roofline"]
    print(f"[lasana-dryrun] ok in {rec['lower_s']:.1f}s -> {args.out}/"
          f"{rec['cell']}.json")
    print(f"  per-device: flops {c['flops_per_device']:.3e}  bytes "
          f"{c['bytes_per_device']:.3e}  wire "
          f"{rec['collectives']['wire_bytes_per_device']:.3e}")
    print(f"  terms: compute {r['compute_s'] * 1e6:.1f}us  memory "
          f"{r['memory_s'] * 1e6:.1f}us  collective "
          f"{r['collective_s'] * 1e6:.3f}us  dominant={r['dominant']}")


if __name__ == "__main__":
    main()
