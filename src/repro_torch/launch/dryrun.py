"""The multi-pod dry run, the JAX package's ``launch/dryrun.py``
(``:1-193``) in PyTorch: every (arch x shape x mesh) cell's step run on
torch's meta device over the production mesh — nothing allocated — and
its per-device memory, cost and collectives recorded for the roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch X --shape Y \\
        [--multi-pod]            # one cell -> results/dryrun/<cell>.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Where the reference lowers and compiles the jitted step from
ShapeDtypeStructs and reads XLA's analyses, the port runs the eager step
on meta tensors placed on ``launch.mesh.make_production_mesh`` (every
entry a meta "device") under ``launch/hlo_cost.py``'s counter: the
per-device arguments are the placed state's blocks (and each entry's
block of the inputs, from its placement), the costs the counted aten
ops, kernels and collectives, the peak each entry's arguments plus its
most temporaries at once. One data row computes and stands for the rest
(``Model.rows.live``): every row runs the same program on its own slice.
Microbatches and layer stacks are counted at two small counts and
extended to the full ones (``hlo_cost.extrapolate``), exactly.

The record keeps the reference's keys where their meaning carries over:
``memory.*_bytes_per_device`` (argument, output, temp, alias, peak
live), ``cost.flops_per_device`` / ``bytes_per_device`` /
``transcendentals_per_device`` (and ``dot_flops_per_device``,
``flops_by_rate_per_device``),
``collectives.counts`` / ``wire_bytes_per_device``, ``roofline``,
``model_flops_total`` and ``lower_s`` (here the seconds of the traced
runs). ``compile_s``, ``cost.xla_flops_uncorrected`` and
``cost.xla_bytes_uncorrected`` have no counterpart (there is no XLA
compile and no XLA cost analysis) and are left out.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.utils.checkpoint

from repro_torch import sharding as shd
from repro_torch import tree as tr
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.configs.base import Family
from repro_torch.configs.shapes import skip_reason
from repro_torch.kernels import ops
from repro_torch.launch import hlo_cost
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh, mesh_info
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.sharding import train_rules
from repro_torch.train import step as step_mod


def _opt_for(cfg) -> AdamW:
    """The reference's ``_opt_for`` (``launch/dryrun.py:32``): bf16
    optimizer state for models past 100B parameters (the HBM ceiling),
    fp32 below."""
    big = cfg.param_count() > 100e9
    return AdamW(AdamWConfig(state_dtype=torch.bfloat16 if big
                             else torch.float32))


@dataclasses.dataclass
class Lowered:
    """The dry run of one step: ``device`` the busiest device's
    ``hlo_cost.EntryStats`` at the full counts (each entry's block of
    the inputs among its arguments), ``runs`` the counts each traced run
    took and its seconds, ``trace_s`` their sum, ``devices`` the device
    types every op's outputs lay on (``{"meta"}``: nothing allocated)."""
    device: hlo_cost.EntryStats
    runs: list
    trace_s: float
    devices: set


def placed_pairs(tree) -> list:
    """``(tensor, mesh entry)`` of every tensor of a placed tree: a
    ``Sharded`` leaf's shard ``i`` on entry ``i``, a plain tensor on
    entry 0."""
    out = []
    for leaf in tr.leaves(tree):
        if isinstance(leaf, shd.Sharded):
            out += [(t, i) for i, t in enumerate(leaf.shards)]
        elif isinstance(leaf, torch.Tensor):
            out.append((leaf, 0))
    return out


def input_block_bytes(model: Model, shape) -> int:
    """Bytes of one mesh entry's block of a cell's inputs, placed by the
    reference's input specs (its sharded arguments)."""
    specs = model.input_specs(shape)
    logical = model.input_logical(shape)
    total = 0
    for k, t in specs.items():
        if shape.kind == "decode" and k != "tokens":
            continue
        if model.mesh is None or model.mesh.size == 1:
            n = t.numel()
        else:
            pl = model.rules.sharding(model.mesh, logical[k], tuple(t.shape))
            n = 1
            for d in pl.shard_shape:
                n *= d
        total += n * t.element_size()
    return total


# --- repeated counts -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Repeat:
    """One count of repeated work: its full value, the small one it is
    extended from (None: run at the full value) and whether memory stops
    growing past ``a + 1``."""
    name: str
    full: int
    a: int | None
    saturates: bool = False


def repeats(cfg, shape, *, scale: bool = True) -> list:
    """The counts of a cell's repeated work: microbatches and each stack
    of layers of one kind, extended from 2 and 3 (the first microbatch
    takes no accumulator; a prefill's first layer allocates the stacked
    cache), a hybrid's pattern periods from 1 and 2 (its layers are not
    stacked), or nothing with ``scale`` off."""
    out = []

    def dim(name, full, a0, sat=False):
        out.append(Repeat(name, full, a0 if scale and full > a0 + 1 else None,
                          sat))
    if shape.kind == "train" and shape.num_microbatches > 1:
        dim("microbatches", shape.num_microbatches, 2, True)
    if cfg.family == Family.HYBRID:
        p = len(cfg.hybrid.pattern)
        dim("pattern_periods", cfg.n_layers // p, 1)
    elif cfg.moe is not None and cfg.moe.first_dense:
        dim("dense_layers", cfg.moe.first_dense, 2)
        dim("moe_layers", cfg.n_layers - cfg.moe.first_dense, 2)
    else:
        dim("layers", cfg.n_layers, 2)
    if cfg.encdec is not None:
        dim("encoder_layers", cfg.encdec.n_encoder_layers, 2)
    return out


def at_counts(cfg, shape, dims, counts):
    """``(cfg, shape)`` cut to ``counts`` (one per dim of ``dims``)."""
    for d, c in zip(dims, counts):
        if d.name == "microbatches":
            shape = dataclasses.replace(
                shape, num_microbatches=c,
                global_batch=shape.global_batch // d.full * c)
        elif d.name == "pattern_periods":
            p = len(cfg.hybrid.pattern)
            cfg = dataclasses.replace(
                cfg, n_layers=c * p + cfg.n_layers % p)
        elif d.name == "dense_layers":
            moe_n = cfg.n_layers - cfg.moe.first_dense
            cfg = dataclasses.replace(
                cfg, n_layers=c + moe_n,
                moe=dataclasses.replace(cfg.moe, first_dense=c))
        elif d.name == "moe_layers":
            cfg = dataclasses.replace(cfg, n_layers=cfg.moe.first_dense + c)
        elif d.name == "layers":
            cfg = dataclasses.replace(cfg, n_layers=c)
        elif d.name == "encoder_layers":
            cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
                cfg.encdec, n_encoder_layers=c))
    return cfg, shape


# --- one traced run ---------------------------------------------------------------

def run_step(cfg, shape, mesh, rules, *, one_row: bool = True,
             memo: bool = True, n_moe_groups: int = 1) -> dict:
    """One cell's step at ``cfg`` / ``shape`` on ``mesh`` (meta entries)
    under the counter: ``({entry: EntryStats}, the device types of every
    op's outputs)`` (the inputs, handed over whole, with the host)."""
    model = Model(cfg, mesh=mesh, rules=rules)
    if one_row and model.rows is not None:
        model.rows.live = [0]
    params = placed_meta(model.param_specs(), model.param_placements())
    batch = model.input_specs(shape)
    counter = hlo_cost.Counter(memo=memo)
    if shape.kind == "train":
        opt = _opt_for(cfg)
        state = {"step": torch.zeros((), dtype=torch.int32, device="meta"),
                 "params": params, "opt": opt.init(params)}
        step = step_mod.jit_train_step(model, opt, mesh, rules, shape,
                                       n_moe_groups=n_moe_groups)
        args = placed_pairs(state)
        call = lambda: step(state, batch)              # noqa: E731
    elif shape.kind == "prefill":
        step = step_mod.jit_prefill(model, mesh, rules, shape)
        args = placed_pairs(params)
        call = lambda: step(params, batch)             # noqa: E731
    else:
        b, s = shape.global_batch, shape.seq_len
        specs = model.cache_specs(b, s, model.dtype)
        stacks = placed_meta(specs["stacks"], None if mesh.size == 1 else
                             model.cache_placements(b, s, model.dtype))
        cache = {"stacks": stacks, "pos": s - 1}
        step = step_mod.jit_decode_step(model, mesh, rules, shape)
        args = placed_pairs({"params": params, "cache": stacks})
        call = lambda: step(params, cache, batch["tokens"])  # noqa: E731
    counter.arguments(args)
    counter.arguments((t, hlo_cost.HOST) for t in batch.values())
    # a recomputed layer (remat) stops once it has made what the backward
    # needs; over many rows only the last row's stops short, so the one
    # row computed here recomputes whole, as every other row does
    with hlo_cost.counting(counter), torch.no_grad() if shape.kind != \
            "train" else contextlib.nullcontext(), \
            torch.utils.checkpoint.set_checkpoint_early_stop(False):
        out = call()
    return counter.stats(placed_pairs(out)), counter.devices


def placed_meta(specs, placements):
    """A tree of specs as meta tensors placed as ``placements`` say (a
    tree of ``Placement`` s, or None for one entry): each entry's block
    made at its shard shape, as ``place_tree`` would cut it."""
    from repro_torch.models import params as prm
    if placements is None or next(iter(tr.leaves(placements))).mesh.size == 1:
        return prm.tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                  device="meta"), specs)
    return tr.tree_map(lambda s, pl: shd.Sharded(pl, [
        torch.empty(pl.shard_shape, dtype=s.dtype, device="meta")
        for _ in range(pl.mesh.size)]), specs, placements)


def lower(cfg, shape, mesh, rules, *, scale: bool = True,
          one_row: bool = True, memo: bool = True,
          n_moe_groups: int = 1) -> Lowered:
    """The dry run of one cell at any config, shape and mesh: the step
    traced at the small counts of :func:`repeats` (every count in full
    with ``scale`` off) and extended to the full ones."""
    dims = repeats(cfg, shape, scale=scale)
    points = [()]
    for d in dims:
        vals = (d.full,) if d.a is None else (d.a, d.a + 1)
        points = [p + (v,) for p in points for v in vals]
    runs, info, devices = {}, [], set()
    for counts in points:
        c, s = at_counts(cfg, shape, dims, counts)
        t0 = time.perf_counter()
        runs[counts], seen = run_step(c, s, mesh, rules, one_row=one_row,
                                      memo=memo, n_moe_groups=n_moe_groups)
        devices |= seen
        info.append({"counts": dict(zip((d.name for d in dims), counts)),
                     "seconds": time.perf_counter() - t0})
    device = hlo_cost.extrapolate(
        runs, [(d.full, d.a, d.saturates) for d in dims])
    device.argument_bytes += input_block_bytes(
        Model(cfg, mesh=mesh, rules=rules), shape)
    return Lowered(device, info, sum(r["seconds"] for r in info), devices)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               rule_opts: dict | None = None):
    """The cell's dry run on the production mesh (the reference's
    ``lower_cell``, ``launch/dryrun.py:39``, and its signature). Returns
    ``(Lowered, meta)``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mb_override = ops.microbatches_override()
    if mb_override and shape.kind == "train":
        shape = dataclasses.replace(shape, num_microbatches=mb_override)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = train_rules(mesh, **(rule_opts or {}))
    n_dp = 1
    for ax in ("pod", "data"):
        n_dp *= mesh.shape.get(ax, 1)
    lowered = lower(cfg, shape, mesh, rules,
                    n_moe_groups=n_dp if shape.kind == "train" else 1)
    return lowered, {"mesh": mesh_info(mesh), "cfg": cfg, "shape": shape}


def record(lowered: Lowered, cfg, shape, n_dev: int) -> dict:
    """The record's keys for one lowered cell."""
    d = lowered.device
    mf = rf.model_flops(cfg, shape)
    roof = rf.roofline(
        d.cost.cost_analysis(),
        rf.CollectiveStats(counts=d.cost.collective_counts, operand_bytes={},
                           wire_bytes=d.cost.wire_bytes),
        model_flops_total=mf, n_devices=n_dev)
    return {
        "status": "ok",
        "lower_s": round(lowered.trace_s, 2),
        "n_devices": n_dev,
        "memory": {
            "argument_bytes_per_device": d.argument_bytes,
            "output_bytes_per_device": d.output_bytes,
            "temp_bytes_per_device": d.temp_bytes,
            "alias_bytes_per_device": d.alias_bytes,
            "peak_live_bytes_per_device": d.peak_live_bytes,
        },
        "cost": {
            "flops_per_device": d.cost.flops,
            "bytes_per_device": d.cost.bytes,
            "transcendentals_per_device": d.cost.transcendentals,
            "dot_flops_per_device": d.cost.dot_flops,
            "flops_by_rate_per_device": d.cost.flops_by_rate,
        },
        "collectives": {
            "counts": d.cost.collective_counts,
            "wire_bytes_per_device": float(d.cost.wire_bytes),
        },
        "kernels": d.kernels,
        "roofline": roof.as_dict(),
        "model_flops_total": mf,
        "runs": lowered.runs,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = "results/dryrun", force: bool = False,
             rule_opts: dict | None = None, tag: str = "") -> dict:
    """One cell's record, written to ``out_dir/<cell>.json`` (read back
    when it is there, unless ``force``): the reference's ``run_cell``
    (``launch/dryrun.py:77-158``)."""
    mesh_tag = ("multipod" if multi_pod else "singlepod") + tag
    cell = f"{arch}__{shape_name}__{mesh_tag}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    reason = skip_reason(cfg, shape_name)
    rec = {"cell": cell, "arch": arch, "shape": shape_name,
           "mesh": mesh_tag, "status": "skip", "skip_reason": reason}
    if reason is not None:
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    t0 = time.time()
    try:
        lowered, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                   rule_opts=rule_opts)
        rec.update(record(lowered, meta["cfg"], meta["shape"],
                          meta["mesh"]["n_devices"]))
        d = lowered.device
        print({"flops": d.cost.flops, "bytes": d.cost.bytes,
               "wire": float(d.cost.wire_bytes),
               "peak_live": d.peak_live_bytes})
    except Exception as e:  # record the failure; the sweep continues
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[dryrun] {cell} FAILED: {e}")
    rec["seconds"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {cell}: {rec['status']} in {rec['seconds']:.1f}s")
    return rec


def main() -> None:
    """The reference's CLI (``launch/dryrun.py:162-190``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--rule-opt", action="append", default=[],
                    help="sharding-rule switches for perf iterations, e.g. "
                         "kv_seq_sharding / seq_parallel_attn / qk_dim_fallback")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    args = ap.parse_args()
    rule_opts = {k: True for k in args.rule_opt}
    torch.set_num_threads(1)
    if args.all:
        for mp in (False, True):
            for arch in ARCH_IDS:
                cfg = get_config(arch)
                for shape_name in applicable_shapes(cfg):
                    run_cell(arch, shape_name, multi_pod=mp, out_dir=args.out,
                             force=args.force)
        return
    if not args.arch or not args.shape:
        ap.error("need --arch and --shape (or --all)")
    run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
             out_dir=args.out, force=args.force, rule_opts=rule_opts,
             tag=args.tag)


if __name__ == "__main__":
    main()
