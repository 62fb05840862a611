"""The LM training driver, the JAX package's ``launch/train.py`` in
PyTorch.

``python -m repro_torch.launch.train --arch starcoder2-3b --reduced
--steps 10 --device cpu``

Wires together: config registry -> mesh and rules
(``ft.elastic.plan_mesh``) -> model on the mesh -> train step (FSDP over
the data axis, tensor parallel over ``--model-parallel`` shards) ->
synthetic data on a prefetch thread -> AdamW -> checkpoints
(asynchronous, resumed automatically from ``--ckpt-dir``) -> watchdog.
A run killed mid-way (``--fail-at-step``, or for real) restarts from the
last committed checkpoint, on as many data shards as it now has, the
model axis kept whole.

The reference's flags, plus ``--device`` (``cuda`` by default, which
must exist; ``cpu`` runs the plain versions), ``--data-shards`` (the data
axis: by default one shard per visible CUDA device, or one on the CPU; a
device may carry several shards, which run in turn), ``--layers`` (the
config cut to its first N layers, the MTP head kept), ``--dtype``
(``float32`` trains an fp32 model throughout) and ``--init parity``. The
reference's ``Model.init`` draws attention weights with std
1/sqrt(heads) (ROADMAP, reference caveat 4): at StarCoder2-3B's full
depth its gradient norm runs to millions and more, the clip to 1 leaves
each update below Adam's eps, and a bf16 model does not move; ``--init
parity`` draws std 1/sqrt(contracted size) instead
(``convert.lm_parity_specs``), a model that trains. ``--model-parallel
N`` splits the model over N shards of the mesh's model axis; the mesh's
entries are ``shard_devices(device, data_shards * N)``, so one card (or
the CPU) carries every shard, in turn.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import lm_parity_specs
from repro_torch.data.lm_data import (Prefetcher, SyntheticCorpus,
                                      make_train_batch, to_device)
from repro_torch.ft.elastic import plan_mesh, resume_state
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.kernels import ops
from repro_torch.launch.mesh import mesh_devices
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train import step as step_mod


def config(args):
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return dataclasses.replace(cfg, dtype=args.dtype)


def build(args):
    cfg = config(args)
    plan = plan_mesh(mesh_devices(args.device, args.data_shards,
                                  args.model_parallel),
                     model_size=args.model_parallel)
    model = Model(cfg, mesh=plan.mesh, rules=plan.rules)
    opt = AdamW(AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                            total_steps=args.steps,
                            compress_grads=args.compress_grads))
    shape = ShapeConfig("cli", args.seq, args.batch, "train",
                        num_microbatches=args.microbatches)
    step = step_mod.jit_train_step(model, opt, plan.mesh, plan.rules, shape,
                                   n_moe_groups=plan.data_size)
    return cfg, plan, model, opt, shape, step


def train(args) -> dict:
    cfg, plan, model, opt, shape, step_fn = build(args)
    dev = plan.mesh.flat()[0]
    ckpt = CheckpointManager(args.ckpt_dir, keep=args.keep)
    corpus = SyntheticCorpus(cfg.vocab, seed=args.seed)

    abstract = step_mod.abstract_train_state(model, opt)
    start_step = 0
    resumed = resume_state(
        ckpt, abstract, plan,
        lambda mesh, rules: step_mod.train_state_shardings(model, opt, mesh,
                                                           rules))
    if resumed is not None:
        start_step, state = resumed
        print(f"[train] resumed from step {start_step} on "
              f"{plan.n_devices} devices")
    else:
        specs = lm_parity_specs(cfg) if args.init == "parity" else None
        state = step_mod.init_train_state(
            model, opt, torch.Generator(device=dev).manual_seed(args.seed),
            dev, specs=specs)

    def make_batch(step):
        return make_train_batch(corpus, step, global_batch=shape.global_batch,
                                seq=shape.seq_len,
                                num_microbatches=shape.num_microbatches)

    prefetch = Prefetcher(make_batch, depth=2, start_step=start_step)
    watchdog = StepWatchdog(hang_timeout=args.hang_timeout)
    losses, seconds = [], []
    try:
        for step in range(start_step, args.steps):
            _, batch = prefetch.next()
            if args.fail_at_step is not None and step == args.fail_at_step:
                raise RuntimeError("injected failure (test)")
            watchdog.step_begin()
            state, metrics = step_fn(state, to_device(batch, dev))
            loss = float(metrics["loss"])         # waits for the step
            wd = watchdog.step_end(step)
            losses.append(loss)
            seconds.append(wd["step_seconds"])
            if step % args.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({wd['step_seconds']:.2f}s)")
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                ckpt.save(step + 1, state, blocking=False,
                          metadata={"loss": loss, "arch": cfg.name})
    finally:
        prefetch.close()
        ckpt.wait()
    return {"losses": losses, "stragglers": watchdog.stragglers,
            "final_step": args.steps, "start_step": start_step,
            "step_seconds": seconds, "state": state}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int,
                    default=ops.microbatches_override() or 1,
                    help="gradient-accumulation microbatches (default: "
                    "REPRO_MICROBATCHES, else 1)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--hang-timeout", type=float, default=1800.0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--data-shards", type=int, default=None,
                    help="data-parallel shards (default: one per CUDA "
                    "device, one on the CPU)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to its first N layers")
    ap.add_argument("--init", default="reference",
                    choices=("reference", "parity"),
                    help="initial weights: the reference's Model.init, or "
                    "the parity distribution (std 1/sqrt(contracted size))")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the model's parameter and activation dtype")
    return ap.parse_args(argv)


def main(argv=None):
    out = train(parse_args(argv))
    print(f"[train] done: final loss {out['losses'][-1]:.4f}, "
          f"{out['stragglers']} straggler events")


if __name__ == "__main__":
    main()
