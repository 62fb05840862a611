"""Batched serving: one prefill and a greedy decode loop over the zoo.

``python -m repro_torch.launch.serve --arch starcoder2-3b --reduced
--batch 4 --prompt-len 64 --gen 32 --device cpu``

Draws the model's weights from ``--seed`` (``Model.init``), runs a batch
of synthetic prompts (``SyntheticCorpus``) through one prefill, whose
causal self-attention is the port's ``flash_attention`` kernel on the card
wherever it computes the same function (``models/attention.py``), and
``--gen - 1`` greedy decode steps, and reports tokens/s plus per-phase
wall time. An encoder-decoder gets ``frames`` and a VLM ``patches``,
zeros as the reference's ``launch/serve.py`` gives them. ``--layers N``
cuts the config to its first N layers and drops the multi-token-
prediction head, which serving never runs, so that a model too large for
one card serves at its full width. It runs on ``cuda`` unless
``--device`` says otherwise, and raises where there is no card.
``--model-parallel N`` serves the model split over N shards of a
``(1, N)`` mesh's model axis (``mesh.shard_devices``: the visible cards in
turn, so one card, or the CPU, carries every shard) with the reference's
serving rules; ``--kv-seq`` cuts the KV caches by position over those
shards.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.lm_data import SyntheticCorpus
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh, shard_devices
from repro_torch.models.model import Model
from repro_torch.sharding import serve_rules


def setup(args):
    """(model, params, prompts, max_seq) for ``args``, on its device (the
    params placed on the mesh, with ``--model-parallel`` or
    ``--kv-seq``)."""
    dev = ops.resolve_device(getattr(args, "device", None))
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers, mtp_depth=0)
    mesh = rules = None
    if args.model_parallel != 1 or args.kv_seq:
        mesh = make_mesh((1, args.model_parallel), ("data", "model"),
                         shard_devices(dev, args.model_parallel))
        rules = serve_rules(mesh, kv_seq_sharding=args.kv_seq)
    model = Model(cfg, mesh=mesh, rules=rules)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    corpus = SyntheticCorpus(cfg.vocab, seed=args.seed)
    prompts = torch.as_tensor(corpus.batch(0, args.batch, args.prompt_len),
                              device=dev)
    return model, params, prompts, args.prompt_len + args.gen


def frontend_inputs(cfg, batch: int, device) -> dict:
    """The inputs beside the tokens that a config's prefill reads, as the
    reference's ``launch/serve.py`` makes them: zero ``frames`` (B, encoder_seq, d) for
    an encoder-decoder, zero ``patches`` (B, n_frontend_tokens, d) for a
    VLM, in bf16."""
    out = {}
    if cfg.encdec is not None:
        out["frames"] = torch.zeros((batch, cfg.encdec.encoder_seq,
                                     cfg.d_model), dtype=torch.bfloat16,
                                    device=device)
    if cfg.n_frontend_tokens:
        out["patches"] = torch.zeros((batch, cfg.n_frontend_tokens,
                                      cfg.d_model), dtype=torch.bfloat16,
                                     device=device)
    return out


def generate(model, params, prompts, *, gen: int, max_seq: int,
             inputs=None) -> dict:
    """One prefill and ``gen - 1`` greedy decode steps. ``inputs`` are the
    prefill's other inputs (``frames``, ``patches``; by default
    :func:`frontend_inputs`). Tokens stay on the device until the end (one
    host copy); each phase is timed on the host clock up to a device
    synchronisation."""
    dev = prompts.device
    if inputs is None:
        inputs = frontend_inputs(model.cfg, prompts.shape[0], dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts, **inputs},
                                  max_seq=max_seq)
    sync()
    t_prefill = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode(params, cache, tok)
        finite = finite & torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1).to(torch.int32)
        out_tokens.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    b = prompts.shape[0]
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "tokens_per_s": b * (gen - 1) / max(t_decode, 1e-9),
            "generated": torch.cat(out_tokens, dim=1).cpu().numpy(),
            "logits_finite": bool(finite)}


def serve(args) -> dict:
    model, params, prompts, max_seq = setup(args)
    res = generate(model, params, prompts, gen=args.gen, max_seq=max_seq)
    gen = res["generated"]
    print(f"[serve] {model.cfg.name}: batch {args.batch}, prompt "
          f"{args.prompt_len}, gen {args.gen}")
    print(f"[serve] prefill {res['prefill_s']:.2f}s | decode "
          f"{res['decode_s']:.2f}s ({res['tokens_per_s']:.1f} tok/s)")
    print(f"[serve] sample continuation: {gen[0, :16].tolist()}")
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to its first N layers, without "
                    "the MTP head (default: all)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--kv-seq", action="store_true",
                    help="KV caches cut by position over the model axis")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    return ap


def main(argv=None):
    serve(parser().parse_args(argv))


if __name__ == "__main__":
    main()
