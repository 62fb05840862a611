#!/usr/bin/env python
"""Decode against forward, the reference's and the port's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_decode_gap.py \\
        --arch mamba2-1.3b --layers 4 16 [--reduced] [--batch 2] [--prompt 256]

For each depth, one set of weights (the parity weights' distribution drawn
with ``torch``, ``convert.lm_parity_specs``, seed 0) runs through both
packages' ``Model``: a prefill of ``--prompt`` tokens and two decode steps
against the forward over all of them, measured as the reference's
tests/test_arch_smoke.py measures it (max abs difference of the last
logits over max abs logit). Where the two packages print the same gap, it
is the reference's arithmetic, not the port's; chip_smoke.py's per-config
limits cite these numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def gaps(arch: str, layers: int, reduced: bool, batch: int, prompt: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro import configs as jconfigs
    from repro.models.layers import unembed as jax_unembed
    from repro.models.model import Model as JaxModel
    from repro.models.params import ParamSpec as JaxSpec
    from repro_torch import configs
    from repro_torch.convert import lm_parity_specs
    from repro_torch.data.lm_data import SyntheticCorpus
    from repro_torch.models import params as prm
    from repro_torch.models.layers import unembed
    from repro_torch.models.model import Model

    pick = configs.reduced_config if reduced else configs.get_config
    jpick = jconfigs.reduced_config if reduced else jconfigs.get_config
    cfg = dataclasses.replace(pick(arch), n_layers=layers, mtp_depth=0)
    jcfg = dataclasses.replace(jpick(arch), n_layers=layers, mtp_depth=0)
    model, jmodel = Model(cfg), JaxModel(jcfg)
    params = prm.materialize(torch.Generator().manual_seed(0),
                             lm_parity_specs(cfg), "cpu")
    arrays = prm.tree_map(lambda t: t.float().numpy(), params)
    jparams = jax.tree.map(lambda s, a: jnp.asarray(a).astype(s.dtype),
                           jmodel.param_specs(), arrays,
                           is_leaf=lambda x: isinstance(x, JaxSpec))
    toks = SyntheticCorpus(cfg.vocab, seed=1).batch(0, batch, prompt + 2) \
        .astype(np.int32)
    t = torch.from_numpy(toks)
    _, cache = model.prefill(params, {"tokens": t[:, :prompt]},
                             max_seq=prompt + 4)
    for i in range(2):
        logits, cache = model.decode(params, cache,
                                     t[:, prompt + i:prompt + i + 1])
    h, _ = model.forward(params, {"tokens": t})
    want = unembed(params["embed"], h[:, -1:], cfg)
    port = float((logits - want).abs().max() / want.abs().max())
    _, jcache = jax.jit(lambda p, x: jmodel.prefill(
        p, {"tokens": x}, max_seq=prompt + 4))(jparams, toks[:, :prompt])
    decode = jax.jit(jmodel.decode)
    for i in range(2):
        jlogits, jcache = decode(jparams, jcache,
                                 toks[:, prompt + i:prompt + i + 1])
    jh, _ = jax.jit(lambda p, x: jmodel.forward(p, {"tokens": x}))(
        jparams, toks)
    jwant = jax_unembed(jparams["embed"], jh[:, -1:], jcfg)
    ref = float(jnp.max(jnp.abs(jlogits - jwant)) / jnp.max(jnp.abs(jwant)))
    return port, ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, nargs="+", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=256)
    args = ap.parse_args(argv)
    for n in args.layers:
        port, ref = gaps(args.arch, n, args.reduced, args.batch, args.prompt)
        print(f"{args.arch}{' reduced' if args.reduced else ''} {n} layers, "
              f"batch {args.batch} x {args.prompt} + 2: port {port:.4f}, "
              f"reference {ref:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
