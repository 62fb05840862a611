"""Tensor-parallel runs of the reduced dense configs in fp32: the loss and
every gradient, one AdamW update from them, and a prefill plus 3 decode
steps (with caches cut by position, ``kv_seq``, too), on ``(1, 2)``,
``(2, 2)`` and ``(1, 4)`` CPU meshes — each against the unsharded port run (max |diff| within 1e-5 of
the largest magnitude, per tensor; per leaf for the gradients and the
updated parameters) and
against the reference's unsharded ``Model`` on the same numpy weights and
inputs (relative L2 within ``TRAIN_REL``, the fp32 parity tests' limit).
``tests/test_torch_tp_zoo_mixers.py`` runs the other five configs."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402

ARCHS = ("starcoder2-3b", "granite-3-8b", "deepseek-67b",
         "mistral-large-123b", "pixtral-12b")
MESHES = ((1, 2), (2, 2), (1, 4))
TP_REL = 1e-5              # sharded vs unsharded port, fp32
BATCH, PROMPT, STEPS = 4, 16, 3
MAX_SEQ = 24               # cache positions: cut into 2 or 4 slices


def close(got, want, what, rel=TP_REL):
    g = got.detach().double()
    w = want.detach().double()
    scale = float(w.abs().max()) or 1.0
    err = float((g - w).abs().max()) / scale
    assert err <= rel, (what, err)
    return err


def adamw_step(params, grads):
    """(params after one AdamW update from ``grads``, the grad norm), the
    update made on a copy, placed or not."""
    from repro_torch import sharding as shd
    from repro_torch.optim import AdamW, AdamWConfig
    opt = AdamW(AdamWConfig(**fx.train_opt_kw()))
    params = shd.map_tensors(torch.clone, params)
    _, _, met = opt.update(grads, opt.init(params), params,
                           torch.zeros((), dtype=torch.int32))
    return params, met["grad_norm"]


@functools.cache
def unsharded(arch: str):
    """The unsharded port's loss, gradients, prefill and decode logits,
    and the reference's, on ``lm_numpy_params`` weights in fp32."""
    import jax
    import jax.numpy as jnp

    from repro_torch.data.lm_data import to_device
    from repro_torch.train import step as step_mod
    model, jmodel, params, jparams = fx.train_models(arch)
    batch = fx.train_batches(model.cfg, 1, batch=(BATCH, PROMPT + STEPS))[0]
    tb = to_device(batch, "cpu")
    loss, _, grads = step_mod.loss_and_grads(model, params, tb)
    updated, gnorm = adamw_step(params, grads)
    toks = tb["tokens"]
    extra = {k: v for k, v in tb.items() if k in ("frames", "patches")}
    max_seq = MAX_SEQ
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks[:, :PROMPT],
                                               **extra}, max_seq=max_seq,
                                      cache_dtype=torch.float32)
        outs = [logits]
        for i in range(STEPS):
            logits, cache = model.decode(
                params, cache, toks[:, PROMPT + i:PROMPT + i + 1])
            outs.append(logits)
    jb = {k: np.asarray(v) for k, v in batch.items()}
    jextra = {k: v for k, v in jb.items() if k in ("frames", "patches")}
    with fx.fp32_reference():
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss(p, b)[0]))(jparams, jb)
        jl, jc = jax.jit(lambda p, b: jmodel.prefill(
            p, b, max_seq=max_seq, cache_dtype=jnp.float32))(
            jparams, {"tokens": jb["tokens"][:, :PROMPT], **jextra})
        jouts = [np.asarray(jl)]
        dec = jax.jit(jmodel.decode)
        for i in range(STEPS):
            jl, jc = dec(jparams, jc, jnp.asarray(
                jb["tokens"][:, PROMPT + i:PROMPT + i + 1]))
            jouts.append(np.asarray(jl))
    return {"model": model, "params": params, "batch": tb, "loss": loss,
            "grads": grads, "updated": updated, "grad_norm": gnorm,
            "logits": outs, "jloss": float(jloss),
            "jgrads": jgrads, "jlogits": jouts}


def run_sharded(arch: str, shape, kv_seq: bool) -> dict:
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_mod
    ref = unsharded(arch)
    mesh = make_mesh(shape, ("data", "model"),
                     ["cpu"] * int(np.prod(shape)))
    rules = shd.serve_rules(mesh, kv_seq_sharding=True) if kv_seq \
        else shd.train_rules(mesh)
    model = Model(ref["model"].cfg, mesh=mesh, rules=rules)
    params = shd.place_tree(ref["params"], model.param_placements())
    tb = ref["batch"]
    out = {"model": model}
    if not kv_seq:
        loss, _, grads = step_mod.placed_loss_and_grads(model, params, tb)
        out["loss"], out["grads"] = loss, shd.gather_tree(grads)
        updated, out["grad_norm"] = adamw_step(params, grads)
        out["updated"] = shd.gather_tree(updated)
    toks = tb["tokens"]
    extra = {k: v for k, v in tb.items() if k in ("frames", "patches")}
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks[:, :PROMPT],
                                               **extra},
                                      max_seq=MAX_SEQ,
                                      cache_dtype=torch.float32)
        outs = [logits]
        for i in range(STEPS):
            logits, cache = model.decode(
                params, cache, toks[:, PROMPT + i:PROMPT + i + 1])
            outs.append(logits)
    out["logits"], out["cache"] = outs, cache
    return out


def position_split(cache) -> bool:
    """Whether some cache leaf is cut by position over the model axis."""
    from repro_torch import tree as tr
    for t in tr.leaves(cache["stacks"]):
        pl = t.placement
        if "kv_seq" in pl.logical and "model" in pl.dim_axes(
                pl.logical.index("kv_seq")):
            return True
    return False


def check_arch(arch: str, shape):
    from repro_torch import tree as tr
    ref = unsharded(arch)
    got = run_sharded(arch, shape, kv_seq=False)
    close(got["loss"], ref["loss"], "loss")
    for i, (g, w) in enumerate(zip(tr.leaves(got["grads"]),
                                   tr.leaves(ref["grads"]))):
        close(g, w, f"grad {i}")
    fx.assert_grads_match(arch, got["grads"], ref["jgrads"])
    close(got["grad_norm"], ref["grad_norm"], "grad norm")
    lr = float(fx.train_opt_kw()["lr"]) / fx.train_opt_kw()["warmup_steps"]
    for i, (p, w, gr) in enumerate(zip(tr.leaves(got["updated"]),
                                       tr.leaves(ref["updated"]),
                                       tr.leaves(ref["grads"]))):
        # Adam's first step moves an element by ~lr * g / (|g| + eps): an
        # element whose gradient sits at rounding level (below 1e-4 of its
        # leaf's largest) may step anywhere within 2 lr; the rest within
        # TP_REL of the leaf's largest value
        diff = (p.double() - w.double()).abs()
        live = diff[gr.abs() > 1e-4 * gr.abs().max()]
        if live.numel():
            assert float(live.max()) <= TP_REL * float(w.abs().max()), \
                (f"updated leaf {i}", float(live.max()))
        assert float(diff.max()) <= 2 * lr, (f"updated leaf {i}", lr)
    np.testing.assert_allclose(float(got["loss"]), ref["jloss"],
                               rtol=fx.TRAIN_REL)
    for kv_seq in (False, True):
        run = got if not kv_seq else run_sharded(arch, shape, kv_seq=True)
        if kv_seq and ref["model"].cfg.family.value not in ("ssm",):
            assert position_split(run["cache"]), "no cache cut by position"
        for i, (lg, w, jw) in enumerate(zip(run["logits"], ref["logits"],
                                            ref["jlogits"])):
            close(lg, w, f"logits {i} kv_seq={kv_seq}")
            assert fx.rel_l2(lg.numpy(), jw) < fx.TRAIN_REL, (i, kv_seq)
    return got


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_config_sharded_matches(arch, shape):
    check_arch(arch, shape)
