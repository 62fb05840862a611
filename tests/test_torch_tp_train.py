"""Training and serving on tensor-parallel placements: ``jit_train_step``
on a ``(2, 2)`` CPU mesh against the unsharded step, the global norm and
the int8 scale on a state with split and replicated leaves, checkpoints
crossing between sharded and unsharded states, elastic resume that keeps
the model axis, and the launchers' ``--model-parallel`` / ``--kv-seq``
against their unsharded runs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402

from repro_torch import sharding as shd  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim import (AdamW, AdamWConfig, global_norm,  # noqa: E402
                               quantize_int8)
from repro_torch.train import step as step_mod  # noqa: E402

ARCH = "starcoder2-3b"
REL = 1e-5


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     ["cpu"] * int(np.prod(shape)))


def _rel(got, want) -> float:
    g, w = got.detach().double(), want.detach().double()
    return float((g - w).abs().max() / (w.abs().max() + 1e-30))


def _state(model, opt, params):
    return {"step": torch.zeros((), dtype=torch.int32),
            "params": tr.tree_map(torch.clone, params),
            "opt": opt.init(params)}


def _placed_run(shape, steps, *, compress=False):
    """(model, per-step metrics, final state) of ``steps`` fp32 steps on
    ``shape``, and the unsharded run's."""
    model, _, params, _ = fx.train_models(ARCH)
    batches = fx.train_batches(model.cfg, steps, batch=(4, 16))
    opt = AdamW(AdamWConfig(**fx.train_opt_kw(), compress_grads=compress))
    mesh = _mesh(shape)
    rules = shd.train_rules(mesh)
    cell = ShapeConfig("t", 16, 4, "train")
    placed = shd.place_tree(
        _state(model, opt, params),
        step_mod.train_state_shardings(model, opt, mesh, rules))
    step = step_mod.jit_train_step(model, opt, mesh, rules, cell)
    plain = _state(model, opt, params)
    plain_step = step_mod.make_train_step(model, opt)
    mets, want = [], []
    for b in batches:
        placed, m = step(placed, b)
        plain, w = plain_step(plain, b)
        mets.append(m)
        want.append(w)
    return mets, want, placed, plain


def test_train_step_on_a_2x2_mesh_is_the_unsharded_step():
    """Two AdamW steps: loss, grad norm and lr within 1e-5, every
    parameter and moment within 1e-5 of its largest magnitude."""
    mets, want, placed, plain = _placed_run((2, 2), 2)
    for m, w in zip(mets, want):
        for k in ("loss", "grad_norm", "lr", "ce"):
            np.testing.assert_allclose(float(m[k]), float(w[k]), rtol=REL,
                                       err_msg=k)
    assert int(placed["step"]) == 2
    wq = placed["params"]["layers"]["attn"]["wq"]
    assert isinstance(wq, shd.Sharded) and wq.placement.splits("model")
    whole = shd.gather_tree(placed)
    for i, (g, w) in enumerate(zip(tr.leaves(whole), tr.leaves(plain))):
        assert _rel(g, w) <= REL, (i, _rel(g, w))


def test_train_step_with_int8_compression_on_a_mesh():
    """Three steps with int8 error feedback on (1, 2): the metrics, and
    each replicated block's error term and parameters equal on its
    replicas (they drift apart where two entries share one gradient
    tensor, which the compression rewrites in place). The parameters
    are not held to the unsharded run's: a reordered sum moves a gradient
    across an int8 rounding boundary, a step of a whole scale unit."""
    mets, want, placed, plain = _placed_run((1, 2), 3, compress=True)
    for m, w in zip(mets, want):
        np.testing.assert_allclose(float(m["loss"]), float(w["loss"]),
                                   rtol=REL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(w["grad_norm"]), rtol=REL)
    for x in tr.leaves(placed["opt"]["err"]) + tr.leaves(placed["params"]):
        for grp in x.placement.replicas():
            for i in grp[1:]:
                assert torch.equal(x.shards[i], x.shards[grp[0]])


def test_global_norm_and_int8_scale_count_each_block_once():
    """On a (2, 2) placement — norms replicated over the model axis,
    attention split over it, everything split over data by FSDP — the
    norm and the int8 scale are the whole tree's; counting every shard's
    copy would not be."""
    model, _, params, _ = fx.train_models(ARCH)
    mesh = _mesh((2, 2))
    placed = shd.place_tree(params, step_mod.on_mesh(
        model, mesh, shd.train_rules(mesh)).param_placements())
    ln = placed["final_norm"]
    assert not ln.placement.splits("model") and ln.placement.splits("data")
    np.testing.assert_allclose(float(global_norm(placed)),
                               float(global_norm(params)), rtol=1e-6)
    naive = torch.sqrt(sum(torch.sum(torch.square(t.float()))
                           for x in tr.leaves(placed) for t in x.shards))
    assert float(naive) > 1.1 * float(global_norm(params))
    for path in (("layers", "attn", "wq"), ("final_norm",)):
        x, w = placed, params
        for k in path:
            x, w = x[k], w[k]
        q, scale = quantize_int8(x)
        q_want, scale_want = quantize_int8(w)
        assert float(scale) == float(scale_want)
        assert torch.equal(q.gather(), q_want)


def test_checkpoints_cross_between_sharded_and_unsharded(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    _, _, placed, plain = _placed_run((2, 2), 1)
    model, _, _, _ = fx.train_models(ARCH)
    opt = AdamW(AdamWConfig(**fx.train_opt_kw()))
    like = step_mod.abstract_train_state(model, opt)
    # sharded -> unsharded
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(1, placed)
    got, _ = mgr.restore(1, like)
    for g, w in zip(tr.leaves(got), tr.leaves(shd.gather_tree(placed))):
        assert torch.equal(g, w)
    # unsharded -> sharded, onto another mesh
    mgr = CheckpointManager(str(tmp_path / "b"))
    mgr.save(1, plain)
    mesh = _mesh((1, 4))
    sh = step_mod.train_state_shardings(model, opt, mesh,
                                        shd.train_rules(mesh))
    got, _ = mgr.restore(1, like, shardings=sh)
    wq = got["params"]["layers"]["attn"]["wq"]
    assert wq.placement.mesh == mesh and len(wq.shards) == 4
    for g, w in zip(tr.leaves(shd.gather_tree(got)), tr.leaves(plain)):
        assert torch.equal(g, w)


def test_elastic_resume_keeps_the_model_axis(tmp_path):
    """A (2, 2) run checkpoints after 2 steps; elastic resume on two
    surviving entries re-meshes to (1, 2) — the model axis whole — and
    its third step is the uninterrupted (2, 2) run's within 1e-6."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import elastic
    model, _, params, _ = fx.train_models(ARCH)
    batches = fx.train_batches(model.cfg, 3, batch=(4, 16))
    opt = AdamW(AdamWConfig(**fx.train_opt_kw()))
    cell = ShapeConfig("t", 16, 4, "train")
    plan = elastic.plan_mesh(["cpu"] * 4, model_size=2)
    assert plan.mesh.shape == {"data": 2, "model": 2}

    def shardings(mesh, rules):
        return step_mod.train_state_shardings(model, opt, mesh, rules)
    state = shd.place_tree(_state(model, opt, params),
                                       shardings(plan.mesh, plan.rules))
    step = step_mod.jit_train_step(model, opt, plan.mesh, plan.rules, cell)
    for b in batches[:2]:
        state, _ = step(state, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    _, want = step(state, batches[2])
    small = elastic.plan_mesh(elastic.simulate_failure(["cpu"] * 4, 2),
                              model_size=2)
    assert small.mesh.shape == {"data": 1, "model": 2}
    k, resumed = elastic.resume_state(
        mgr, step_mod.abstract_train_state(model, opt), small, shardings)
    assert k == 2
    assert resumed["params"]["layers"]["ffn"]["up"].placement.mesh == \
        small.mesh
    step2 = step_mod.jit_train_step(model, opt, small.mesh, small.rules,
                                    cell)
    _, got = step2(resumed, batches[2])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-v3-671b",
                                  "recurrentgemma-2b"])
@pytest.mark.parametrize("extra", [("--model-parallel", "2"),
                                   ("--model-parallel", "4", "--kv-seq"),
                                   ("--kv-seq",)])
def test_serve_cli_options_give_the_unsharded_tokens(arch, extra, capsys):
    """``python -m repro_torch.launch.serve`` with the mesh options on
    the CPU: the same generated tokens as the unsharded CLI (fp32
    weights of the reduced config, so that no bf16 tie decides)."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "8"]
    cfg32 = dataclasses.replace(reduced_config(arch), dtype="float32")

    def run(argv):
        args = serve.parser().parse_args(argv)
        model, params, prompts, max_seq = serve.setup(args)
        model = Model(cfg32, mesh=model.mesh, rules=model.rules)
        params = shd.map_tensors(lambda t: t.float(), params)
        return serve.generate(model, params, prompts, gen=args.gen,
                              max_seq=max_seq)["generated"]
    want = run(base)
    got = run(base + list(extra))
    assert np.array_equal(got, want)
    serve.main(base + list(extra))
    assert "sample continuation" in capsys.readouterr().out


def test_train_cli_model_parallel_is_the_unsharded_run(tmp_path):
    """``python -m repro_torch.launch.train --model-parallel 2`` (and
    with 2 data shards beside it) on the CPU: fp32 losses within 1e-5 of
    the one-shard run's, checkpoints of whole tensors."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as launcher

    def argv(ckpt, *extra):
        return ["--arch", ARCH, "--reduced", "--device", "cpu", "--dtype",
                "float32", "--batch", "4", "--seq", "16", "--lr", "1e-3",
                "--warmup", "2", "--steps", "3", "--ckpt-dir", str(ckpt),
                *extra]
    one = launcher.train(launcher.parse_args(argv(tmp_path / "one")))
    for name, extra in (("tp", ("--model-parallel", "2")),
                        ("dp_tp", ("--model-parallel", "2", "--data-shards",
                                   "2"))):
        out = launcher.train(launcher.parse_args(argv(tmp_path / name,
                                                      *extra)))
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=REL)
    got, _ = CheckpointManager(str(tmp_path / "dp_tp")).restore(
        3, shd.gather_tree(one["state"]))
    assert got["params"]["layers"]["attn"]["wq"].shape == (2, 64, 4, 16)


def test_placed_params_are_freed_without_the_cyclic_collector():
    """A prefill and a decode on (1, 2) leave no reference cycle that
    holds the placed parameters: with the cyclic collector off, deleting
    the tree frees every shard (on the card, its memory)."""
    import gc
    import weakref
    model, _, params, _ = fx.train_models(ARCH)
    mesh = _mesh((1, 2))
    tp = step_mod.on_mesh(model, mesh, shd.serve_rules(mesh))
    tokens = torch.as_tensor(fx.train_batches(model.cfg, 1)[0]["tokens"])
    gc.collect()
    gc.disable()
    try:
        placed = shd.place_tree(params, tp.param_placements())
        refs = [weakref.ref(t) for x in tr.leaves(placed) for t in x.shards]
        with torch.no_grad():
            logits, cache = tp.prefill(placed, {"tokens": tokens},
                                       max_seq=tokens.shape[1] + 2)
            tp.decode(placed, cache, torch.argmax(logits[:, -1:], -1))
        del placed, cache
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
    assert alive == 0, f"{alive} of {len(refs)} shards still held"
