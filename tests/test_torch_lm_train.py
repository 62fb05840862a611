"""LM training parity (``repro_torch.train.step``, ``optim``,
``models.model.Model.loss``) against the JAX package, for the dense
decoders and the VLM in fp32 (tests/test_torch_lm_train_zoo.py holds the
other five configs, tests/test_torch_lm_train_bf16.py all ten in bf16),
and the microbatches, data parallelism, the routing rule under autograd
and the launcher's crash and elastic resume.

fp32 (``cfg.dtype = "float32"`` in the port; the reference's model module
swapped to float32 by ``test_torch_fixtures.fp32_reference``): from
``lm_numpy_params(cfg, 0)`` and the launcher's ``make_train_batch``
batches, every leaf's gradient at step 0 and three AdamW steps' metrics
and parameters within 1e-4 (relative L2 for tensors). bf16: one step per
config, the loss within 2e-2 (the reference's own sharded-vs-single
bound, tests/test_distributed.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import test_torch_fixtures as fx  # noqa: E402

DENSE = ["starcoder2-3b", "granite-3-8b", "deepseek-67b",
         "mistral-large-123b", "pixtral-12b"]


@pytest.mark.parametrize("arch", DENSE)
def test_fp32_train_steps_match_reference(arch):
    fx.assert_train_matches_reference(arch)



# --- microbatches and data parallelism ---------------------------------------------

def _port_steps(arch, batches, *, mesh=None, num_microbatches=1,
                n_moe_groups=1, dtype="float32"):
    """The port's metrics of each step and its final params (whole), from
    the parity weights: ``make_train_step`` on one device, or
    ``jit_train_step`` on a state placed on ``mesh``."""
    from repro_torch import sharding as shd
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import step as step_mod
    model, _, params, _ = fx.train_models(arch, dtype)
    opt = AdamW(AdamWConfig(**fx.train_opt_kw()))
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": opt.init(params)}
    if mesh is None:
        train = step_mod.make_train_step(model, opt,
                                         num_microbatches=num_microbatches,
                                         n_moe_groups=n_moe_groups)
    else:
        rules = shd.train_rules(mesh)
        cell = ShapeConfig("t", batches[0]["tokens"].shape[-1],
                           batches[0]["tokens"].shape[-2], "train",
                           num_microbatches=num_microbatches)
        state = shd.place_tree(state, step_mod.train_state_shardings(
            model, opt, mesh, rules))
        train = step_mod.jit_train_step(model, opt, mesh, rules, cell,
                                        n_moe_groups=n_moe_groups)
    mets = []
    for b in batches:
        state, m = train(state, b)
        mets.append({k: float(v) for k, v in m.items()})
    return mets, shd.gather_tree(state["params"])


def _rel_params(a, b) -> float:
    from repro_torch import tree as tr
    return max(fx.train_rel(x.numpy(), y.numpy())
               for x, y in zip(tr.leaves(a), tr.leaves(b)))


def test_microbatches_match_reference():
    """M = 2 (microbatch-major batches, fp32 accumulation, bf16 grads) for
    two steps against the reference's M = 2 step."""
    import jax.numpy as jnp

    from repro.optim import AdamW as JaxAdamW, AdamWConfig as JaxAdamWConfig
    from repro.train import step as jstep
    from repro_torch import tree as tr
    arch = "granite-3-8b"
    model, jmodel, _, jparams = fx.train_models(arch)
    batches = fx.train_batches(model.cfg, 2, num_microbatches=2,
                               batch=(4, 16))
    assert batches[0]["tokens"].shape == (2, 2, 16)
    jopt = JaxAdamW(JaxAdamWConfig(**fx.train_opt_kw()))
    with fx.fp32_reference():
        jtrain = jax.jit(jstep.make_train_step(jmodel, jopt,
                                               num_microbatches=2))
        jstate = {"step": jnp.zeros((), jnp.int32), "params": jparams,
                  "opt": jopt.init(jparams)}
        jmets = []
        for b in batches:
            jstate, m = jtrain(jstate, b)
            jmets.append(m)
    mets, params = _port_steps(arch, batches, num_microbatches=2)
    for got, want in zip(mets, jmets):
        assert sorted(got) == sorted(want) == ["grad_norm", "loss", "lr"]
        for k in got:
            np.testing.assert_allclose(got[k], float(want[k]),
                                       rtol=fx.TRAIN_REL)
    worst = max(fx.train_rel(p.numpy(), w) for p, w in zip(
        tr.leaves(params), jax.tree.leaves(jstate["params"])))
    assert worst < fx.TRAIN_REL


def test_four_shard_mesh_equals_one_device():
    """A dense config's ``jit_train_step`` on a (4, 1) CPU mesh (each data
    row's NLL over its quarter of the batch, FSDP's embed split over the
    rows) — the one-device step up to summation order (1e-5), two steps,
    also with M = 2 on (2, 1)."""
    from repro_torch.launch.mesh import make_mesh
    arch = "granite-3-8b"
    model, _, _, _ = fx.train_models(arch)
    batches = fx.train_batches(model.cfg, 2, batch=(8, 16))
    one, p1 = _port_steps(arch, batches)
    four, p4 = _port_steps(arch, batches, mesh=make_mesh(
        (4, 1), ("data", "model"), ["cpu"] * 4))
    for a, b in zip(four, one):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert _rel_params(p4, p1) < 1e-5
    mb = fx.train_batches(model.cfg, 1, num_microbatches=2, batch=(8, 16))
    m1, q1 = _port_steps(arch, mb, num_microbatches=2)
    m2, q2 = _port_steps(arch, mb, num_microbatches=2, mesh=make_mesh(
        (2, 1), ("data", "model"), ["cpu"] * 2))
    np.testing.assert_allclose(m2[0]["loss"], m1[0]["loss"], rtol=1e-5)
    assert _rel_params(q2, q1) < 1e-4


def _routed_tokens(monkeypatch):
    """A spy on ``moe._routing``: the token count of each call."""
    from repro_torch.models import moe
    calls = []
    real = moe._routing

    def spy(params, x_flat, cfg, load=False):
        calls.append(x_flat.shape[0] * x_flat.shape[1])
        return real(params, x_flat, cfg, load=load)
    monkeypatch.setattr(moe, "_routing", spy)
    return calls


def test_moe_mesh_shards_keep_their_groups(monkeypatch):
    """DeepSeekMoE's ``jit_train_step`` on a (4, 1) mesh against one
    device, with 4 MoE groups: each row routes its own quarter of the
    batch as one group (no token routed twice), and the aux loss is the
    whole batch's from the rows' summed router loads, so CE, aux and loss
    agree to summation order (1e-5)."""
    from repro_torch.launch.mesh import make_mesh
    arch = "deepseek-moe-16b"
    model, _, _, _ = fx.train_models(arch)
    batches = fx.train_batches(model.cfg, 1, batch=(8, 16))
    one, p1 = _port_steps(arch, batches, n_moe_groups=4)
    calls = _routed_tokens(monkeypatch)
    four, p4 = _port_steps(arch, batches, n_moe_groups=4, mesh=make_mesh(
        (4, 1), ("data", "model"), ["cpu"] * 4))
    # each MoE layer's forward and its recomputation in the backward
    assert model.cfg.remat_policy == "full"
    passes = 2 * (model.cfg.n_layers - model.cfg.moe.first_dense)
    assert calls == [2 * 16] * (4 * passes)
    for k in ("ce", "aux", "loss", "grad_norm"):
        np.testing.assert_allclose(four[0][k], one[0][k], rtol=1e-5,
                                   err_msg=k)
    assert four[0]["aux"] > 0
    assert _rel_params(p4, p1) < 1e-5


def test_moe_mesh_routes_the_whole_batch_once(monkeypatch):
    """With one MoE group, which no row's bounds fall on, a (2, 1) mesh
    routes the gathered batch once, on row 0: the one-device step's
    dispatch, CE, aux and loss to summation order (1e-5)."""
    from repro_torch.launch.mesh import make_mesh
    arch = "deepseek-moe-16b"
    model, _, _, _ = fx.train_models(arch)
    batches = fx.train_batches(model.cfg, 1, batch=(8, 16))
    one, p1 = _port_steps(arch, batches)
    calls = _routed_tokens(monkeypatch)
    two, p2 = _port_steps(arch, batches, mesh=make_mesh(
        (2, 1), ("data", "model"), ["cpu"] * 2))
    passes = 2 * (model.cfg.n_layers - model.cfg.moe.first_dense)
    assert calls == [8 * 16] * passes
    for k in ("ce", "aux", "loss", "grad_norm"):
        np.testing.assert_allclose(two[0][k], one[0][k], rtol=1e-5,
                                   err_msg=k)
    assert _rel_params(p2, p1) < 1e-5


def test_tensor_parallel_placement_raises():
    """Placement on a mesh with a model axis: the train state's leaves
    resolve to placements on the mesh's devices (the step counter on its
    first device), a split spec gives each entry its block, and a
    data-only mesh places every leaf on the CPU entries."""
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import step as step_mod
    model, _, _, _ = fx.train_models("starcoder2-3b")
    mesh = make_mesh((1, 2), ("data", "model"), ["cpu"] * 2)
    opt = AdamW(AdamWConfig())
    sh = step_mod.train_state_shardings(model, opt, mesh,
                                        shd.train_rules(mesh))
    assert sh["step"] == torch.device("cpu")
    wq = sh["params"]["layers"]["attn"]["wq"]
    assert wq.spec == (None, "data", "model") and wq.shard_shape == (
        2, 64, 2, 16)
    pl = shd.train_rules(mesh).sharding(mesh, ("embed", "mlp"), (64, 128))
    assert pl.shard_shape == (64, 64) and pl.devices == [
        torch.device("cpu")] * 2
    dp = make_mesh((2, 1), ("data", "model"), ["cpu"] * 2)
    sh = step_mod.train_state_shardings(model, opt, dp, shd.train_rules(dp))
    from repro_torch import tree as tr
    assert {str(d) for p in tr.leaves(sh["params"]) for d in p.devices} \
        == {"cpu"}


# --- the routing rule under autograd -------------------------------------------------

def test_training_forward_never_launches_flash(monkeypatch):
    """A spy on ``ops.flash_attention``: the loss under autograd calls it
    0 times (the kernel has no backward); a prefill, once a layer."""
    from repro_torch import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.train import step as step_mod
    calls = []
    real = ops.flash_attention

    def spy(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)
    monkeypatch.setattr(ops, "flash_attention", spy)
    model, _, params, _ = fx.train_models("starcoder2-3b", "bfloat16")
    batch = fx.train_batches(model.cfg, 1)[0]
    from repro_torch.data.lm_data import to_device
    tb = to_device(batch, "cpu")
    loss, _, grads = step_mod.loss_and_grads(model, params, tb)
    assert calls == []
    assert all(torch.isfinite(g.float()).all()
               for g in tr.leaves(grads))
    with torch.no_grad():
        model.prefill(params, {"tokens": tb["tokens"]}, max_seq=32)
    assert len(calls) == model.cfg.n_layers


# --- the launcher: crash, elastic resume, a reference checkpoint ---------------

def _argv(ckpt, *extra):
    return ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
            "--dtype", "float32", "--batch", "4", "--seq", "16",
            "--lr", "1e-3", "--warmup", "2", "--log-every", "1",
            "--ckpt-dir", str(ckpt), *extra]


def test_launcher_crash_and_elastic_resume(tmp_path, capsys):
    """Four CPU shards crash at step 6 after the step-4 checkpoint; the
    restart on two shards resumes from step 4, and its steps 4-7 equal an
    uninterrupted one-shard run's (fp32, to summation order)."""
    from repro_torch.launch import train as launcher
    full = launcher.train(launcher.parse_args(
        _argv(tmp_path / "full", "--steps", "8", "--data-shards", "1")))
    argv = _argv(tmp_path / "run", "--steps", "8", "--ckpt-every", "4")
    with pytest.raises(RuntimeError, match="injected failure"):
        launcher.main(argv + ["--data-shards", "4", "--fail-at-step", "6"])
    launcher.main(argv + ["--data-shards", "2"])
    out = capsys.readouterr().out
    assert "resumed from step 4 on 2 devices" in out and "done" in out
    resumed = [float(line.split()[4]) for line in out.splitlines()
               if line.startswith("[train] step ")][-4:]
    np.testing.assert_allclose(resumed, full["losses"][4:], rtol=1e-4)
    from repro_torch.checkpoint import CheckpointManager
    assert CheckpointManager(str(tmp_path / "run")).steps() == [4, 8]


def test_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """The reference trains 4 fp32 steps and checkpoints (raw codec); the
    port's launcher resumes from it, and its step-5 loss is the
    reference's own continuation within 1e-4."""
    import jax.numpy as jnp

    import repro.checkpoint.manager as jmanager
    from repro.optim import AdamW as JaxAdamW, AdamWConfig as JaxAdamWConfig
    from repro.train import step as jstep
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(jmanager, "zstd", None)
    model, jmodel, _, jparams = fx.train_models("starcoder2-3b")
    batches = fx.train_batches(model.cfg, 5, batch=(4, 16))
    jopt = JaxAdamW(JaxAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5))
    with fx.fp32_reference():
        jtrain = jax.jit(jstep.make_train_step(jmodel, jopt))
        st = {"step": jnp.zeros((), jnp.int32), "params": jparams,
              "opt": jopt.init(jparams)}
        for b in batches[:4]:
            st, _ = jtrain(st, b)
        jmanager.CheckpointManager(str(tmp_path)).save(4, st)
        _, want = jtrain(st, batches[4])
    out = launcher.train(launcher.parse_args(_argv(tmp_path, "--steps",
                                                   "5")))
    assert out["start_step"] == 4 and len(out["losses"]) == 1
    np.testing.assert_allclose(out["losses"][0], float(want["loss"]),
                               rtol=fx.TRAIN_REL)


def test_launcher_defaults_to_cuda_and_raises_without_a_card(monkeypatch,
                                                              tmp_path):
    from repro_torch.ft import elastic
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "starcoder2-3b", "--reduced", "--steps", "1",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(argv)
    out = launcher.train(launcher.parse_args(
        argv + ["--device", "cpu", "--model-parallel", "2"]))
    assert out["final_step"] == 1 and np.isfinite(out["losses"][0])
    assert out["state"]["params"]["layers"]["attn"]["wq"].placement \
        .mesh.shape == {"data": 1, "model": 2}
    for fn in (elastic.plan_mesh, mesh_mod.make_host_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    plan = elastic.plan_mesh(["cpu"] * 5, model_size=2)
    assert plan.mesh.shape == {"data": 2, "model": 2}
    assert (plan.n_devices, plan.data_size) == (5, 2)
    assert elastic.simulate_failure(list(range(8)), 3) == list(range(5))


def test_train_record_covers_every_leaf_of_the_cut_model():
    """The committed JAX training record (``--regen-lm-train``) that
    chip_smoke.py holds the card to: StarCoder2-3B at full width cut to 2
    layers, one gradient norm (> 0) and one update norm per leaf of the
    port's parameter tree, finite per-step losses."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import params as prm
    from repro_torch.models.model import Model
    with np.load(fx.LM_TRAIN_RECORD) as z:
        rec = {k: z[k] for k in z.files}
    n = int(rec["n_layers"])
    assert n == fx.LM_TRAIN_LAYERS
    assert tuple(rec["batch"]) == fx.LM_TRAIN_BATCH
    cfg = dataclasses.replace(configs.get_config("starcoder2-3b"),
                              n_layers=n)
    paths = [p for p, _ in prm.leaves(Model(cfg).param_specs())]
    assert sorted(k[len("grad_norm/"):] for k in rec
                  if k.startswith("grad_norm/")) == sorted(paths)
    assert sorted(k[len("update_norm/"):] for k in rec
                  if k.startswith("update_norm/")) == sorted(paths)
    assert all(rec[f"grad_norm/{p}"] > 0 and rec[f"update_norm/{p}"] > 0
               for p in paths)
    for k in ("loss", "grad_norm", "lr"):
        assert rec[k].shape == (fx.LM_TRAIN_STEPS,)
        assert np.isfinite(rec[k]).all()


@pytest.mark.parametrize("arch", ["granite-3-8b", "whisper-base",
                                  "recurrentgemma-2b"])
def test_remat_policies_give_the_same_gradients(arch):
    """``"none"``, ``"full"`` (recompute each layer in the backward) and
    ``"dots"`` (keep the products) change what is stored, not what is
    computed: equal losses and gradients, bit for bit, on the CPU."""
    import dataclasses

    from repro_torch import tree as tr
    from repro_torch.data.lm_data import to_device
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_mod
    model, _, params, _ = fx.train_models(arch)
    batch = to_device(fx.train_batches(model.cfg, 1)[0], "cpu")
    out = {}
    for policy in ("none", "full", "dots"):
        m = Model(dataclasses.replace(model.cfg, remat_policy=policy))
        loss, _, grads = step_mod.loss_and_grads(m, params, batch)
        out[policy] = (float(loss), tr.leaves(grads))
    for policy in ("full", "dots"):
        assert out[policy][0] == out["none"][0]
        for a, b in zip(out[policy][1], out["none"][1]):
            assert torch.equal(a, b), policy


def test_parity_init_draws_std_one_over_sqrt_contracted(tmp_path):
    """``--init parity`` draws ``wq`` with std 1/sqrt(d_model), where the
    reference's ``Model.init`` draws 1/sqrt(heads) (its ``_fan_in``
    axis); the state starts at step 0 either way."""
    from repro_torch.launch import train as launcher
    cfg = fx.train_models("starcoder2-3b")[0].cfg
    stds = {}
    for init in ("reference", "parity"):
        out = launcher.train(launcher.parse_args(
            ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
             "--steps", "1", "--lr", "1e-9", "--init", init,
             "--ckpt-dir", str(tmp_path / init)]))
        stds[init] = float(out["state"]["params"]["layers"]["attn"]["wq"]
                           .float().std())
    np.testing.assert_allclose(stds["parity"], cfg.d_model ** -0.5,
                               rtol=0.1)
    np.testing.assert_allclose(stds["reference"], cfg.n_heads ** -0.5,
                               rtol=0.1)
