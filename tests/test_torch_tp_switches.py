"""The dry run's two sharding switches in the port's models on CPU
meshes, fp32: ``qk_dim_fallback`` (head_dim over the model axis where the
heads do not divide it — partial logits and partial ``wo`` products
all-reduced) and ``seq_parallel_attn`` (query rows over the model axis).
Logits of the forward, the prefill and a decode step on (1, 2) and
(1, 4) within 1e-5 of the unsharded port, and one AdamW step on (2, 2)
within 1e-5, the limits of the tensor-parallel tests."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import sharding as shd  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.convert import lm_numpy_params, lm_params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402

REL = 1e-5
B, S = 2, 16

# (arch, overrides): three heads over one kv head divide neither a 2- nor
# a 4-way model axis, so head_dim takes it for every attention weight;
# granite's 8 / 2 heads on (1, 4) cut only the kv heads' head_dim; whisper
# adds the encoder and cross-attention
CONFIGS = {
    "qk": ("starcoder2-3b", dict(d_model=48, n_heads=3, n_kv_heads=1)),
    "kv": ("granite-3-8b", {}),
    "cross": ("whisper-base", dict(d_model=48, n_heads=3, n_kv_heads=3)),
}


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     ["cpu"] * int(np.prod(shape)))


def _rel(got, want) -> float:
    g, w = got.detach().double(), want.detach().double()
    return float((g - w).abs().max() / (w.abs().max() + 1e-30))


def _setup(name):
    arch, over = CONFIGS[name]
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32", **over)
    params = lm_params_from_numpy(cfg, lm_numpy_params(cfg, 0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens}
    if cfg.encdec is not None:
        batch["frames"] = torch.randn(B, cfg.encdec.encoder_seq, cfg.d_model,
                                      generator=g)
    return cfg, params, batch


def _attn(params):
    return params["decoder" if "decoder" in params else "layers"]["attn"]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("switch,name", [
    ("qk_dim_fallback", "qk"), ("qk_dim_fallback", "kv"),
    ("qk_dim_fallback", "cross"), ("seq_parallel_attn", "kv"),
    ("seq_parallel_attn", "cross")])
def test_switch_logits_equal_the_unsharded_port(switch, name, mesh_shape):
    cfg, params, batch = _setup(name)
    plain = Model(cfg)
    h0, _ = plain.forward(params, batch)
    l0, c0 = plain.prefill(params, batch, max_seq=S + 2)
    d0, _ = plain.decode(params, c0, batch["tokens"][:, :1])
    mesh = _mesh(mesh_shape)
    model = Model(cfg, mesh=mesh,
                  rules=shd.train_rules(mesh, **{switch: True}))
    placed = shd.place_tree(params, model.param_placements())
    wq, wk = _attn(placed)["wq"], _attn(placed)["wk"]
    if switch == "qk_dim_fallback" and name != "kv":
        # (layers, d, heads, head_dim): heads whole, head_dim split, the
        # partial-logits path
        assert wq.placement.dim_axes(3) == ("model",)
    if name == "kv" and mesh_shape == (1, 4):
        assert wk.placement.dim_axes(3) == (
            ("model",) if switch == "qk_dim_fallback" else ())
    if switch == "seq_parallel_attn":
        assert all(g.q_seq for g in model.rows.groups)
    h, _ = model.forward(placed, batch)
    logits, cache = model.prefill(placed, batch, max_seq=S + 2)
    step, _ = model.decode(placed, cache, batch["tokens"][:, :1])
    assert _rel(h, h0) < REL
    assert _rel(logits, l0) < REL
    assert _rel(step, d0) < REL


@pytest.mark.parametrize("switch,name", [("qk_dim_fallback", "qk"),
                                         ("seq_parallel_attn", "kv")])
def test_switch_train_step_on_a_2x2_mesh_is_the_unsharded_step(switch, name):
    """One AdamW step: loss and grad norm within 1e-5; each parameter
    within 1e-5 of its leaf's largest value, as the tensor-parallel checks
    hold it: Adam's first step moves an element by ~lr * g / (|g| + eps),
    so one whose gradient sits at rounding level (below 1e-4 of its leaf's
    largest) may step anywhere within 2 lr."""
    cfg, params, batch = _setup(name)
    tokens = torch.randint(0, cfg.vocab, (4, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    model = Model(cfg)
    opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    mesh = _mesh((2, 2))
    rules = shd.train_rules(mesh, **{switch: True})
    cell = ShapeConfig("t", S, 4, "train")

    def state():
        return {"step": torch.zeros((), dtype=torch.int32),
                "params": tr.tree_map(torch.clone, params),
                "opt": opt.init(params)}
    placed = shd.place_tree(
        state(), step_mod.train_state_shardings(model, opt, mesh, rules))
    placed, got = step_mod.jit_train_step(model, opt, mesh, rules,
                                          cell)(placed, batch)
    plain, want = step_mod.make_train_step(model, opt)(state(), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL,
                                   err_msg=k)
    grads = step_mod.loss_and_grads(model, params, batch)[2]
    lr = float(want["lr"])
    for i, (a, b, g) in enumerate(zip(tr.leaves(placed["params"]),
                                      tr.leaves(plain["params"]),
                                      tr.leaves(grads))):
        d = (shd.whole(a).double() - b.double()).abs()
        live = d[g.abs() > 1e-4 * g.abs().max()]
        if live.numel():
            assert float(live.max() / b.abs().max()) < REL, i
        assert float(d.max()) <= 2 * lr, i
