"""The LM zoo's serve path on the port for the six configs beyond the dense
decoders (MoE with GQA and with MLA, Mamba-2, the Griffin interleave, the
encoder-decoder, the VLM), on their reduced configs on the CPU: decode
against the forward pass (tests/test_arch_smoke.py's measure), the
sub-quadratic archs' bounded caches, weights from the JAX ``init``
carried element for element, ``launch.serve`` with frames and patches,
and the names the port used to refuse.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_numpy_params, lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
import test_torch_fixtures as fx  # noqa: E402

NEW = ("deepseek-moe-16b", "deepseek-v3-671b", "whisper-base", "pixtral-12b",
       "mamba2-1.3b", "recurrentgemma-2b")


def _inputs(cfg, b):
    return {k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in fx.zoo_inputs(cfg, b).items()}


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("weights", ["init", "parity"])
def test_decode_matches_full_forward(arch, weights, monkeypatch):
    """Two decode steps after a prefill of 16 against the forward over all
    18 tokens, by the reference's measure (max abs difference over max abs
    logit) and with its limit 0.15, with ``Model.init``'s weights at the
    configs' own capacity factor (the port measured at most 0.083, V3).
    With the parity weights the MoE configs run at an ample capacity
    (``REPRO_MOE_CF``): a forward over 36 tokens and a 2-token decode step
    drop different assignments by design. There the limit is 0.03 (at
    most 0.013 measured)."""
    cfg = configs.reduced_config(arch)
    model = Model(cfg)
    if weights == "init":
        params = model.init(torch.Generator().manual_seed(1), "cpu")
    else:
        monkeypatch.setenv("REPRO_MOE_CF", "64")
        params = lm_params_from_numpy(cfg, lm_numpy_params(cfg, 1), "cpu")
    b, s = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s + 2)).astype(np.int32))
    extra = _inputs(cfg, b)
    _, cache = model.prefill(params, {"tokens": toks[:, :s], **extra},
                             max_seq=s + 4)
    _, cache = model.decode(params, cache, toks[:, s:s + 1])
    logits, cache = model.decode(params, cache, toks[:, s + 1:s + 2])
    h, _ = model.forward(params, {"tokens": toks, **extra})
    want = unembed(params["embed"], h[:, -1:], cfg)
    rel = float((logits - want).abs().max() / (want.abs().max() + 1e-9))
    assert rel < (0.15 if weights == "init" else 0.03), rel


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_subquadratic_cache_is_bounded(arch):
    """tests/test_arch_smoke.py's check: the decode cache of a 64x longer
    context is less than twice as large, and the same as the
    reference's."""
    model = Model(configs.reduced_config(arch))
    jmodel = JaxModel(jconfigs.reduced_config(arch))

    def nbytes(tree):
        return sum(int(np.prod(s.shape)) * s.dtype.itemsize
                   for _, s in prm.leaves(tree) if s.shape)
    small, large = model.cache_specs(2, 1024), model.cache_specs(2, 1024 * 64)
    assert nbytes(large) / nbytes(small) < 2.0
    for max_seq in (1024, 1024 * 64):
        got = {p: s.shape for p, s in prm.leaves(
            model.cache_specs(2, max_seq))}
        want = {p: tuple(s.shape) for p, s in prm.leaves(
            jmodel.cache_specs(2, max_seq))}
        assert got == want


@pytest.mark.parametrize("arch", NEW)
def test_params_from_jax_init_equal_element_for_element(arch):
    """The JAX ``Model.init``'s parameters (bf16 and the fp32 router,
    A_log, dt_bias, Lambda ...) cross into the port bit for bit."""
    cfg, jcfg = configs.reduced_config(arch), jconfigs.reduced_config(arch)
    arrays = jax.tree.map(np.asarray, jax.jit(JaxModel(jcfg).init)(
        jax.random.PRNGKey(3)))
    got = lm_params_from_numpy(cfg, arrays, "cpu")
    want = dict(prm.leaves(arrays))
    specs = dict(prm.leaves(Model(cfg).param_specs()))
    assert sorted(dict(prm.leaves(got))) == sorted(want)
    for path, t in prm.leaves(got):
        assert t.dtype == specs[path].dtype, path
        w = want[path]
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16)), path
        else:
            assert w.dtype == np.float32 and np.array_equal(t.numpy(), w), \
                path


@pytest.mark.parametrize("arch", NEW)
def test_serve_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id> --reduced --device
    cpu``: zero frames / patches where the config reads them, as the
    reference's ``launch/serve.py``, and finite greedy tokens."""
    args = serve.parser().parse_args(["--arch", arch, "--reduced",
                                      "--device", "cpu", "--batch", "2",
                                      "--prompt-len", "12", "--gen", "4"])
    res = serve.serve(args)
    assert res["generated"].shape == (2, 4) and res["logits_finite"]
    assert capsys.readouterr().out.startswith(f"[serve] {arch}-reduced:")
    cfg = configs.reduced_config(arch)
    extra = serve.frontend_inputs(cfg, 2, torch.device("cpu"))
    assert sorted(extra) == sorted(fx.zoo_inputs(cfg, 2))
    assert all(not t.any() and t.dtype == torch.bfloat16
               for t in extra.values())


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_serve_generate_takes_its_own_frames_and_patches(arch):
    """``generate`` with given frames / patches is the greedy loop over
    ``prefill`` and ``decode`` with them, and they matter."""
    args = serve.parser().parse_args(["--arch", arch, "--reduced",
                                      "--device", "cpu", "--batch", "2",
                                      "--prompt-len", "12", "--gen", "3"])
    model, params, prompts, max_seq = serve.setup(args)
    extra = _inputs(model.cfg, 2)
    logits, cache = model.prefill(params, {"tokens": prompts, **extra},
                                  max_seq=max_seq)
    toks = [torch.argmax(logits[:, -1:], -1).to(torch.int32)]
    for _ in range(2):
        logits, cache = model.decode(params, cache, toks[-1])
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    res = serve.generate(model, params, prompts, gen=3, max_seq=max_seq,
                         inputs=extra)
    assert np.array_equal(res["generated"], torch.cat(toks, 1).numpy())
    zero = model.prefill(params, {"tokens": prompts, **serve.frontend_inputs(
        model.cfg, 2, prompts.device)}, max_seq=max_seq)[0]
    first = model.prefill(params, {"tokens": prompts, **extra},
                          max_seq=max_seq)[0]
    assert not torch.equal(zero, first)


def test_serve_layers_cuts_depth_and_the_mtp_head():
    """``--layers N``: the config's first N layers, no MTP head (serving
    never runs it), the rest of the config as it is."""
    args = serve.parser().parse_args(["--arch", "deepseek-v3-671b",
                                      "--reduced", "--device", "cpu",
                                      "--layers", "2", "--batch", "1",
                                      "--prompt-len", "6", "--gen", "2"])
    model, params, _, _ = serve.setup(args)
    full = configs.reduced_config("deepseek-v3-671b")
    assert model.cfg == dataclasses.replace(full, n_layers=2, mtp_depth=0)
    assert "mtp" not in params and params["moe_layers"]["ln1"].shape[0] == 1
    assert serve.serve(args)["generated"].shape == (1, 2)


@pytest.mark.parametrize("arch", NEW)
def test_every_config_the_port_refused_now_constructs(arch):
    """Each name the port's refusals named (the non-dense ``Model``
    configs, every layer kind, cross and MLA attention specs, the three
    recurrent initializers, windowed and bidirectional attention) builds
    and runs: the full config's ``Model`` and its specs, and its reduced
    config's parameters drawn with every initializer it uses."""
    cfg = configs.get_config(arch)
    specs = Model(cfg).param_specs()
    assert prm.param_count(specs) > 0
    inits = {s.init for _, s in prm.leaves(specs)}
    small = configs.reduced_config(arch)
    params = Model(small).init(torch.Generator().manual_seed(0), "cpu")
    for path, t in prm.leaves(params):
        assert torch.isfinite(t.float()).all(), path
    if arch == "mamba2-1.3b":
        assert {"a_log", "dt_bias"} <= inits
    if arch == "recurrentgemma-2b":
        assert "lambda_lru" in inits
    kinds = {k for st in Model(cfg).stacks for k in st.kinds}
    assert kinds <= set(transformer.KINDS)
    assert attention.attn_specs(small, cross=True)
    x = torch.zeros((1, 5, small.d_model))
    if small.n_heads and small.attention.value != "mla":
        p = {k: torch.randn(s.shape) * 0.1
             for k, s in attention.attn_specs(small).items()}
        pos = torch.arange(5)[None]
        for kw in ({"window": 2}, {"causal": False}, {"kv_x": x}):
            assert attention.gqa_full(p, x, pos, small, **kw).shape == x.shape


def test_chip_smoke_draws_the_records_inputs_and_cuts():
    """``chip_smoke.py`` keeps its own copies of the zoo records' cut and
    frames / patches draws (it imports nothing from the tests): they equal
    these fixtures', and each committed record names its depth and seed."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", fx.ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert set(cs.ZOO_ARCHS) == set(fx.ZOO_RECORDS)
    for arch, (depth, b, s) in fx.ZOO_RECORDS.items():
        cfg = configs.get_config(arch)
        assert cs.zoo_record_config(cfg, depth) == \
            fx.zoo_record_config(cfg, arch)
        small = configs.reduced_config(arch)
        got = cs.zoo_inputs(torch, np, small, 2, fx.ZOO_INPUT_SEED, "cpu")
        want = fx.zoo_inputs(small, 2)
        assert sorted(got) == sorted(want)
        for k in got:
            assert torch.equal(got[k], torch.from_numpy(want[k]).to(
                torch.bfloat16)), (arch, k)
        rec = np.load(fx.zoo_record_path(arch))
        assert int(rec["n_layers"]) == depth
        assert int(rec["input_seed"]) == fx.ZOO_INPUT_SEED
        assert rec["tokens"].shape == (b, s)
        assert np.array_equal(rec["columns"], fx.zoo_columns(cfg.vocab))
        assert rec["decode_logits"].shape == (fx.LM_DECODE_STEPS, b,
                                              rec["columns"].size)
