"""Port parity: the LM zoo's dense GQA serve path (``repro_torch.configs``,
``models``, ``data.lm_data``, ``launch.serve`` and the LM functions of
``convert``) against the JAX package.

Inputs and weights come from numpy seeds and go through both packages.
Layers compare in fp32 (rtol 1e-5: the point is the algorithm); whole
models in bf16 on the reduced configs with ``lm_numpy_params`` weights,
by relative L2. There the two differ by design: the reference's chunked
XLA attention rounds its logits and softmax weights to bf16, the port's
``flash_attention`` keeps them in fp32 (as the reference's Pallas kernel
does), and that moves the logits and caches by about 1% (at most 1.04%
on starcoder2-3b-reduced and 0.92% on granite-3-8b-reduced here, 1.5% on
mistral-large-123b-reduced in a probe), so the limit is 1.5e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.lm_data import SyntheticCorpus as JaxCorpus  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import params as jprm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_numpy_params, lm_params_from_numpy  # noqa: E402
from repro_torch.data.lm_data import SyntheticCorpus  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

RTOL = 1e-5
MODEL_REL_L2 = 1.5e-2
DENSE = ("starcoder2-3b", "granite-3-8b", "deepseek-67b", "mistral-large-123b")
PARITY = ("starcoder2-3b", "granite-3-8b")


def _rel_l2(got, want):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, rtol=RTOL):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(w))))


def _fp32_params(cfg, seed=0):
    """(port tree in fp32, JAX tree in fp32) of the parity weights."""
    arr = lm_numpy_params(cfg, seed)
    return (prm.tree_map(torch.from_numpy, arr),
            jax.tree.map(jnp.asarray, arr))


# --- layers in fp32 ----------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(layers.rmsnorm(torch.from_numpy(w), torch.from_numpy(x), 1e-5),
           jlayers.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("d,theta", [(16, 1e5), (128, 1e4), (8, 1e6)])
def test_apply_rope_matches_reference(d, theta):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 500, (2, 9)).copy()
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-3-8b"])
def test_mlp_matches_reference(arch):
    """SwiGLU (both reduced configs are gated) and GELU (the full
    StarCoder2 MLP's kind, tanh approximation) in fp32."""
    import dataclasses
    for gated in (True, False):
        cfg = dataclasses.replace(configs.reduced_config(arch),
                                  mlp_gated=gated)
        jcfg = dataclasses.replace(jconfigs.reduced_config(arch),
                                   mlp_gated=gated)
        rng = np.random.default_rng(int(gated))
        p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
             .astype(np.float32)
             for k, s in layers.mlp_specs(cfg).items()}
        x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
        _close(layers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), cfg),
               jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jcfg))


@pytest.mark.parametrize("tied", [False, True])
def test_embed_unembed_match_reference(tied):
    import dataclasses
    cfg = dataclasses.replace(configs.reduced_config("starcoder2-3b"),
                              tie_embeddings=tied)
    jcfg = dataclasses.replace(jconfigs.reduced_config("starcoder2-3b"),
                               tie_embeddings=tied)
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(s.shape).astype(np.float32)
         for k, s in layers.embed_specs(cfg).items()}
    toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = layers.embed(tp, torch.from_numpy(toks))
    _close(x, jlayers.embed(jp, jnp.asarray(toks)))
    _close(layers.unembed(tp, x, cfg),
           jlayers.unembed(jp, jnp.asarray(x.numpy()), jcfg))


@pytest.mark.parametrize("arch", PARITY)
def test_gqa_full_and_decode_match_reference(arch):
    """fp32: prefill attention (the port's through ``flash_attention``),
    its post-rope K/V, the ring buffers, and three decode steps against
    the cache, each against the reference's function."""
    cfg, jcfg = configs.reduced_config(arch), jconfigs.reduced_config(arch)
    tp, jp = _fp32_params(cfg)
    ta = prm.tree_map(lambda t: t[0], tp["layers"]["attn"])
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    rng = np.random.default_rng(5)
    b, s, t = 2, 12, 16
    x = rng.standard_normal((b, s + 3, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    y, (k, v) = attention.gqa_full(ta, torch.from_numpy(x[:, :s]),
                                   torch.from_numpy(pos), cfg, return_kv=True)
    jy, (jk, jv) = jattn.gqa_full(ja, jnp.asarray(x[:, :s]), jnp.asarray(pos),
                                  jcfg, return_kv=True)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want)
    cache = {}
    jcache = {}
    for name, got, want in (("k", k, jk), ("v", v, jv)):
        cache[name], cache["kpos"] = transformer._fill_buffer(t, got,
                                                              torch.float32)
        jcache[name], jcache["kpos"] = jtfm._fill_buffer(t, want, jnp.float32)
        _close(cache[name], jcache[name])
    assert np.array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    for i in range(3):
        xi = x[:, s + i:s + i + 1]
        y, cache = attention.gqa_decode(ta, torch.from_numpy(xi), cache,
                                        s + i, cfg)
        jy, jcache = jattn.gqa_decode(ja, jnp.asarray(xi), jcache,
                                      jnp.asarray(s + i, jnp.int32), jcfg)
        _close(y, jy)
        for name in ("k", "v"):
            _close(cache[name], jcache[name])
        assert np.array_equal(cache["kpos"].numpy(),
                              np.asarray(jcache["kpos"]))


@pytest.mark.parametrize("s,buf", [(5, 8), (8, 8), (11, 8)])
def test_fill_buffer_matches_reference(s, buf):
    """Short, exact and wrapped (ring) prefills, in bf16."""
    seq = np.random.default_rng(s).standard_normal((2, s, 3, 4))
    got, kpos = transformer._fill_buffer(
        buf, torch.from_numpy(seq.astype(np.float32)), torch.bfloat16)
    want, jkpos = jtfm._fill_buffer(buf, jnp.asarray(seq, jnp.float32),
                                    jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), _np(want))
    assert np.array_equal(kpos.numpy(), np.asarray(jkpos))


def test_mask_bias_matches_reference():
    q = np.arange(6, dtype=np.int32)[None] + 3
    k = np.arange(10, dtype=np.int32)[None]
    for causal, window in ((True, 0), (True, 4), (False, 0)):
        got = attention._mask_bias(torch.from_numpy(q), torch.from_numpy(k),
                                   causal=causal, window=window)
        want = jattn._mask_bias(jnp.asarray(q), jnp.asarray(k),
                                causal=causal, window=window)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", PARITY)
def test_layer_forward_fp32_matches_reference(arch):
    """One whole ``attn_dense`` layer (norms, attention, MLP) in fp32."""
    cfg, jcfg = configs.reduced_config(arch), jconfigs.reduced_config(arch)
    tp, jp = _fp32_params(cfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    y, _ = transformer.layer_apply(prm.tree_map(lambda t: t[1], tp["layers"]),
                                   torch.from_numpy(x), torch.from_numpy(pos),
                                   cfg, "attn_dense")
    jy, _ = jtfm.layer_apply(jax.tree.map(lambda a: a[1], jp["layers"]),
                             jnp.asarray(x), jnp.asarray(pos), jcfg,
                             "attn_dense")
    _close(y, jy)


# --- whole models in bf16 ---------------------------------------------------

@pytest.fixture(scope="module", params=PARITY)
def bf16_pair(request):
    """(port model, params, JAX model, params, tokens (2, 20)) on the
    reduced config with the parity weights, rounded to bf16 by each."""
    arch = request.param
    cfg, jcfg = configs.reduced_config(arch), jconfigs.reduced_config(arch)
    arr = lm_numpy_params(cfg, 0)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 20))
    return (Model(cfg), lm_params_from_numpy(cfg, arr, "cpu"), JaxModel(jcfg),
            jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), arr),
            toks.astype(np.int32))


def test_prefill_and_decode_match_reference(bf16_pair):
    """Prefill logits and caches (k, v, kpos, pos), then 4 decode steps
    (logits and caches), bf16, within the stated relative L2."""
    model, params, jmodel, jparams, toks = bf16_pair
    s, max_seq = 16, 24
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :s])}, max_seq=max_seq)
    jlogits, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, max_seq=max_seq))(jparams, toks[:, :s])
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    errs = [_rel_l2(_np(logits), _np(jlogits))]

    def caches_match():
        got, want = cache["stacks"]["layers"], jcache["stacks"]["layers"]
        for name in ("k", "v"):
            assert got[name].shape == want[name].shape
            errs.append(_rel_l2(_np(got[name]), _np(want[name])))
        assert np.array_equal(got["kpos"].numpy(), np.asarray(want["kpos"]))
        assert cache["pos"] == int(jcache["pos"])

    caches_match()
    dec = jax.jit(jmodel.decode)
    for i in range(4):
        tok = toks[:, s + i:s + i + 1]
        logits, cache = model.decode(params, cache, torch.from_numpy(tok))
        jlogits, jcache = dec(jparams, jcache, tok)
        errs.append(_rel_l2(_np(logits), _np(jlogits)))
        caches_match()
    assert max(errs) < MODEL_REL_L2, errs


def test_forward_matches_reference(bf16_pair):
    model, params, jmodel, jparams, toks = bf16_pair
    h, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    jh, _ = jax.jit(jmodel.forward)(jparams, {"tokens": toks})
    assert h.dtype == torch.bfloat16 and float(aux) == 0.0
    assert _rel_l2(_np(h), _np(jh)) < MODEL_REL_L2


# --- decode against forward, within the port ------------------------------------

@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("weights", ["init", "parity"])
def test_decode_matches_full_forward(arch, weights):
    """tests/test_arch_smoke.py::test_decode_matches_full_forward on the
    port: two decode steps after a prefill of 16 equal the forward pass
    over all 18 tokens, by the reference's measure (max abs difference
    over max abs logit). Its limit is 0.15; the port measured at most
    0.048 (granite) with ``Model.init`` weights and 0.014 (starcoder2)
    with the parity weights, so the limits here are 0.06 and 0.03."""
    cfg = configs.reduced_config(arch)
    model = Model(cfg)
    if weights == "init":
        params = model.init(torch.Generator().manual_seed(1), "cpu")
    else:
        params = lm_params_from_numpy(cfg, lm_numpy_params(cfg, 1), "cpu")
    b, s = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s + 2)).astype(np.int32))
    _, cache = model.prefill(params, {"tokens": toks[:, :s]}, max_seq=s + 4)
    _, cache = model.decode(params, cache, toks[:, s:s + 1])
    logits, cache = model.decode(params, cache, toks[:, s + 1:s + 2])
    h, _ = model.forward(params, {"tokens": toks})
    want = layers.unembed(params["embed"], h[:, -1:], cfg)
    rel = float((logits - want).abs().max() / (want.abs().max() + 1e-9))
    assert rel < (0.06 if weights == "init" else 0.03), rel


# --- configs and parameter specs for the whole zoo ----------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_and_param_specs_match_reference(arch):
    """All ten full configs: the same dataclass fields, param_count and
    describe(); ``param_specs`` leaf for leaf (path — the Griffin
    interleave's list of layers and the ``encoder`` / ``mtp`` subtrees
    included — shape, logical axes, init, scale, dtype) without
    allocating; the decode-cache specs leaf for leaf."""
    import dataclasses
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert repr(dataclasses.asdict(cfg)) == repr(dataclasses.asdict(jcfg))
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.describe() == jcfg.describe()
    assert repr(dataclasses.asdict(configs.reduced_config(arch))) == \
        repr(dataclasses.asdict(jconfigs.reduced_config(arch)))
    specs = Model(cfg).param_specs()
    jspecs = JaxModel(jcfg).param_specs()
    jleaves = {p: (s.shape, s.logical, s.init, s.scale,
                   jnp.dtype(s.dtype).name)
               for p, s in prm.leaves(jspecs)}
    got = {p: (s.shape, s.logical, s.init, s.scale,
               str(s.dtype).split(".")[-1])
           for p, s in prm.leaves(specs)}
    assert sorted(got) == sorted(jleaves)
    for path, leaf in got.items():
        assert jleaves[path] == leaf, path
    assert prm.param_count(specs) == jprm.param_count(jspecs)
    assert prm.param_bytes(specs) == jprm.param_bytes(jspecs)
    model, jmodel = Model(cfg), JaxModel(jcfg)
    one = {p: (s.shape, str(s.dtype).split(".")[-1])
           for p, s in prm.leaves(model.cache_specs(4, 576))}
    jone = {p: (tuple(s.shape), jnp.dtype(s.dtype).name)
            for p, s in prm.leaves(jmodel.cache_specs(4, 576))}
    assert one == jone
    assert model.cache_logical() == jmodel.cache_logical()


# --- the synthetic corpus -------------------------------------------------------

@pytest.mark.parametrize("vocab,seed,step", [(49152, 0, 0), (131, 3, 7)])
def test_synthetic_corpus_equals_reference(vocab, seed, step):
    got = SyntheticCorpus(vocab, seed=seed).batch(step, 4, 64, host_id=1)
    want = JaxCorpus(vocab, seed=seed).batch(step, 4, 64, host_id=1)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# --- weights across the packages --------------------------------------------------

@pytest.mark.parametrize("arch", PARITY)
def test_params_from_jax_init_equal_element_for_element(arch):
    cfg, jcfg = configs.reduced_config(arch), jconfigs.reduced_config(arch)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(3))
    arrays = jax.tree.map(np.asarray, jparams)
    got = lm_params_from_numpy(cfg, arrays, "cpu")
    want = dict(prm.leaves(arrays))
    for path, t in prm.leaves(got):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(),
                              want[path].view(np.int16)), path


def test_parity_weights_round_alike_and_cut_depth_keeps_layers():
    """``lm_numpy_params``: bf16 rounding gives the same bits in both
    packages; a model cut to fewer layers gets the full one's first
    layers; the stds are 1/sqrt(contracted size)."""
    import dataclasses
    cfg = configs.reduced_config("granite-3-8b")
    full = lm_numpy_params(cfg, 0)
    cut = lm_numpy_params(dataclasses.replace(cfg, n_layers=1), 0)
    for (path, a), (_, b) in zip(prm.leaves(full), prm.leaves(cut)):
        if path.startswith("layers/"):
            assert np.array_equal(a[:1], b), path
        else:
            assert np.array_equal(a, b), path
        tb = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy()
        jb = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(np.int16)
        assert np.array_equal(tb, jb), path
    big = dataclasses.replace(configs.get_config("starcoder2-3b"), n_layers=1,
                              vocab=64)
    w = lm_numpy_params(big, 0)["layers"]["attn"]["wq"]
    assert abs(float(w.std()) * np.sqrt(3072) - 1.0) < 0.01


# --- the serve entry point --------------------------------------------------------------

def _args(*extra):
    return serve.parser().parse_args(["--arch", "starcoder2-3b", "--reduced",
                                      *extra])


def test_serve_on_cpu_returns_reference_keys(capsys):
    res = serve.serve(_args("--device", "cpu", "--batch", "2",
                            "--prompt-len", "16", "--gen", "5"))
    assert {"prefill_s", "decode_s", "tokens_per_s", "generated"} <= set(res)
    assert res["generated"].shape == (2, 5)
    assert res["logits_finite"]
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in out] == ["starcoder2-3b-reduced:",
                                             "prefill", "sample"]
    assert "compile" not in out[1]


def test_serve_generate_is_greedy_over_prefill_and_decode():
    """The generated tokens are the argmax of a prefill and of decode steps
    fed back, as the reference's loop does."""
    args = _args("--device", "cpu", "--batch", "2", "--prompt-len", "8",
                 "--gen", "3")
    model, params, prompts, max_seq = serve.setup(args)
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  max_seq=max_seq)
    toks = [torch.argmax(logits[:, -1:], -1).to(torch.int32)]
    for _ in range(2):
        logits, cache = model.decode(params, cache, toks[-1])
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    res = serve.generate(model, params, prompts, gen=3, max_seq=max_seq)
    assert np.array_equal(res["generated"], torch.cat(toks, 1).numpy())


@pytest.mark.parametrize("extra", [("--device", "cpu", "--model-parallel",
                                    "2"), ("--device", "cpu", "--kv-seq")])
def test_serve_mesh_options_raise(extra):
    """The reference's mesh options run on the CPU (two model shards, or
    position-cut caches on a one-entry mesh): the same tokens as the
    unsharded serve, from the same seeded weights."""
    args = ("--batch", "2", "--prompt-len", "16", "--gen", "5")
    want = serve.serve(_args("--device", "cpu", *args))
    got = serve.serve(_args(*extra, *args))
    assert got["logits_finite"]
    assert np.array_equal(got["generated"], want["generated"])


def test_serve_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(_args())
