"""Port parity: the attention kinds beyond causal GQA
(``repro_torch.models.attention``) and the layer kinds that use them
(``models.transformer``), against the JAX package in fp32 on numpy-seeded
inputs and ``lm_numpy_params`` weights of the reduced configs: windowed
(local) attention past its window and across the ring buffer's wrap,
bidirectional (encoder) and cross attention, MLA's expanded prefill and
absorbed decode, sinusoidal positions, ``layer_apply`` for each of the
seven layer kinds and the cross-attention decoder's decode step.
Tolerance: rtol 1e-5 with an atol of 1e-5 of the field's largest
magnitude. Also the routing rule: which calls take ``flash_attention``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_numpy_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

RTOL = 1e-5


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, rtol=RTOL):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(w))))


def _pair(arch):
    return configs.reduced_config(arch), jconfigs.reduced_config(arch)


def _layer(cfg, stack, i=0):
    """(port tree, JAX tree) of layer i of a stack of the parity weights,
    fp32 (a list entry for the Griffin interleave)."""
    tree = lm_numpy_params(cfg, 0)[stack]
    p = tree[i] if isinstance(tree, list) else \
        jax.tree.map(lambda a: a[i], tree)
    return prm.tree_map(torch.from_numpy, p), jax.tree.map(jnp.asarray, p)


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts calls of ``ops.flash_attention`` (on the CPU it runs its
    plain version and counts no launch)."""
    calls = []
    real = ops.flash_attention

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return real(q, k, v)
    monkeypatch.setattr(ops, "flash_attention", spy)
    return calls


# --- sinusoidal positions ------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(24, 64), (1500, 512), (65536, 64)])
def test_sinusoidal_positions_match_reference(seq, d):
    """The same table up to the angle's rounding: the inverse frequencies
    are an ``exp`` that rounds 1 ulp apart between XLA-CPU and torch on
    some entries (ROADMAP §C hazards), and row p carries that ulp times p
    into the angle. So each entry is within p * 2^-23 + 1e-6 of the
    reference's; row 0 is exact."""
    got = layers.sinusoidal_positions(seq, d).numpy()
    want = np.asarray(jax.jit(lambda: jlayers.sinusoidal_positions(
        seq, d))())
    assert got.shape == want.shape == (seq, d)
    assert np.array_equal(got[0], want[0])
    bound = np.arange(seq, dtype=np.float64)[:, None] * 2.0 ** -23 + 1e-6
    assert np.all(np.abs(got - want) <= bound)


# --- GQA kinds ---------------------------------------------------------------

@pytest.mark.parametrize("s", [12, 16, 40])
def test_windowed_attention_matches_reference(s, flash_calls):
    """recurrentgemma-reduced's local attention (window 16, MQA): S <=
    window is the kernel's function (causal over the whole sequence), S >
    window is not and takes the plain path."""
    cfg, jcfg = _pair("recurrentgemma-2b")
    tp, jp = _layer(cfg, "layers", 2)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    y, (k, v) = attention.gqa_full(tp["attn"], torch.from_numpy(x),
                                   torch.from_numpy(_pos(2, s)), cfg,
                                   window=cfg.window, return_kv=True)
    jy, (jk, jv) = jax.jit(lambda p, x: jattn.gqa_full(
        p, x, jnp.asarray(_pos(2, s)), jcfg, window=jcfg.window,
        return_kv=True))(jp["attn"], jnp.asarray(x))
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want)
    assert len(flash_calls) == (1 if s <= cfg.window else 0)


def test_windowed_decode_across_the_ring_wrap_matches_reference():
    """A 20-token prefill into a 16-slot ring buffer (it wraps), then 6
    decode steps writing slots 4 .. 9, each against the reference: the
    output, the buffers and the slots' positions."""
    cfg, jcfg = _pair("recurrentgemma-2b")
    tp, jp = _layer(cfg, "layers", 2)
    x = np.random.default_rng(21).standard_normal(
        (2, 26, cfg.d_model)).astype(np.float32)
    pos = _pos(2, 20)
    _, (k, v) = attention.gqa_full(tp["attn"], torch.from_numpy(x[:, :20]),
                                   torch.from_numpy(pos), cfg,
                                   window=cfg.window, return_kv=True)
    _, (jk, jv) = jax.jit(lambda p, x: jattn.gqa_full(
        p, x, jnp.asarray(pos), jcfg, window=jcfg.window,
        return_kv=True))(jp["attn"], jnp.asarray(x[:, :20]))
    cache, jcache = {}, {}
    for name, got, want in (("k", k, jk), ("v", v, jv)):
        cache[name], cache["kpos"] = transformer._fill_buffer(
            cfg.window, got, torch.float32)
        jcache[name], jcache["kpos"] = jtfm._fill_buffer(
            jcfg.window, want, jnp.float32)
    assert cache["kpos"].tolist() == [16, 17, 18, 19] + list(range(4, 16))
    dec = jax.jit(lambda p, x, c, t: jattn.gqa_decode(p, x, c, t, jcfg,
                                                      window=jcfg.window))
    for t in range(20, 26):
        y, cache = attention.gqa_decode(tp["attn"], torch.from_numpy(
            x[:, t:t + 1]), cache, t, cfg, window=cfg.window)
        jy, jcache = dec(jp["attn"], jnp.asarray(x[:, t:t + 1]), jcache,
                         jnp.asarray(t, jnp.int32))
        _close(y, jy)
        for name in ("k", "v"):
            _close(cache[name], jcache[name])
        assert np.array_equal(cache["kpos"].numpy(),
                              np.asarray(jcache["kpos"]))


def test_bidirectional_attention_matches_reference(flash_calls):
    """whisper-reduced's encoder attention (``causal=False``): the plain
    path, never the causal kernel."""
    cfg, jcfg = _pair("whisper-base")
    tp, jp = _layer(cfg, "encoder", 1)
    x = np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    y = attention.gqa_full(tp["attn"], torch.from_numpy(x),
                           torch.from_numpy(_pos(2, 24)), cfg, causal=False)
    jy = jax.jit(lambda p, x: jattn.gqa_full(
        p, x, jnp.asarray(_pos(2, 24)), jcfg, causal=False))(
        jp["attn"], jnp.asarray(x))
    _close(y, jy)
    assert flash_calls == []


def test_cross_attention_matches_reference(flash_calls):
    """whisper-reduced's decoder cross-attention over 24 encoder frames
    (no rope, no mask): the plain path."""
    cfg, jcfg = _pair("whisper-base")
    tp, jp = _layer(cfg, "decoder", 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    y = attention.gqa_full(tp["xattn"], torch.from_numpy(x),
                           torch.from_numpy(_pos(2, 10)), cfg,
                           kv_x=torch.from_numpy(enc))
    jy = jax.jit(lambda p, x, e: jattn.gqa_full(
        p, x, jnp.asarray(_pos(2, 10)), jcfg, kv_x=e))(
        jp["xattn"], jnp.asarray(x), jnp.asarray(enc))
    _close(y, jy)
    assert flash_calls == []


@pytest.mark.parametrize("arch,s,want", [
    ("starcoder2-3b", 20, 2), ("deepseek-moe-16b", 20, 3),
    ("pixtral-12b", 20, 2), ("whisper-base", 20, 2),
    ("recurrentgemma-2b", 16, 1), ("recurrentgemma-2b", 20, 0),
    ("deepseek-v3-671b", 20, 0), ("mamba2-1.3b", 20, 0)])
def test_flash_attention_takes_exactly_the_causal_self_attention(
        arch, s, want, flash_calls):
    """One prefill of each reduced config: ``flash_attention`` is called
    once per causal self-attention layer whose whole sequence fits its
    window — whisper's decoder layers but not its encoder or cross
    attention, recurrentgemma's local layer only while S <= 16, never
    MLA (qk 24 / v 16) or an SSM."""
    cfg = configs.reduced_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, s), dtype=torch.int64)}
    if cfg.encdec is not None:
        batch["frames"] = torch.zeros((1, cfg.encdec.encoder_seq,
                                       cfg.d_model))
    model.prefill(params, batch, max_seq=s + 2)
    assert len(flash_calls) == want


def test_takes_flash_rule():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 8, 1, 16))
    kw = dict(causal=True, window=0, cross=False)
    assert attention.takes_flash(q, k, k, **kw)
    assert not attention.takes_flash(q, k, k, **{**kw, "causal": False})
    assert not attention.takes_flash(q, k, k, **{**kw, "cross": True})
    assert attention.takes_flash(q, k, k, **{**kw, "window": 8})
    assert not attention.takes_flash(q, k, k, **{**kw, "window": 7})
    wide = torch.zeros((1, 8, 2, 256))
    assert not attention.takes_flash(wide, wide[:, :, :1], wide[:, :, :1],
                                     **kw)
    assert not attention.takes_flash(torch.zeros((1, 8, 2, 24)),
                                      torch.zeros((1, 8, 1, 24)),
                                      torch.zeros((1, 8, 1, 16)), **kw)


# --- MLA -----------------------------------------------------------------------

def test_mla_full_and_decode_match_reference():
    """deepseek-v3-reduced's MLA: the expanded prefill and its latent
    cache, then three absorbed decode steps against the cache, fp32."""
    cfg, jcfg = _pair("deepseek-v3-671b")
    tp, jp = _layer(cfg, "dense_layers", 0)
    x = np.random.default_rng(4).standard_normal(
        (2, 15, cfg.d_model)).astype(np.float32)
    y, (ckv, kr) = attention.mla_full(tp["attn"], torch.from_numpy(x[:, :12]),
                                      torch.from_numpy(_pos(2, 12)), cfg,
                                      return_kv=True)
    jy, (jckv, jkr) = jax.jit(lambda p, x: jattn.mla_full(
        p, x, jnp.asarray(_pos(2, 12)), jcfg, return_kv=True))(
        jp["attn"], jnp.asarray(x[:, :12]))
    for got, want in ((y, jy), (ckv, jckv), (kr, jkr)):
        _close(got, want)
    cache = {"c_kv": transformer._fill_buffer(16, ckv, torch.float32)[0],
             "k_rope": transformer._fill_buffer(16, kr, torch.float32)[0]}
    jcache = {"c_kv": jtfm._fill_buffer(16, jckv, jnp.float32)[0],
              "k_rope": jtfm._fill_buffer(16, jkr, jnp.float32)[0]}
    dec = jax.jit(lambda p, x, c, t: jattn.mla_decode(p, x, c, t, jcfg))
    for t in range(12, 15):
        y, cache = attention.mla_decode(tp["attn"], torch.from_numpy(
            x[:, t:t + 1]), cache, t, cfg)
        jy, jcache = dec(jp["attn"], jnp.asarray(x[:, t:t + 1]), jcache,
                         jnp.asarray(t, jnp.int32))
        _close(y, jy)
        for name in ("c_kv", "k_rope"):
            _close(cache[name], jcache[name])
    # absorbed decode == the expanded form over the same 15 tokens
    full = attention.mla_full(tp["attn"], torch.from_numpy(x),
                              torch.from_numpy(_pos(2, 15)), cfg)
    _close(y, full[:, -1:], 1e-4)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-base"])
def test_attn_specs_and_caches_match_reference(arch):
    """MLA's and cross-attention's parameter specs and cache specs."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for cross in (False, True):
        got = attention.attn_specs(cfg, cross=cross)
        want = jattn.attn_specs(jcfg, cross=cross)
        assert list(got) == list(want)
        for k, s in got.items():
            assert (s.shape, s.logical, s.init, s.scale) == \
                (want[k].shape, want[k].logical, want[k].init,
                 want[k].scale), k
    if arch == "deepseek-v3-671b":
        got = attention.mla_cache_spec(cfg, 4, 576, 3)
        want = jattn.mla_cache_spec(jcfg, 4, 576, 3)
        assert {k: s.shape for k, s in got.items()} == \
            {k: s.shape for k, s in want.items()}


# --- every layer kind ------------------------------------------------------------

KIND_CASES = {        # kind -> (arch, stack, layer, extra kwargs)
    "attn_dense": ("deepseek-v3-671b", "dense_layers", 0),   # MLA + MLP
    "attn_moe": ("deepseek-moe-16b", "moe_layers", 0),
    "mamba2": ("mamba2-1.3b", "layers", 1),
    "recurrent": ("recurrentgemma-2b", "layers", 0),
    "local_attn": ("recurrentgemma-2b", "layers", 2),
    "enc": ("whisper-base", "encoder", 0),
    "dec_cross": ("whisper-base", "decoder", 1),
}


@pytest.mark.parametrize("kind", list(KIND_CASES))
def test_layer_apply_matches_reference(kind):
    """``layer_apply`` of each of the seven kinds in fp32 over 20 tokens
    (past recurrentgemma's window of 16; the encoder bidirectional, the
    decoder against 24 encoder frames)."""
    arch, stack, i = KIND_CASES[kind]
    cfg, jcfg = _pair(arch)
    tp, jp = _layer(cfg, stack, i)
    rng = np.random.default_rng(len(kind))
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    kw = {"causal": kind != "enc"}
    jkw = dict(kw)
    if kind == "dec_cross":
        enc = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
        kw["enc_out"], jkw["enc_out"] = torch.from_numpy(enc), jnp.asarray(enc)
    y, aux = transformer.layer_apply(tp, torch.from_numpy(x),
                                     torch.from_numpy(_pos(2, 20)), cfg,
                                     kind, **kw)
    jy, jaux = jax.jit(lambda p, x, e: jtfm.layer_apply(
        p, x, jnp.asarray(_pos(2, 20)), jcfg, kind,
        **{**jkw, **({"enc_out": e} if e is not None else {})}))(
        jp, jnp.asarray(x), jkw.get("enc_out"))
    _close(y, jy)
    _close(aux.reshape(1), np.asarray(jaux).reshape(1))


def test_layer_specs_of_every_kind_match_reference():
    for kind, (arch, _, _) in KIND_CASES.items():
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        got = dict(prm.leaves(transformer.layer_specs(cfg, kind)))
        want = dict(prm.leaves(jtfm.layer_specs(jcfg, kind)))
        assert list(got) == list(want), kind
        for p, s in got.items():
            assert (s.shape, s.logical, s.init) == \
                (want[p].shape, want[p].logical, want[p].init), (kind, p)
        assert transformer.cache_logical(kind, cfg) == \
            jtfm.cache_logical(kind, jcfg)


def test_dec_cross_prefill_and_decode_match_reference():
    """The cross-attention decoder layer: its prefill caches the encoder
    K/V once; decode steps read them, fp32."""
    cfg, jcfg = _pair("whisper-base")
    tp, jp = _layer(cfg, "decoder", 0)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 14, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    y, c = transformer.layer_prefill(
        tp, torch.from_numpy(x[:, :12]), torch.from_numpy(_pos(2, 12)), cfg,
        "dec_cross", max_seq=16, enc_out=torch.from_numpy(enc),
        cache_dtype=torch.float32)
    jy, jc = jax.jit(lambda p, x, e: jtfm.layer_prefill(
        p, x, jnp.asarray(_pos(2, 12)), jcfg, "dec_cross", max_seq=16,
        enc_out=e, cache_dtype=jnp.float32))(jp, jnp.asarray(x[:, :12]),
                                             jnp.asarray(enc))
    _close(y, jy)
    for k in ("k", "v", "xk", "xv"):
        _close(c[k], jc[k])
    dec = jax.jit(lambda p, x, c, t: jtfm.layer_decode(p, x, c, t, jcfg,
                                                       "dec_cross"))
    for t in (12, 13):
        y, c = transformer.layer_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                        c, t, cfg, "dec_cross")
        jy, jc = dec(jp, jnp.asarray(x[:, t:t + 1]), jc,
                     jnp.asarray(t, jnp.int32))
        _close(y, jy)


def test_layer_cache_specs_match_reference():
    for kind, (arch, _, _) in KIND_CASES.items():
        if kind == "enc":
            continue
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for max_seq in (576, 4096):
            got = transformer.layer_cache_spec(cfg, kind, 4, max_seq)
            want = jtfm.layer_cache_spec(jcfg, kind, 4, max_seq)
            assert {k: (s.shape, str(s.dtype).split(".")[-1])
                    for k, s in got.items()} == \
                {k: (s.shape, np.dtype(s.dtype).name)
                 for k, s in want.items()}, (kind, max_seq)
    # the local layer's ring buffer is the window, not the context
    cfg = configs.get_config("recurrentgemma-2b")
    assert transformer.layer_cache_spec(cfg, "local_attn", 1, 10 ** 6)[
        "k"].shape[1] == cfg.window
    assert transformer.layer_cache_spec(cfg, "local_attn", 1, 8)[
        "k"].shape[1] == 8
