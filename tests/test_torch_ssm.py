"""Port parity: Mamba-2's SSD block (``repro_torch.models.ssm``) against
the JAX package's ``repro.models.ssm`` in fp32 on numpy-seeded inputs and
``lm_numpy_params`` weights of mamba2-1.3b-reduced: ``ssd_chunked`` (one
chunk, several, a ragged last chunk size, an initial state), the block's
forward with its decode state, decode steps continuing a prefill, the
``mamba2`` layer, and the recurrent initializers' ranges. Tolerance:
rtol 1e-5 with an atol of 1e-5 of the field's largest magnitude.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import params as jprm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_numpy_params  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402

RTOL = 1e-5
ARCH = "mamba2-1.3b"
J_SSD = jax.jit(jssm.ssd_chunked, static_argnames="chunk")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, rtol=RTOL):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(w))))


def _layer0(cfg):
    """(port tree, JAX tree) of layer 0 of the parity weights, fp32."""
    p = jax.tree.map(lambda a: a[0], lm_numpy_params(cfg, 0)["layers"])
    return prm.tree_map(torch.from_numpy, p), jax.tree.map(jnp.asarray, p)


@pytest.mark.parametrize("s,chunk,init", [(16, 16, False), (48, 16, False),
                                          (40, 16, False), (24, 8, True)])
def test_ssd_chunked_matches_reference(s, chunk, init):
    """40 over chunks of 16 falls back to the reference's largest divisor
    (10); ``init`` starts from a nonzero state."""
    rng = np.random.default_rng(s + chunk)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.2, (b, s, h)).astype(np.float32)
    a = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    bb = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, g, n)).astype(np.float32)
    d_skip = rng.standard_normal(h).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if init \
        else None
    t = [torch.from_numpy(v) for v in (x, dt, a, bb, cc, d_skip)]
    y, hf = ssm.ssd_chunked(*t, chunk=chunk, init_state=None if h0 is None
                            else torch.from_numpy(h0))
    jy, jhf = J_SSD(*[jnp.asarray(v) for v in (x, dt, a, bb, cc, d_skip)],
                    chunk=chunk, init_state=None if h0 is None
                    else jnp.asarray(h0))
    _close(y, jy)
    _close(hf, jhf)
    assert hf.dtype == torch.float32


def test_mamba2_forward_and_decode_match_reference():
    """The block over 12 tokens with its state (conv tail, SSM state), then
    four decode steps from that state, each against the reference."""
    cfg, jcfg = configs.reduced_config(ARCH), jconfigs.reduced_config(ARCH)
    tp, jp = _layer0(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    y, st = ssm.mamba2_forward(tp["ssm"], torch.from_numpy(x[:, :12]), cfg,
                               return_state=True)
    jfwd = jax.jit(lambda p, x: jssm.mamba2_forward(p, x, jcfg,
                                                    return_state=True))
    jy, jst = jfwd(jp["ssm"], jnp.asarray(x[:, :12]))
    _close(y, jy)
    for k in ("conv", "ssm"):
        _close(st[k], jst[k])
    jdec = jax.jit(lambda p, x, c: jssm.mamba2_decode(p, x, c, jcfg))
    cache = {k: v.clone() for k, v in st.items()}
    jcache = jst
    for i in range(12, 16):
        y, cache = ssm.mamba2_decode(tp["ssm"], torch.from_numpy(
            x[:, i:i + 1]), cache, cfg)
        jy, jcache = jdec(jp["ssm"], jnp.asarray(x[:, i:i + 1]), jcache)
        _close(y, jy)
        for k in ("conv", "ssm"):
            _close(cache[k], jcache[k])
    # the decode steps continue the forward: the same as 16 tokens at once
    full = ssm.mamba2_forward(tp["ssm"], torch.from_numpy(x), cfg)
    _close(y, full[:, -1:], 1e-4)


def test_mamba2_state_of_a_prompt_shorter_than_the_conv():
    """S = 2 < K - 1 = 3: the conv tail is left-padded with zeros."""
    cfg, jcfg = configs.reduced_config(ARCH), jconfigs.reduced_config(ARCH)
    tp, jp = _layer0(cfg)
    x = np.random.default_rng(4).standard_normal(
        (1, 2, cfg.d_model)).astype(np.float32)
    _, st = ssm.mamba2_forward(tp["ssm"], torch.from_numpy(x), cfg,
                               return_state=True)
    _, jst = jax.jit(lambda p, x: jssm.mamba2_forward(
        p, x, jcfg, return_state=True))(jp["ssm"], jnp.asarray(x))
    assert st["conv"].shape == (1, 3, jst["conv"].shape[-1])
    assert np.all(st["conv"][:, 0].numpy() == 0)
    _close(st["conv"], jst["conv"])


def test_mamba2_layer_apply_and_prefill_match_reference():
    """The ``mamba2`` layer kind (norm + block, residual) and its prefill
    cache."""
    cfg, jcfg = configs.reduced_config(ARCH), jconfigs.reduced_config(ARCH)
    tp, jp = _layer0(cfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    y, _ = transformer.layer_apply(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), cfg, "mamba2")
    jy, _ = jax.jit(lambda p, x: jtfm.layer_apply(
        p, x, jnp.asarray(pos), jcfg, "mamba2"))(jp, jnp.asarray(x))
    _close(y, jy)
    y, c = transformer.layer_prefill(tp, torch.from_numpy(x),
                                     torch.from_numpy(pos), cfg, "mamba2",
                                     max_seq=24, cache_dtype=torch.float32)
    jy, jc = jax.jit(lambda p, x: jtfm.layer_prefill(
        p, x, jnp.asarray(pos), jcfg, "mamba2", max_seq=24,
        cache_dtype=jnp.float32))(jp, jnp.asarray(x))
    _close(y, jy)
    for k in ("conv", "ssm"):
        _close(c[k], jc[k])


def test_mamba2_specs_and_cache_match_reference():
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    got, want = ssm.ssm_specs(cfg), jssm.ssm_specs(jcfg)
    assert list(got) == list(want)
    for k, s in got.items():
        assert (s.shape, s.logical, s.init) == \
            (want[k].shape, want[k].logical, want[k].init), k
    cs, jcs = ssm.mamba2_cache_spec(cfg, 4, 48), jssm.mamba2_cache_spec(
        jcfg, 4, 48)
    assert {k: (v.shape, str(v.dtype).split(".")[-1]) for k, v in cs.items()} \
        == {k: (v.shape, np.dtype(v.dtype).name) for k, v in jcs.items()}


@pytest.mark.parametrize("init", ["a_log", "dt_bias", "lambda_lru"])
def test_recurrent_initializers_match_reference_ranges(init):
    """``materialize``'s A_log, dt_bias and Lambda draws (the port's
    generator) and ``lm_numpy_params``' (numpy) against the reference's
    ``jax.random`` draws: the same formula, so the same range, each
    element inside the bounds the reference's formula maps its uniform
    range to, and matching means within a few standard errors."""
    n = 4096
    spec = prm.ParamSpec((2, n), ("layers", None), init=init,
                         dtype=torch.float32)
    got = prm.materialize(torch.Generator().manual_seed(0),
                          {"w": spec}, "cpu")["w"].numpy()
    jspec = jprm.ParamSpec((2, n), ("layers", None), init=init,
                           dtype=jnp.float32)
    want = np.asarray(jprm.materialize(jax.random.PRNGKey(0),
                                       {"w": jspec})["w"])
    u_lo, u_hi = {"a_log": (1.0, 16.0), "dt_bias": (np.log(1e-3),
                                                     np.log(1e-1)),
                  "lambda_lru": (0.9, 0.999)}[init]

    def formula(u):
        u = np.float64(u)
        if init == "a_log":
            return np.log(u)
        if init == "dt_bias":
            dt = np.exp(u)
            return dt + np.log(-np.expm1(-dt))
        return np.log(np.expm1(-np.log(u) * 8.0) + 1e-8)
    bounds = sorted((formula(u_lo), formula(u_hi)))
    pad = 1e-5 * max(abs(b) for b in bounds)
    from repro_torch.convert import _lm_uniform
    drawn = np.empty(n, np.float32)
    _lm_uniform(init, drawn, np.random.default_rng(0))
    for vals in (got, want, drawn):
        assert vals.min() >= bounds[0] - pad and vals.max() <= bounds[1] + pad
        assert np.isfinite(vals).all()
    sd = want.std() / np.sqrt(want.size)
    assert abs(got.mean() - want.mean()) < 6 * sd
    assert abs(drawn.mean() - want.mean()) < 6 * sd * np.sqrt(2)
    assert not np.array_equal(got[0], got[1])   # one draw per layer


def test_cut_depth_keeps_the_first_layers_of_the_parity_weights():
    """``lm_numpy_params`` with its per-leaf, per-layer generators: the
    1-layer model's weights are the 2-layer model's first layer (fp32
    leaves such as A_log included)."""
    cfg = configs.reduced_config(ARCH)
    full = dict(prm.leaves(lm_numpy_params(cfg, 0)))
    cut = dict(prm.leaves(lm_numpy_params(dataclasses.replace(cfg,
                                                              n_layers=1), 0)))
    for path, a in cut.items():
        want = full[path][:1] if path.startswith("layers/") else full[path]
        assert np.array_equal(a, want), path
