"""Port parity: Griffin's RG-LRU block (``repro_torch.models.rglru``)
against the JAX package's ``repro.models.rglru`` in fp32 on numpy-seeded
inputs and ``lm_numpy_params`` weights of recurrentgemma-2b-reduced: the
log-depth scan against ``lax.associative_scan`` (odd and even lengths,
one element), the gates, the block's forward with its decode state, decode
steps continuing a prefill, and the ``recurrent`` layer. Tolerance: rtol
1e-5 with an atol of 1e-5 of the field's largest magnitude (the scan's
multiply-adds may round apart from XLA's fused ones by a few ulps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_numpy_params  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import rglru, transformer  # noqa: E402

RTOL = 1e-5
ARCH = "recurrentgemma-2b"


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, rtol=RTOL):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(w))))


def _layer(cfg, i):
    """(port tree, JAX tree) of layer i of the parity weights, fp32."""
    p = lm_numpy_params(cfg, 0)["layers"][i]
    return prm.tree_map(torch.from_numpy, p), jax.tree.map(jnp.asarray, p)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 2048])
def test_associative_scan_matches_lax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 16)).astype(np.float32)
    b = rng.standard_normal((2, n, 16)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    got = rglru.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got[0], want[0])
    _close(got[1], want[1])
    # the recurrence it computes
    h = np.zeros((2, 16), np.float64)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(got[1][:, -1].numpy(), h, rtol=1e-4,
                               atol=1e-4 * np.abs(h).max())


def test_gates_match_reference():
    cfg = configs.reduced_config(ARCH)
    tp, jp = _layer(cfg, 0)
    x = np.random.default_rng(1).standard_normal((2, 9, 64)).astype(
        np.float32)
    la, g = rglru._gates(tp["rglru"], torch.from_numpy(x))
    jla, jg = jrglru._gates(jp["rglru"], jnp.asarray(x))
    _close(la, jla)
    _close(g, jg)
    assert float(la.max()) <= 0.0


@pytest.mark.parametrize("s", [13, 32])
def test_rglru_forward_and_decode_match_reference(s):
    """The block over ``s`` tokens with its state (conv tail, h), then
    three decode steps from that state, each against the reference; the
    decode steps equal the forward over all the tokens."""
    cfg, jcfg = configs.reduced_config(ARCH), jconfigs.reduced_config(ARCH)
    tp, jp = _layer(cfg, 1)
    x = np.random.default_rng(s).standard_normal(
        (2, s + 3, cfg.d_model)).astype(np.float32)
    y, st = rglru.rglru_forward(tp["rglru"], torch.from_numpy(x[:, :s]), cfg,
                                return_state=True)
    jy, jst = jax.jit(lambda p, x: jrglru.rglru_forward(
        p, x, jcfg, return_state=True))(jp["rglru"], jnp.asarray(x[:, :s]))
    _close(y, jy)
    for k in ("conv", "h"):
        _close(st[k], jst[k])
    jdec = jax.jit(lambda p, x, c: jrglru.rglru_decode(p, x, c, jcfg))
    cache = {k: v.clone() for k, v in st.items()}
    jcache = jst
    for i in range(s, s + 3):
        y, cache = rglru.rglru_decode(tp["rglru"], torch.from_numpy(
            x[:, i:i + 1]), cache, cfg)
        jy, jcache = jdec(jp["rglru"], jnp.asarray(x[:, i:i + 1]), jcache)
        _close(y, jy)
        for k in ("conv", "h"):
            _close(cache[k], jcache[k])
    full = rglru.rglru_forward(tp["rglru"], torch.from_numpy(x), cfg)
    _close(y, full[:, -1:], 1e-4)


def test_recurrent_layer_apply_and_prefill_match_reference():
    cfg, jcfg = configs.reduced_config(ARCH), jconfigs.reduced_config(ARCH)
    tp, jp = _layer(cfg, 0)
    x = np.random.default_rng(7).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    y, _ = transformer.layer_apply(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), cfg, "recurrent")
    jy, _ = jax.jit(lambda p, x: jtfm.layer_apply(
        p, x, jnp.asarray(pos), jcfg, "recurrent"))(jp, jnp.asarray(x))
    _close(y, jy)
    y, c = transformer.layer_prefill(tp, torch.from_numpy(x),
                                     torch.from_numpy(pos), cfg, "recurrent",
                                     max_seq=24, cache_dtype=torch.float32)
    jy, jc = jax.jit(lambda p, x: jtfm.layer_prefill(
        p, x, jnp.asarray(pos), jcfg, "recurrent", max_seq=24,
        cache_dtype=jnp.float32))(jp, jnp.asarray(x))
    _close(y, jy)
    for k in ("conv", "h"):
        _close(c[k], jc[k])


def test_rglru_specs_and_cache_match_reference():
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    got, want = rglru.rglru_specs(cfg), jrglru.rglru_specs(jcfg)
    assert list(got) == list(want)
    for k, s in got.items():
        assert (s.shape, s.logical, s.init) == \
            (want[k].shape, want[k].logical, want[k].init), k
    cs = rglru.rglru_cache_spec(cfg, 4, 26)
    jcs = jrglru.rglru_cache_spec(jcfg, 4, 26)
    assert {k: (v.shape, str(v.dtype).split(".")[-1]) for k, v in cs.items()} \
        == {k: (v.shape, np.dtype(v.dtype).name) for k, v in jcs.items()}
