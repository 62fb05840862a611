"""Port parity: the mixture-of-experts FFN (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe``, in fp32 on numpy-seeded
inputs: the routing (softmax, and sigmoid with a selection bias), the
capacity, the dispatch's drop set (equal, ties included) and ``moe_ffn``
at the configs' capacity factor and at an ample one. Tolerance: rtol
1e-5 with an atol of 1e-5 of the field's largest magnitude; discrete
results (expert ids, slots, drops) equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import Family as JFamily  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import Family, ModelConfig, MoEConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

RTOL = 1e-5
# the reference's functions, compiled (op-by-op dispatch of a vmapped
# dispatch costs seconds a call); the config is a static argument
J_MOE_FFN = jax.jit(jmoe.moe_ffn, static_argnums=2, static_argnames="n_groups")
J_ROUTING = jax.jit(jmoe._routing, static_argnums=2)
J_DISPATCH = jax.jit(jmoe._dispatch_indices, static_argnums=(1, 2))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, rtol=RTOL):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(w))))


def _cfgs(e=8, k=2, cf=1.25, router="softmax", shared=0, d=32):
    """(port config, reference config) of one MoE layer's shape."""
    def make(mc, moec, fam):
        return mc(name="t", family=fam.MOE, n_layers=1, d_model=d,
                  n_heads=4, n_kv_heads=4, d_ff=64, vocab=64,
                  moe=moec(n_experts=e, top_k=k, n_shared=shared,
                           d_ff_expert=48, capacity_factor=cf,
                           router=router))
    return (make(ModelConfig, MoEConfig, Family),
            make(JModelConfig, JMoEConfig, JFamily))


def _params(cfg, seed, bias_scale=0.0):
    """fp32 numpy weights for ``moe_specs(cfg)``: 1/sqrt(fan-in) normals,
    a router bias of ``bias_scale`` normals where the config has one."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in moe.moe_specs(cfg).items():
        if name == "router_bias":
            out[name] = (bias_scale * rng.standard_normal(s.shape)).astype(
                np.float32)
        else:
            fan = s.shape[-2]
            out[name] = (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(
                np.float32)
    return out


def _both(p):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("router,bias", [("softmax", 0.0), ("sigmoid", 0.0),
                                         ("sigmoid", 0.3)])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_routing_matches_reference(router, bias, k):
    """Expert ids equal, weights and the aux loss within rtol, over two
    groups of 48 tokens."""
    cfg, jcfg = _cfgs(e=16, k=k, router=router)
    tp, jp = _both(_params(cfg, k, bias))
    x = np.random.default_rng(k + 10).standard_normal(
        (2, 48, 32)).astype(np.float32)
    w, ids, aux = moe._routing(tp, torch.from_numpy(x), cfg)
    jw, jids, jaux = J_ROUTING(jp, jnp.asarray(x), jcfg)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)
    _close(aux.reshape(1), np.asarray(jaux).reshape(1))


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_routing_breaks_ties_as_lax_top_k(router):
    """Experts 1, 3 and 6 have the same router column, so their scores tie
    exactly on every token: both packages pick the lowest index among
    them, in the same order."""
    cfg, jcfg = _cfgs(e=8, k=2, router=router)
    p = _params(cfg, 3)
    p["router"][:, 1] += 5.0 / np.sqrt(32)     # make the tied trio win often
    p["router"][:, [3, 6]] = p["router"][:, [1]]
    tp, jp = _both(p)
    x = np.random.default_rng(4).standard_normal((1, 40, 32)).astype(
        np.float32)
    _, ids, _ = moe._routing(tp, torch.from_numpy(x), cfg)
    _, jids, _ = J_ROUTING(jp, jnp.asarray(x), jcfg)
    ids = ids.numpy()
    assert np.array_equal(ids, np.asarray(jids))
    tied = np.isin(ids, [1, 3, 6]).sum(-1)
    assert (tied == 2).any()                   # the tie decided top-2 slots
    assert not np.isin(ids, [6]).any()         # ... for the lowest indices


def test_top_k_orders_like_lax_top_k():
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.9]], np.float32)
    v, i = moe.top_k(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert i.tolist() == [[1, 3, 5, 0]]


@pytest.mark.parametrize("n,e,cap,seed", [(64, 4, 8, 0), (128, 8, 128, 1),
                                          (300, 16, 16, 2), (96, 6, 8, 3)])
def test_dispatch_drop_set_equals_reference(n, e, cap, seed):
    """The destination slot of every assignment and the drop set, equal —
    including long runs of one expert (a skewed draw), where the stable
    ranking decides who is dropped."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, e, n)
    ids[: n // 3] = rng.integers(0, 2, n // 3)     # skew: experts 0-1 overflow
    dest, ok = moe._dispatch_indices(torch.from_numpy(ids), e, cap)
    jdest, jok = J_DISPATCH(jnp.asarray(ids, jnp.int32), e, cap)
    assert np.array_equal(dest.numpy(), np.asarray(jdest))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    kept = dest.numpy()[ok.numpy()]
    assert len(np.unique(kept)) == len(kept)
    assert np.all(np.bincount(kept // cap, minlength=e) <= cap)


def test_dispatch_drop_set_with_tied_scores_equals_reference():
    """All scores tie (a zero router): every token routes to experts 0 and
    1, and capacity keeps the first tokens in (token, k) order — the same
    ones in both packages."""
    cfg, jcfg = _cfgs(e=8, k=2, cf=1.25)
    p = _params(cfg, 5)
    p["router"][:] = 0.0
    tp, jp = _both(p)
    x = np.random.default_rng(6).standard_normal((2, 40, 32)).astype(
        np.float32)
    _, ids, _ = moe._routing(tp, torch.from_numpy(x), cfg)
    _, jids, _ = J_ROUTING(jp, jnp.asarray(x), jcfg)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert (ids.numpy() == [0, 1]).all()
    cap = moe.capacity(80, cfg)
    assert cap == jmoe.capacity(80, jcfg) == 32
    dest, ok = moe._dispatch_indices(ids.reshape(-1), 8, cap)
    jdest, jok = J_DISPATCH(jids.reshape(-1), 8, cap)
    assert np.array_equal(dest.numpy(), np.asarray(jdest))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert ok.numpy().sum() == 2 * cap
    y, _ = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    jy, _ = J_MOE_FFN(jp, jnp.asarray(x), jcfg)
    _close(y, jy)


@pytest.mark.parametrize("tokens,cf", [(7, 1.25), (80, 1.25), (1000, 1.25),
                                       (80, 64.0), (4096, 0.5)])
def test_capacity_matches_reference(tokens, cf):
    cfg, jcfg = _cfgs(e=16, k=6, cf=cf)
    assert moe.capacity(tokens, cfg) == jmoe.capacity(tokens, jcfg)
    assert moe.capacity(tokens, cfg) % 8 == 0


def test_capacity_factor_reads_the_environment(monkeypatch):
    """``REPRO_MOE_CF`` overrides the config's factor, read at each call
    through ``ops.moe_capacity_factor``, as in the reference."""
    cfg, jcfg = _cfgs(e=16, k=6, cf=1.25)
    base = moe.capacity(1000, cfg)
    monkeypatch.setenv("REPRO_MOE_CF", "4.0")
    assert ops.moe_capacity_factor(1.25) == 4.0
    assert moe.capacity(1000, cfg) == jmoe.capacity(1000, jcfg) > base
    monkeypatch.delenv("REPRO_MOE_CF")
    assert moe.capacity(1000, cfg) == base


@pytest.mark.parametrize("router,shared", [("softmax", 2), ("sigmoid", 1),
                                           ("softmax", 0)])
@pytest.mark.parametrize("cf", [0.5, 1.25, 64.0])
def test_moe_ffn_matches_reference(router, shared, cf):
    """fp32, 2 x 40 tokens over 8 experts top-2: at cf 0.5 (16 slots for
    an average load of 20: assignments dropped), at the configs' 1.25 and
    with ample capacity (none dropped)."""
    cfg, jcfg = _cfgs(e=8, k=2, cf=cf, router=router, shared=shared)
    tp, jp = _both(_params(cfg, 7, 0.2))
    x = np.random.default_rng(8).standard_normal((2, 40, 32)).astype(
        np.float32)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    jy, jaux = J_MOE_FFN(jp, jnp.asarray(x), jcfg)
    _close(y, jy)
    _close(aux.reshape(1), np.asarray(jaux).reshape(1))
    _, ids, _ = moe._routing(tp, torch.from_numpy(x).reshape(1, 80, 32), cfg)
    dropped = ~moe._dispatch_indices(ids.reshape(-1), 8,
                                     moe.capacity(80, cfg))[1]
    if cf != 1.25:
        assert bool(dropped.any()) == (cf < 1)


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_moe_ffn_groups_match_reference(groups):
    """``n_groups`` splits the tokens into independent dispatch groups
    (3 does not divide 32 tokens: one group), as the reference does."""
    cfg, jcfg = _cfgs(e=4, k=1, cf=1.0)
    tp, jp = _both(_params(cfg, 9))
    x = np.random.default_rng(10).standard_normal((2, 16, 32)).astype(
        np.float32)
    y, _ = moe.moe_ffn(tp, torch.from_numpy(x), cfg, n_groups=groups)
    jy, _ = J_MOE_FFN(jp, jnp.asarray(x), jcfg, n_groups=groups)
    _close(y, jy)


def test_moe_equals_dense_mixture_when_capacity_ample():
    """tests/test_moe.py's contract on the port: top_k == n_experts and
    an ample capacity give the exact softmax mixture of the expert FFNs."""
    cfg, _ = _cfgs(e=4, k=4, cf=64.0)
    tp, _ = _both(_params(cfg, 11))
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 8, 32)).astype(np.float32))
    y, _ = moe.moe_ffn(tp, x, cfg)
    w = torch.softmax(torch.einsum("bsd,de->bse", x, tp["router"]), -1)
    dense = 0
    for e in range(4):
        g = x @ tp["w_gate"][e]
        h = torch.nn.functional.silu(g) * (x @ tp["w_up"][e])
        dense = dense + w[..., e:e + 1] * (h @ tp["w_down"][e])
    _close(y, dense, 1e-5)


def test_moe_ffn_bf16_matches_reference():
    """bf16 activations and weights (the router fp32, as the spec says):
    the same ids, the output within bf16 rounding."""
    cfg, jcfg = _cfgs(e=8, k=2, cf=1.25, router="sigmoid", shared=1)
    p = _params(cfg, 13, 0.2)
    tp = {k: torch.from_numpy(v).to(torch.float32 if k.startswith("router")
                                    else torch.bfloat16)
          for k, v in p.items()}
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k.startswith("router")
                                   else jnp.bfloat16) for k, v in p.items()}
    x = np.random.default_rng(14).standard_normal((2, 24, 32)).astype(
        np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    _, ids, _ = moe._routing(tp, tx.reshape(1, 48, 32), cfg)
    _, jids, _ = J_ROUTING(jp, jx.reshape(1, 48, 32), jcfg)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    y, _ = moe.moe_ffn(tp, tx, cfg)
    jy, _ = J_MOE_FFN(jp, jx, jcfg)
    assert y.dtype == torch.bfloat16
    _close(y, jy, 1e-2)


def test_moe_specs_match_reference():
    for router, shared in (("softmax", 2), ("sigmoid", 1)):
        cfg, jcfg = _cfgs(router=router, shared=shared)
        got = moe.moe_specs(cfg)
        want = jmoe.moe_specs(jcfg)
        assert list(got) == list(want)
        for name, s in got.items():
            w = want[name]
            assert (s.shape, s.logical, s.init, s.scale) == \
                (w.shape, w.logical, w.init, w.scale), name
            assert str(s.dtype).split(".")[-1] == np.dtype(w.dtype).name, name
