"""The port's optimizer (``repro_torch.optim``) against the JAX package's
``repro.optim``: the schedules, the global norm and clip, the int8 error
feedback and ``AdamW.update`` on the same gradients, fp32, within rtol
1e-6 (the reference called through ``jax.jit``), plus the in-place,
slice-at-a-time contract of the port's update."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch import tree as tr  # noqa: E402

RTOL = 1e-6


def _tree(seed: int, dtype=np.float32, scale: float = 1.0) -> dict:
    """A parameter-shaped tree: a stacked (L, a, b) leaf, a stacked norm
    (L, d), a matrix, a vector and a list, in an unsorted dict."""
    rng = np.random.default_rng(seed)
    shapes = {"w_stack": (3, 5, 7), "norm_stack": (3, 6), "b": (4,),
              "a": (6, 5), "lst": [(2, 3), (5,)]}

    def draw(shape):
        return (rng.standard_normal(shape) * scale).astype(dtype)
    return {k: ([draw(s) for s in v] if isinstance(v, list) else draw(v))
            for k, v in shapes.items()}


def _torch_tree(tree, dtype=torch.float32):
    return tr.tree_map(lambda a: torch.tensor(a, dtype=dtype), tree)


def _jax_tree(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _close(got, want, rtol=RTOL, atol=0.0):
    """Leaf by leaf within ``rtol``, with an atol of ``rtol`` times the
    leaf's scale (plus ``atol``): a parameter that an update brings near
    zero keeps the absolute error of its terms, not a relative one."""
    g = tr.leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        scale = float(np.max(np.abs(b), initial=0.0))
        np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol,
                                   atol=atol + rtol * scale)


def test_tree_flatten_order_is_jax_s():
    t = _tree(0)
    want = [np.asarray(x) for x in jax.tree.leaves(t)]
    got = tr.leaves(t)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    leaves, treedef = tr.flatten(t)
    back = tr.unflatten(treedef, leaves)
    assert sorted(back) == sorted(t)
    assert tr.leaves({"x": None, "y": [1, None]}) == [1]


@pytest.mark.parametrize("warmup,total", [(3, 10), (1, 1), (20, 100)])
def test_warmup_cosine_matches_reference(warmup, total):
    sched = optim.warmup_cosine(3e-4, warmup, total)
    jsched = jax.jit(joptim.warmup_cosine(3e-4, warmup, total))
    for step in range(0, total + 5):
        got = sched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = jsched(jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    got = optim.constant_lr(1e-3)(torch.tensor(4))
    assert got.dtype == torch.float32 and float(got) == np.float32(1e-3)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    t = _tree(1)
    got, gnorm = optim.clip_by_global_norm(_torch_tree(t), max_norm)
    want, jnorm = jax.jit(lambda x: joptim.clip_by_global_norm(
        x, max_norm))(_jax_tree(t))
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=RTOL)
    np.testing.assert_allclose(float(optim.global_norm(_torch_tree(t))),
                               float(joptim.global_norm(_jax_tree(t))),
                               rtol=RTOL)
    _close(got, want)


def test_clip_keeps_bf16_leaves_bf16():
    t = _torch_tree(_tree(2), torch.bfloat16)
    got, _ = optim.clip_by_global_norm(t, 0.5)
    want, _ = joptim.clip_by_global_norm(_jax_tree(_tree(2), jnp.bfloat16),
                                         0.5)
    for a, b in zip(tr.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_int8_round_trip_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((17, 9)).astype(np.float32) * 3
    q, s = optim.quantize_int8(torch.from_numpy(x))
    jq, js = joptim.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        optim.dequantize_int8(q, s).numpy(),
        np.asarray(joptim.dequantize_int8(jq, js)))
    # the all-zero leaf: the scale's floor, no NaN
    q0, s0 = optim.quantize_int8(torch.zeros(4))
    assert float(s0) > 0 and not q0.any()
    g, e = _tree(4), _tree(5, scale=0.01)
    got_g, got_e = optim.compress_decompress(_torch_tree(g), _torch_tree(e))
    want_g, want_e = joptim.compress_decompress(_jax_tree(g), _jax_tree(e))
    # op by op (the reference eager) the round trip is the same bits
    for got, want in ((got_g, want_g), (got_e, want_e)):
        for a, b in zip(tr.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _reference_steps(cfg, params, grads_seq, state_dtype):
    jopt = joptim.AdamW(joptim.AdamWConfig(
        **{**_kw(cfg), "state_dtype": state_dtype}))
    p = params
    st = jopt.init(p)
    upd = jax.jit(jopt.update)
    out = []
    for i, g in enumerate(grads_seq):
        p, st, met = upd(g, st, p, jnp.asarray(i, jnp.int32))
        out.append((p, st, met))
    return out


def _kw(cfg):
    return {f: getattr(cfg, f) for f in ("lr", "b1", "b2", "eps",
                                         "weight_decay", "clip_norm",
                                         "warmup_steps", "total_steps",
                                         "compress_grads")}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(compress, clip):
    """Three steps on the same gradients: params, m, v (and the residual)
    within rtol 1e-6; grad_norm and lr too. The update is in place: the
    returned tensors are the caller's."""
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                            clip_norm=clip, compress_grads=compress)
    opt = optim.AdamW(cfg)
    params0 = _tree(6, scale=0.1)
    grads_seq = [_tree(10 + i) for i in range(3)]
    params = _torch_tree(params0)
    ids = [id(t) for t in tr.leaves(params)]
    state = opt.init(params)
    want = _reference_steps(cfg, _jax_tree(params0),
                            [_jax_tree(g) for g in grads_seq], jnp.float32)
    for i, g in enumerate(grads_seq):
        params, state, met = opt.update(_torch_tree(g), state, params,
                                        torch.tensor(i, dtype=torch.int32))
        jp, jst, jmet = want[i]
        _close(params, jp)
        _close(state["m"], jst["m"])
        _close(state["v"], jst["v"])
        if compress:
            # the residual is target - round trip, two terms of the
            # gradient's size: its error is relative to the gradient (the
            # jitted reference contracts the round trip into an FMA)
            g_scale = max(float(np.abs(x).max()) for x in tr.leaves(g))
            _close(state["err"], jst["err"], atol=RTOL * g_scale)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                                   rtol=RTOL)
    assert [id(t) for t in tr.leaves(params)] == ids


def test_adamw_bf16_params_and_state_round_like_the_reference():
    """bf16 params and bf16 m / v: the casts back land on the same bf16
    values (one bf16 ULP where an fp32 difference straddles a rounding)."""
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                            state_dtype=torch.bfloat16)
    opt = optim.AdamW(cfg)
    p0, g0 = _tree(7, scale=0.1), _tree(8)
    params = _torch_tree(p0, torch.bfloat16)
    state = opt.init(params)
    assert all(t.dtype == torch.bfloat16 for t in tr.leaves(state))
    params, state, _ = opt.update(_torch_tree(g0, torch.bfloat16), state,
                                  params, torch.tensor(0, dtype=torch.int32))
    (jp, jst, _), = _reference_steps(cfg, _jax_tree(p0, jnp.bfloat16),
                                     [_jax_tree(g0, jnp.bfloat16)],
                                     jnp.bfloat16)
    for got, want in ((params, jp), (state["m"], jst["m"]),
                      (state["v"], jst["v"])):
        for a, b in zip(tr.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=2 ** -8, atol=0)


def test_weight_decay_only_on_leaves_of_two_or_more_dims():
    """Zero gradients: a leaf moves only by its decay, which the reference
    applies to ndim >= 2 leaves — a stacked norm (L, d) included."""
    cfg = optim.AdamWConfig(lr=1e-1, warmup_steps=1, total_steps=4)
    opt = optim.AdamW(cfg)
    p0 = _tree(9, scale=0.1)
    params = _torch_tree(p0)
    zeros = tr.tree_map(torch.zeros_like, params)
    opt.update(zeros, opt.init(params), params,
               torch.tensor(0, dtype=torch.int32))
    for got, want in zip(tr.leaves(params), jax.tree.leaves(p0)):
        moved = not np.array_equal(got.numpy(), want)
        assert moved == (want.ndim >= 2)


def test_init_abstract_is_meta_and_matches_init():
    opt = optim.AdamW(optim.AdamWConfig(compress_grads=True))
    params = _torch_tree(_tree(0))
    meta = tr.tree_map(lambda t: t.to("meta"), params)
    abstract = opt.init_abstract(meta)
    real = opt.init(params)
    assert sorted(abstract) == ["err", "m", "v"]
    for a, r in zip(tr.leaves(abstract), tr.leaves(real)):
        assert a.is_meta and a.shape == r.shape and a.dtype == r.dtype
        assert not r.any()
