"""Port parity: ``flash_attention``'s plain version against the JAX
package's Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) and its oracle ``ref.flash_attention_ref``, on the same inputs
drawn with numpy; causality, grouped K/V, a ragged S and the wrapper's
argument checks. On the CPU the wrapper runs the plain version; the CUDA
kernel is held against it on the card by ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attn, ops  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _both(arrays, dtype):
    """The same values in both packages: float32 arrays rounded to the
    dtype by each (bf16: round to nearest even on both sides)."""
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a).astype(jdt) for a in arrays])


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("s,d,bq", [(256, 64, 128), (512, 64, 128),
                                    (256, 128, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_kernel_and_oracle(s, d, bq, dtype):
    """tests/test_kernels.py::test_flash_attention's grid and tolerances."""
    (q, k, v), (jq, jk, jv) = _both(_inputs((1, 2, s, d), s + d), dtype)
    got = ops.flash_attention(q, k, v)
    kernel = jops.flash_attention(jq, jk, jv, block_q=bq,
                                  block_k=min(bq, 128), interpret=True)
    oracle = jref.flash_attention_ref(jq.reshape(2, s, d), jk.reshape(2, s, d),
                                      jv.reshape(2, s, d)).reshape(1, 2, s, d)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = DTYPES[dtype][2]
    for want in (kernel, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_is_causal():
    """tests/test_kernels.py::test_flash_attention_is_causal on the port:
    keys and values past position 200 leave earlier outputs unchanged."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 1, 256, 64), 9))
    o1 = ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 200:] = 99.0
    v2[:, :, 200:] = -99.0
    o2 = ops.flash_attention(q, k2, v2)
    assert torch.equal(o1[:, :, :200], o2[:, :, :200])
    assert not torch.equal(o1[:, :, 200:], o2[:, :, 200:])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_groups_equal_repeated_kv(dtype):
    """G = 3 query rows per KV row equal G = 1 on K/V repeated 3 times,
    exactly; and ``ops.flash_attention`` (B, H, S, D) with H / KVH = 3
    equals the JAX wrapper on repeated K/V."""
    (q, k, v), (jq, jk, jv) = _both(
        [*_inputs((2, 6, 128, 32), 4, 1), *_inputs((2, 2, 128, 32), 5, 2)],
        dtype)
    grouped = ops.flash_attention(q, k, v)
    rep = [t.repeat_interleave(3, dim=1) for t in (k, v)]
    assert torch.equal(grouped, ops.flash_attention(q, *rep))
    assert torch.equal(
        flash_attn.flash_attention(q.reshape(12, 128, 32),
                                   k.reshape(4, 128, 32),
                                   v.reshape(4, 128, 32), groups=3),
        grouped.reshape(12, 128, 32))
    want = jops.flash_attention(jq, jnp.repeat(jk, 3, axis=1),
                                jnp.repeat(jv, 3, axis=1), interpret=True)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(grouped), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [1, 100, 500])
def test_ragged_s_matches_reference_on_the_same_positions(s):
    """S not a multiple of any block: the oracle at S, and the Pallas
    kernel at S padded to 512 with other keys past S (which a causal
    output at a position below S never sees), on positions 0 .. S-1."""
    padded = _inputs((1, 2, 512, 64), s)
    (q, k, v), _ = _both([a[:, :, :s] for a in padded], "float32")
    got = _np(ops.flash_attention(q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in padded)
    kernel = jops.flash_attention(jq, jk, jv, interpret=True)[:, :, :s]
    oracle = jref.flash_attention_ref(
        *(t.reshape(2, 512, 64)[:, :s] for t in (jq, jk, jv)))
    np.testing.assert_allclose(got, _np(kernel), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _np(oracle).reshape(1, 2, s, 64),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case,error", [
    ("head dim 48", ValueError), ("head dim 256", ValueError),
    ("float16", TypeError), ("mixed dtypes", TypeError),
    ("groups not dividing", ValueError), ("kv rows wrong", ValueError),
    ("rank 4", ValueError)])
def test_unsupported_arguments_raise(case, error):
    q = torch.zeros(6, 32, 64)
    k = v = torch.zeros(3, 32, 64)
    groups = 2
    if case.startswith("head dim"):
        d = int(case.split()[-1])
        q, k, v = torch.zeros(6, 32, d), torch.zeros(3, 32, d), \
            torch.zeros(3, 32, d)
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed dtypes":
        q = q.bfloat16()
    elif case == "groups not dividing":
        groups = 4
    elif case == "kv rows wrong":
        k = v = torch.zeros(2, 32, 64)
    elif case == "rank 4":
        q = q[None]
    with pytest.raises(error):
        flash_attn.flash_attention(q, k, v, groups=groups)


def test_cpu_call_counts_no_launch():
    before = ops.LAUNCHES["flash_attention"]
    q = torch.zeros(2, 8, 16)
    flash_attn.flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == before
