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


def _tensor_core_rounding(q, k, v, *, split_p=True, drop_tile=None):
    """The tensor-core route's arithmetic on bf16 q, k, v (BH, S, D), in
    fp32 before the output cast: products of bf16 values (exact in fp32)
    summed in fp32, the 1/sqrt(D) scale applied after the product, the
    causal mask and softmax in fp32, then P split into bf16 hi + lo (or
    rounded once to bf16, as SDPA's P is) and ``@ v`` in fp32. With
    ``drop_tile`` = j, keys 64 j .. 64 j + 63 are left out (key 0 stays),
    as a kernel that lost one K/V tile would."""
    s, d = q.shape[1], q.shape[2]
    logits = (q.float() @ k.float().transpose(1, 2)) * (1.0 / d ** 0.5)
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    if drop_tile is not None:
        causal[:, max(64 * drop_tile, 1):64 * drop_tile + 64] = False
    p = torch.softmax(torch.where(causal, logits, flash_attn.NEG_INF), -1)
    hi = p.bfloat16().float()
    if not split_p:
        return hi @ v.float()
    lo = (p - hi).bfloat16().float()
    return hi @ v.float() + lo @ v.float()


@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_rounding_keeps_the_plain_function(s, d):
    """Scale after the product and a bf16 hi + lo split of P stay within
    1e-5 of max |out| of ``attention_plain`` in fp32 (measured ~3e-6 on
    the CPU); one bf16 P lands two orders of magnitude further away
    (measured ~1.2e-3 to 2.2e-3), which is why the kernel splits P."""
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, d))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    want = flash_attn.attention_plain(q.float(), k.float(), v.float())
    scale = float(want.abs().max())
    split = float((_tensor_core_rounding(q, k, v) - want).abs().max())
    single = float((_tensor_core_rounding(q, k, v, split_p=False)
                    - want).abs().max())
    assert split <= 1e-5 * scale
    assert single >= 100 * split


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "flash_attention"),
    (torch.bfloat16, 64, "flash_attention"),
    (torch.bfloat16, 32, "flash_attention"),
    (torch.bfloat16, 16, "flash_attention"),
    (torch.bfloat16, 8, "flash_attention_simt"),
    (torch.float32, 128, "flash_attention_simt"),
    (torch.float32, 8, "flash_attention_simt")])
def test_route_is_fixed_by_dtype_and_head_dim(dtype, d, want):
    """bf16 with D in TC_HEAD_DIMS takes the tensor cores, fp32 and D = 8
    the fp32 cores; each route has its own launch counter."""
    assert flash_attn.route(dtype, d) == want
    assert want in ops.LAUNCHES


# chip_smoke.py's limits on the tensor-core route's bf16 output:
# FLASH_ULP (|got - want| <= 2^-7 |want| + 2^-9) and FLASH_OFF_ULP (the
# share of outputs that differ from the plain version's at all)
_ULP, _OFF = (2.0 ** -7, 2.0 ** -9), 0.05


def _against_limits(got, want):
    err = (got.double() - want.double()).abs()
    ulp = float((err / (_ULP[0] * want.double().abs() + _ULP[1])).max())
    return ulp, float((got != want).double().mean())


@pytest.mark.parametrize("s", [256, 512])
def test_bf16_resolution_limits_separate_the_route_from_its_faults(s):
    """The route's rounding, cast to bf16, lies within the ulp limit of
    the plain version's bf16 output and differs from it in well under
    FLASH_OFF_ULP of the outputs (measured ~0.2-0.3%). One bf16 P differs
    in ~40% of them, and a lost K/V tile exceeds the ulp limit many times
    over; the reference's 3e-2 alone would pass both."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, 128))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    want = flash_attn.attention_plain(q, k, v)
    ulp, off = _against_limits(_tensor_core_rounding(q, k, v).bfloat16(),
                               want)
    assert ulp <= 1.0 and off <= _OFF / 5
    _, off_single = _against_limits(
        _tensor_core_rounding(q, k, v, split_p=False).bfloat16(), want)
    assert off_single >= 4 * _OFF
    for tile in (1, s // 64 - 1):
        ulp_drop, _ = _against_limits(
            _tensor_core_rounding(q, k, v, drop_tile=tile).bfloat16(), want)
        assert ulp_drop > 4.0
