"""Causal flash attention forward — the LM zoo's attention kernel.

:func:`flash_attention` takes q of shape (BH, S, D) and k, v of shape
(BH / G, S, D): query row ``bh`` attends to KV row ``bh // G`` (G = 1 is
the reference's signature; G > 1 is grouped-query attention without
repeating K/V). On CPU tensors it runs :func:`attention_plain`, a
non-blocked version in the TPU kernel's operation order (q in fp32 scaled
by 1/sqrt(D), fp32 logits, the causal mask at -1e30, softmax, fp32
``@ v``, cast to q's dtype); on CUDA tensors it launches
``csrc/flash_attn.cu`` (the port of
``src/repro/kernels/flash_attn.py:flash_attention``) or raises. The same
argument checks hold on both devices.

The kernel has two routes, picked by :func:`route` from (dtype, D) alone
and counted apart in ``ops.LAUNCHES``: bf16 with D in ``TC_HEAD_DIMS``
runs on the tensor cores (``wgmma``: fp32 logits of exact bf16 products,
scaled after the product, P split into bf16 hi + lo for ``@ v``), every
other case (fp32, D = 8) on the fp32 cores.

:func:`work` reckons a call's operations and bytes from its shapes; in
``ops.dry_run`` the entry point takes meta tensors and records it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ops

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
TC_HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)


def route(dtype, d: int) -> str:
    """The kernel route (and launch counter) for inputs of ``dtype`` and
    head dim ``d``: ``"flash_attention"`` (tensor cores) for bf16 with D
    in ``TC_HEAD_DIMS``, else ``"flash_attention_simt"`` (fp32 cores)."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "flash_attention"
    return "flash_attention_simt"


def _check(q, k, v, groups: int):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes (BH, S, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    if groups < 1 or bh % groups or k.shape != (bh // groups, s, d) \
            or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} with groups "
                         f"{groups} needs k and v of shape "
                         f"{(bh // max(groups, 1), s, d)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes bf16 or fp32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")


def work(q_shape, kv_shape, dtype, groups: int = 1) -> ops.Work:
    """One causal call on q (BH, S, D) and k / v (BH / G, S, D): the two
    products over the causal half, S (S + 1) / 2 scores a row (2 D
    operations each, twice), at the tensor cores' bf16 peak or the fp32
    peak; q, k and v read and the output written."""
    bh, s, d = q_shape
    size = torch.empty((), dtype=dtype).element_size()
    kv = 1
    for x in kv_shape:
        kv *= x
    return ops.Work(2 * d * s * (s + 1) * bh,
                    (2 * bh * s * d + 2 * kv) * size,
                    "bf16" if dtype == torch.bfloat16 else "fp32")


def attention_plain(q, k, v, groups: int = 1):
    """The kernel's function without blocking: (BH, S, D) -> (BH, S, D)."""
    s, d = q.shape[1], q.shape[2]
    scale = 1.0 / (d ** 0.5)
    kf = k.float().repeat_interleave(groups, dim=0)
    vf = v.float().repeat_interleave(groups, dim=0)
    logits = (q.float() * scale) @ kf.transpose(1, 2)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return (w @ vf).to(q.dtype)


@functools.cache
def _kernel(name: str):
    lib = _build.library("flash_attn")
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    ints = 4 if name == "flash_attention_tc" else 5    # + is_bf16 (simt)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * ints
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib, fn


def _launch(q, k, v, groups: int):
    dev = ops.same_cuda_device(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    bh, s, d = q.shape
    if -(-s // 64) * bh >= 2 ** 31:
        raise ValueError(f"flash_attention: grid of {bh} x {s} too large")
    counter = route(q.dtype, d)
    tensor_cores = counter == "flash_attention"
    if tensor_cores and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core route's TMA "
                         "loads need 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    if bh and s:
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if tensor_cores:
            lib, fn = _kernel("flash_attention_tc")
            code = fn(*ptrs, bh, s, d, groups, 1.0 / (d ** 0.5),
                      dev.index or 0, stream)
        else:
            lib, fn = _kernel("flash_attention_simt")
            code = fn(*ptrs, bh, s, d, groups,
                      int(q.dtype == torch.bfloat16), 1.0 / (d ** 0.5),
                      dev.index or 0, stream)
        _build.raise_on_error(lib, code, counter)
        ops.count_launch(counter)
    return out


def flash_attention(q, k, v, *, groups: int = 1):
    """Causal attention. q (BH, S, D), k and v (BH / groups, S, D), bf16 or
    fp32, D in ``HEAD_DIMS`` -> (BH, S, D) in q's dtype."""
    _check(q, k, v, groups)
    if ops.dry_route(q, k, v):
        ops.record_work(route(q.dtype, q.shape[2]), work(
            tuple(q.shape), tuple(k.shape), q.dtype, groups))
        return torch.empty_like(q, device="meta")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_plain(q, k, v, groups)
    return _launch(q, k, v, groups)
