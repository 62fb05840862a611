"""Stacked 3-layer MLP surrogate heads (the fused inference hot spot).

:func:`mlp_surrogate_heads` evaluates P predictor heads of any widths
(the production MLP(100, 50), or wider) over one ``(N, F)`` feature
matrix. Its plain PyTorch version is the einsum path of the reference's
``surrogate._predict_mlp_stacked``; on CUDA tensors it launches
``csrc/mlp_heads.cu``: a persistent grid of row tiles, the heads staged
in shared memory once per block (a group at a time, or a head's matrices
slice by slice where they do not fit), each layer a register-tiled
product from shared memory.

:func:`mlp_surrogate` is the single unstandardized head, ``(N, F) ->
(N,)``: a kernel of its own (``mlp_single``: the same row tiles and
products without the standardizer, the head staged in two groups so that
the first layer starts before the second layer's weights land, fp32 or
bf16 rows read as they are); a head too wide for it runs through the
heads' kernel at P = 1.

:func:`heads_work` and :func:`single_work` reckon a call's operations
and bytes from its shapes (:func:`head_flops` per row and head, shared
with the tick's reckoning); in ``ops.dry_run`` both entry points take
meta tensors and record them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ops


def mlp_head_flops(f: int, h1: int, h2: int) -> int:
    """One row through one standardized head: standardize, three layers
    with bias and relu, destandardize (fp32, a multiply-add counts 2)."""
    return 2 * f + 2 * (f * h1 + h1 * h2 + h2) + 2 * (h1 + h2) + 4


def head_flops(fam: str, f: int, h1: int, h2: int) -> int:
    """One row through one head of family ``fam``."""
    if fam == "mean":
        return 3
    if fam == "linear":
        return 2 * f + 2 * f + 4
    return mlp_head_flops(f, h1, h2)


def heads_work(n: int, f: int, p: int, h1: int, h2: int,
               array_elems: int) -> ops.Work:
    """``mlp_surrogate_heads`` over (n, f) rows and P heads whose ten
    stacked arrays hold ``array_elems`` floats: every row through every
    head; x and the arrays read, the (P, n) outputs written."""
    return ops.Work(n * p * mlp_head_flops(f, h1, h2),
                    (n * f + array_elems + p * n) * 4)


def single_work(n: int, f: int, h1: int, h2: int,
                array_elems: int) -> ops.Work:
    """``mlp_surrogate`` over (n, f) rows, its six arrays holding
    ``array_elems`` floats (no standardizer)."""
    return ops.Work(n * (2 * (f * h1 + h1 * h2 + h2) + 2 * (h1 + h2)),
                    (n * f + array_elems + n) * 4)


def mlp_heads_plain(x, x_mu, x_sd, y_mu, y_sd, w1, b1, w2, b2, w3, b3):
    """(N, F) + P stacked heads -> (P, N), as batched einsums."""
    h = (x[None] - x_mu[:, None]) / x_sd[:, None]
    for w, b, last in ((w1, b1, False), (w2, b2, False), (w3, b3, True)):
        h = torch.einsum("pnf,pfh->pnh", h, w) + b[:, None]
        if not last:
            h = torch.relu(h)
    return h[..., 0] * y_sd[:, :1] + y_mu[:, :1]


def mlp_plain(x, w1, b1, w2, b2, w3, b3):
    """``relu(relu(x @ w1 + b1) @ w2 + b2) @ w3 + b3`` in fp32 -> (N,)."""
    h = torch.relu(x.float() @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    return (h @ w3 + b3)[:, 0]


# csrc/mlp_heads.cu mlp_heads_launch: x, the arrays, out, (n, p, f, h1, h2,
# device), the stream; mlp_surrogate_launch: x, whether x is bf16, the
# arrays, out, (n, f, h1, h2, device), the stream
ARGTYPES = {
    "mlp_heads": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "mlp_surrogate": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p] + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}

@functools.cache
def _kernel(name: str = "mlp_heads"):
    lib = _build.library("mlp_heads")
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES[name]
    return lib, fn


@functools.cache
def plan(p: int, f: int, h1: int, h2: int) -> dict:
    """The kernel's launch layout for P heads at (F, H1, H2), from its own
    rule (``csrc/mlp_heads.cu:plan``): heads staged at once (0: one head,
    its matrices in slices), rows per tile at the most, rows of w0 / w1 a
    slice holds, shared-memory bytes of a block. Raises where a 4-row
    tile of activations, the head's vectors and one row of each matrix do
    not fit in shared memory (H1 above ~9,600 at H2 = 50, H1 = H2 above
    ~4,800, F above ~5,200 at MLP(100, 50))."""
    lib = _build.library("mlp_heads")
    fn = lib.mlp_heads_plan
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = (ctypes.c_int * 5)()
    fn(p, f, h1, h2, out)
    res = dict(zip(("group", "rows", "w0_rows", "w1_rows", "smem_bytes"),
                   out))
    if res["rows"] == 0:
        raise ValueError(f"mlp_surrogate_heads kernel: a 4-row tile of "
                         f"F={f}, MLP({h1}, {h2}) heads does not fit in "
                         "shared memory")
    return res


@functools.cache
def single_plan(f: int, h1: int, h2: int) -> dict:
    """The single-head kernel's layout at (F, H1, H2), from its own rule
    (``csrc/mlp_heads.cu:single_takes``): rows per tile at the most (0:
    it does not take the head, which then runs through the heads' kernel
    at P = 1, on fp32 rows) and the shared-memory bytes of a block."""
    lib = _build.library("mlp_heads")
    fn = lib.mlp_surrogate_plan
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 2)()
    fn(f, h1, h2, out)
    return dict(zip(("rows", "smem_bytes"), out))


def _launch(x, x_mu, x_sd, y_mu, y_sd, w1, b1, w2, b2, w3, b3):
    arrays = (x_mu, x_sd, y_mu, y_sd, w1, b1, w2, b2, w3, b3)
    dev = ops.same_cuda_device(x, *arrays)
    n, f = x.shape
    p, _, h1 = w1.shape
    h2 = w2.shape[2]
    ops.check(x, "x", (n, f))
    for name, a, shape in (("x_mu", x_mu, (p, f)), ("x_sd", x_sd, (p, f)),
                           ("y_mu", y_mu, (p, 1)), ("y_sd", y_sd, (p, 1)),
                           ("w1", w1, (p, f, h1)), ("b1", b1, (p, h1)),
                           ("w2", w2, (p, h1, h2)), ("b2", b2, (p, h2)),
                           ("w3", w3, (p, h2, 1)), ("b3", b3, (p, 1))):
        ops.check(a, name, shape)
    out = torch.empty((p, n), dtype=torch.float32, device=dev)
    if n:
        plan(p, f, h1, h2)
        lib, fn = _kernel()
        ptrs = (ctypes.c_void_p * 10)(*(a.data_ptr() for a in arrays))
        code = fn(x.data_ptr(), ptrs, out.data_ptr(), n, p, f, h1, h2,
                  dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on_error(lib, code, "mlp_surrogate_heads")
        ops.count_launch("mlp_surrogate_heads")
    return out


def mlp_surrogate_heads(x, x_mu, x_sd, y_mu, y_sd, w1, b1, w2, b2, w3, b3):
    """x (N, F) + P stacked heads -> (P, N) in target units.

    Stacked shapes: ``x_mu``/``x_sd`` (P, F), ``y_mu``/``y_sd`` (P, 1),
    ``w1`` (P, F, H1), ``b1`` (P, H1), ``w2`` (P, H1, H2), ``b2`` (P, H2),
    ``w3`` (P, H2, 1), ``b3`` (P, 1). Any N; nothing is padded."""
    args = (x, x_mu, x_sd, y_mu, y_sd, w1, b1, w2, b2, w3, b3)
    if ops.dry_route(*args):
        n, f = x.shape
        p, _, h1 = w1.shape
        ops.record_work("mlp_surrogate_heads", heads_work(
            n, f, p, h1, w2.shape[2], sum(a.numel() for a in args[1:])))
        return torch.empty((p, n), dtype=torch.float32, device="meta")
    if all(a.device.type == "cpu" for a in args):
        return mlp_heads_plain(*args)
    return _launch(*args)


def _launch_single(x, w1, b1, w2, b2, w3, b3):
    arrays = (w1, b1, w2, b2, w3, b3)
    dev = ops.same_cuda_device(x, *arrays)
    n, f = x.shape
    h1, h2 = w1.shape[1], w2.shape[1]
    for name, a, shape in (("w1", w1, (f, h1)), ("b1", b1, (h1,)),
                           ("w2", w2, (h1, h2)), ("b2", b2, (h2,)),
                           ("w3", w3, (h2, 1)), ("b3", b3, (1,))):
        ops.check(a, name, shape)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        plan(1, f, h1, h2)
        # the single-head kernel reads fp32 and bf16 rows as they are; the
        # heads' kernel, which takes the heads too wide for it, fp32 rows
        reads = (torch.float32, torch.bfloat16) if single_plan(
            f, h1, h2)["rows"] else (torch.float32,)
        if x.dtype not in reads:
            x = x.float()
        ops.check(x, "x", (n, f), dtype=x.dtype)
        lib, fn = _kernel("mlp_surrogate")
        ptrs = (ctypes.c_void_p * 6)(*(a.data_ptr() for a in arrays))
        code = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), ptrs,
                  out.data_ptr(), n, f, h1, h2, dev.index or 0,
                  torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on_error(lib, code, "mlp_surrogate")
        ops.count_launch("mlp_surrogate")
    return out


def mlp_surrogate(x, w1, b1, w2, b2, w3, b3):
    """One fused 3-layer ReLU MLP: x (N, F) (fp32 and bf16 rows read as
    they are, any other dtype cast to fp32 first),
    w1 (F, H1), b1 (H1,), w2 (H1, H2), b2 (H2,), w3 (H2, 1), b3 (1,) ->
    (N,) fp32."""
    args = (x, w1, b1, w2, b2, w3, b3)
    if ops.dry_route(*args):
        n, f = x.shape
        ops.record_work("mlp_surrogate", single_work(
            n, f, w1.shape[1], w2.shape[1], sum(a.numel() for a in args[1:])))
        return torch.empty((n,), dtype=torch.float32, device="meta")
    if all(a.device.type == "cpu" for a in args):
        return mlp_plain(*args)
    return _launch_single(*args)
