"""GBDT inference: (N, F) rows through T complete trees -> (N,).

A GBDT head (``surrogate.py``'s ``gbdt`` family) holds, per tree, the
feature index and threshold of each of its 2^D - 1 inner nodes in level
order and its 2^D leaves; a row goes right where its feature exceeds the
threshold, and the head's output is ``base`` plus the leaves the row
reaches. The JAX package has no Pallas kernel for it (it walks in plain
``jnp``), so :func:`gbdt_plain`, the port's eager walk, is the plain
version; on CUDA tensors :func:`gbdt_walk` launches ``csrc/gbdt_walk.cu``:
one launch a head call, the forest staged in shared memory once a block,
each (row, tree) walked in registers, the leaves summed in tree order in
fp64. Every (row, tree) reaches the plain version's leaf; the sum rounds
once instead of at each of the plain version's fp32 additions.

:func:`forest` converts a head's tables to what the kernel takes, once a
head (``Surrogate`` caches it), and checks there that every feature index
lies inside the row. :func:`work` reckons a call's operations and bytes;
in ``ops.dry_run`` the entry point takes meta tensors and records it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ops


def gbdt_plain(x, feat, thr, leaf, base):
    """The eager walk: every tree a level at a time over (N, T) int64
    node indices, the leaves summed in fp32."""
    feat = feat.long()
    max_depth = int(np.log2(feat.shape[1] + 1))        # nodes = 2^d - 1
    n_t = feat.shape[0]
    tree_ix = torch.arange(n_t, device=x.device)[None, :]
    node = torch.zeros((x.shape[0], n_t), dtype=torch.long, device=x.device)
    for _ in range(max_depth):
        nf = feat[tree_ix, node]
        th = thr[tree_ix, node]
        xv = torch.gather(x, 1, nf)
        node = 2 * node + 1 + (xv > th).long()
    leaf_idx = node - (2 ** max_depth - 1)
    return base + leaf[tree_ix, leaf_idx].sum(-1)


def depth_of(feat) -> int:
    """The trees' depth D from their (T, 2^D - 1) inner nodes."""
    nodes = feat.shape[1]
    depth = int(np.log2(nodes + 1))
    if (1 << depth) - 1 != nodes:
        raise ValueError(f"gbdt_walk: {nodes} nodes a tree is not a "
                         "complete tree's 2^D - 1")
    return depth


def work(n: int, f: int, trees: int, depth: int) -> ops.Work:
    """One call over (n, f) rows: ``trees * (depth + 1)`` operations a row
    (a comparison a level, an addition a tree); the rows read and the
    output written once, and the tables (int32 feature indices, fp32
    thresholds and leaves, base) read once."""
    nodes = (1 << depth) - 1
    tables = trees * nodes * 8 + trees * (nodes + 1) * 4 + 4
    return ops.Work(n * trees * (depth + 1), (n * f + n) * 4 + tables)


def forest(feat, thr, leaf, base, f: int) -> tuple:
    """A head's tables as the kernel takes them, on their own device:
    ``(feat int32 (T, 2^D - 1), thr (T, 2^D - 1), leaf (T, 2^D), base
    ())``, contiguous fp32 beside the indices. Refuses a feature index
    outside [0, f) (the one host read of the head; meta tables hold no
    values to check), so that the kernel never reads outside a row."""
    depth_of(feat)
    if feat.device.type != "meta" and feat.numel():
        lo, hi = (int(v) for v in torch.aminmax(feat))
        if lo < 0 or hi >= f:
            raise ValueError(f"gbdt_walk: feature indices in [{lo}, {hi}] "
                             f"outside rows of {f} features")
    return (feat.to(torch.int32).contiguous(),
            thr.to(torch.float32).contiguous(),
            leaf.to(torch.float32).contiguous(),
            base.to(torch.float32).reshape(()).contiguous())


# csrc/gbdt_walk.cu gbdt_walk_launch: x, feat, thr, leaf, base, out, (n, f,
# trees, depth, device), the stream
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.cache
def _kernel():
    lib = _build.library("gbdt_walk")
    fn = lib.gbdt_walk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return lib, fn


def shared(f: int, trees: int, depth: int) -> bool:
    """Whether the kernel stages these tables in shared memory (else it
    reads them from global memory), by its own rule
    (``csrc/gbdt_walk.cu:tables_fit``)."""
    fn = _build.library("gbdt_walk").gbdt_walk_shared
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return bool(fn(f, trees, depth))


def _launch(x, feat, thr, leaf, base):
    dev = ops.same_cuda_device(x, feat, thr, leaf, base)
    n, f = x.shape
    trees, nodes = feat.shape
    depth = depth_of(feat)
    ops.check(x, "x", (n, f))
    ops.check(feat, "feat", (trees, nodes), dtype=torch.int32)
    ops.check(thr, "thr", (trees, nodes))
    ops.check(leaf, "leaf", (trees, nodes + 1))
    ops.check(base, "base", ())
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        lib, fn = _kernel()
        code = fn(x.data_ptr(), feat.data_ptr(), thr.data_ptr(),
                  leaf.data_ptr(), base.data_ptr(), out.data_ptr(), n, f,
                  trees, depth, dev.index or 0,
                  torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on_error(lib, code, "gbdt_walk")
        ops.count_launch("gbdt_walk")
    return out


def gbdt_walk(x, feat, thr, leaf, base):
    """x (N, F) fp32 -> (N,) fp32: ``base`` plus the leaf each of the T
    trees sends the row to. ``feat`` (T, 2^D - 1) feature indices,
    ``thr`` (T, 2^D - 1), ``leaf`` (T, 2^D), ``base`` (); on the card the
    tables of :func:`forest` (int32 indices it has checked)."""
    args = (x, feat, thr, leaf, base)
    if ops.dry_route(*args):
        n, f = x.shape
        ops.record_work("gbdt_walk", work(n, f, feat.shape[0],
                                          depth_of(feat)))
        return torch.empty((n,), dtype=torch.float32, device="meta")
    if all(a.device.type == "cpu" for a in args):
        return gbdt_plain(*args)
    return _launch(*args)
