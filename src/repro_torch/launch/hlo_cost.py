"""The dry run's cost model, the JAX package's ``launch/hlo_cost.py``
(``:1-418``) in PyTorch. The name is kept so that a reader finds the
counterpart; there is no HLO here. It counts the traced aten ops of a
step run on meta tensors: :class:`Counter` is a ``TorchDispatchMode`` that
sees every op the step dispatches, its backward and the recomputation of
``torch.utils.checkpoint`` included (XLA's program contains that
recompute too), with the reference's rules (``:225-345``):

  flops   dots and convolutions 2*M*N*K, batch dims included (also kept
          apart as ``dot_flops``); arithmetic elementwise ops, compares
          and selects 1 per output element; a reduction its input
          elements; a few composite kernels (softmax, SiLU, ...) the
          elementwise ops they stand for. Each flop is also kept by the
          peak it runs at (``flops_by_rate``, the keys of
          ``roofline.RATES``): a bf16 or fp16 dot's on the tensor cores
          (``"bf16"``), every other op's on the fp32 cores (``"fp32"``),
          a kernel's at its ``ops.Work.rate``
  transcendentals  counted apart, over the reference's list
  bytes   operands plus output, per op. Eager PyTorch does not fuse, so
          this sits above the reference's post-fusion bytes (one HBM
          round trip per fused kernel); views move nothing
  kernels a hand-written kernel called in ``ops.dry_run`` adds the
          ``ops.Work`` its wrapper reckons from the shapes
  wire    every collective of ``core/collectives.py`` adds, per
          destination device, its ring traffic (``roofline.wire_bytes``)
          and its output bytes; the arithmetic that simulates the
          exchange on one host is not the devices' work and is not
          counted

Each tensor belongs to a mesh entry (a device of the dry run): the
arguments through their ``sharding.Sharded`` / ``Placement`` (or the
entry the caller names), every op's outputs to the entry of its first
owned input (the largest), a collective's outputs to their
destinations. A batch the
caller hands over whole belongs to :data:`HOST`: the model splits it onto
the entries inside the step, and what is derived from it alone stays
with the host (each entry's block of it is an argument of that entry,
which the caller reckons from its placement, as the reference's sharded
inputs are). A tensor made by an op with no owned input (positions, a
mask) floats until an op of some entry uses it; that entry adopts it,
with the cost of making it. Per entry the
counter keeps the costs and the memory: the live set is every entry's
arguments plus its temporaries, an entry's peak is its arguments plus
the most temporaries it held at once, and a temporary is freed through a
weakref on its storage.

Meta tensors hold no data, so an op whose output shape depends on values
takes its bound: ``bincount`` returns ``minlength`` bins (the MoE
router's ids are below it). Where the reference's XLA lowers both
branches of a ``cond`` and ``hlo_cost`` takes the worst, the port's
kernels take the worst case in their dry-run route (every row of a
LASANA tick changed, stale and firing: ``tick_megakernel.work``).

Repeated work is counted once and scaled, as the reference multiplies a
``while`` body by its trip count. A meta op costs the host 0.1-0.5 ms, so
the step is never run at full depth:

  - **Equal signatures.** An op whose signature (op, input shapes,
    strides and dtypes, other arguments) was seen before reuses the meta
    result and the cost of the first: the mesh's equal entries and the
    stack's equal layers run the meta kernel once.
  - **Equal rows.** ``launch/dryrun.py`` lets one data row of the mesh
    compute and stand for the others, which run the same program on
    shards of the same shapes (``Model.rows.live``; the train step
    updates the live rows' entries, ``train/step.py``).
  - **Repeats** (:func:`extrapolate`). A count that repeats identical
    work — microbatches, a stack of layers of one kind, a hybrid's
    pattern period — is run at two small values ``a`` and ``a + 1``
    (``launch/dryrun.py:repeats``) and every quantity is
    extended linearly to the full count: the difference of the two runs
    is one more body, exactly. Several counts extend one after another
    (multilinearly). Saved-for-backward bytes grow by the same amount
    for each layer, so the peak extends with them. The microbatch loop's
    memory does not grow past its second microbatch (the fp32
    accumulator exists from then on and each later microbatch repeats
    the second's live set), so memory takes the value at ``a + 1`` there.

``tests/test_torch_cost.py`` holds each of these to the full, unscaled
run, integer for integer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import collectives
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rf

_COLLECTIVES = rf.KINDS
HOST = "host"      # the owner of inputs handed over whole, and their copies
FLOAT = "float"    # tensors no entry has used yet (made from no owned input)

# ops that move nothing (views, allocation without writes)
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "slice", "select", "unsqueeze", "squeeze", "as_strided", "alias",
    "detach", "unbind", "split", "split_with_sizes", "chunk", "narrow",
    "diagonal", "unfold", "lift_fresh", "_reshape_alias", "view_as_real",
    "view_as_complex", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "empty_permuted", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "_to_copy_meta",
    "set_", "resize_", "record_stream",
}
# dots and convolutions
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv",
         "addmv", "convolution", "convolution_backward"}
# data movement: bytes in and out, no operations
_MOVE = {
    "_to_copy", "copy_", "clone", "contiguous", "cat", "stack",
    "index_select", "gather", "scatter", "scatter_", "index", "index_put",
    "index_put_", "_index_put_impl_", "repeat", "repeat_interleave",
    "flip", "roll", "constant_pad_nd", "_unsafe_index", "embedding",
    "embedding_dense_backward", "select_backward", "slice_backward",
    "_unsafe_index_put", "masked_scatter", "unfold_backward",
    "slice_scatter", "select_scatter", "diagonal_backward", "tril", "triu",
    "as_strided_scatter", "new_zeros", "new_ones", "new_full", "zeros",
    "ones", "full", "zeros_like", "ones_like", "full_like", "fill",
    "fill_", "zero_", "arange", "scalar_tensor", "_foreach_copy_",
}
# reductions: their input elements
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
           "all", "linalg_vector_norm", "norm", "var", "std", "var_mean",
           "cumsum", "cumprod", "argmax", "argmin", "argsort", "sort",
           "topk", "logsumexp", "bincount", "scatter_add", "scatter_add_",
           "index_add", "index_add_", "scatter_reduce", "count_nonzero"}
# composite kernels: (operations, transcendentals) per element of the
# first input, as the elementwise ops they stand for
_COMPOSITE = {
    "_softmax": (5, 1), "_log_softmax": (5, 1),
    "_softmax_backward_data": (4, 0), "_log_softmax_backward_data": (4, 1),
    "silu": (3, 1), "silu_backward": (6, 1), "gelu": (8, 1),
    "gelu_backward": (12, 1), "sigmoid_backward": (3, 0),
    "tanh_backward": (3, 0), "softplus": (4, 2), "softplus_backward": (5, 1),
    "native_layer_norm": (8, 1), "native_layer_norm_backward": (12, 1),
    "threshold_backward": (2, 0), "_log_softmax_backward": (4, 1),
    "logit": (3, 1), "log_sigmoid_forward": (5, 2),
}
# the reference's transcendentals (exponential, log, tanh, logistic, power,
# sine, cosine, rsqrt, sqrt, erf) and their aten names
_TRANSC = {"exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10",
           "log1p", "tanh", "tanh_", "sigmoid", "sigmoid_", "pow", "pow_",
           "sin", "cos", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "erf",
           "reciprocal"}


def _zero_counts() -> dict:
    return {k: 0 for k in _COLLECTIVES}


def _zero_rates() -> dict:
    return {k: 0 for k in rf.RATES}


@dataclasses.dataclass
class CostTotals:
    """The reference's ``CostTotals``, ``dot_flops`` (the flops of the
    dots and convolutions alone) and ``flops_by_rate`` (the flops by the
    peak they run at, summing to ``flops``); ``wire_bytes`` is exact (a
    Fraction)."""
    flops: int = 0
    bytes: int = 0
    wire_bytes: Fraction = Fraction(0)
    transcendentals: int = 0
    collective_counts: dict = dataclasses.field(default_factory=_zero_counts)
    dot_flops: int = 0
    flops_by_rate: dict = dataclasses.field(default_factory=_zero_rates)

    def __add__(self, o):
        return CostTotals(
            self.flops + o.flops, self.bytes + o.bytes,
            self.wire_bytes + o.wire_bytes,
            self.transcendentals + o.transcendentals,
            {k: self.collective_counts[k] + o.collective_counts[k]
             for k in self.collective_counts},
            self.dot_flops + o.dot_flops,
            {k: self.flops_by_rate[k] + o.flops_by_rate[k]
             for k in self.flops_by_rate})

    def scaled(self, k):
        return CostTotals(
            self.flops * k, self.bytes * k, self.wire_bytes * k,
            self.transcendentals * k,
            {c: v * k for c, v in self.collective_counts.items()},
            self.dot_flops * k,
            {r: v * k for r, v in self.flops_by_rate.items()})

    def cost_analysis(self) -> dict:
        """The keys ``roofline.roofline`` reads (XLA's ``cost_analysis()``
        names, and the flops by rate)."""
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "flops by rate": dict(self.flops_by_rate)}

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "wire_bytes": float(self.wire_bytes),
                "transcendentals": self.transcendentals,
                "collective_counts": dict(self.collective_counts),
                "dot_flops": self.dot_flops,
                "flops_by_rate": dict(self.flops_by_rate)}


@dataclasses.dataclass
class EntryStats:
    """One mesh entry's costs and memory over a step."""
    cost: CostTotals
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_peak: int = 0          # the most temporaries held at once
    kernels: dict = dataclasses.field(default_factory=dict)

    @property
    def peak_live_bytes(self) -> int:
        return self.argument_bytes + self.temp_peak

    @property
    def temp_bytes(self) -> int:
        """Scratch beyond the outputs: the reference's ``temp_size``
        (argument + output + temp - alias = peak)."""
        return self.peak_live_bytes - self.argument_bytes \
            - self.output_bytes + self.alias_bytes

    def combine(self, o, w, w_mem):
        """``self`` plus ``w`` times ``o`` (costs) and ``w_mem`` times
        ``o`` (memory)."""
        kern = dict(self.kernels)
        for k, v in o.kernels.items():
            kern[k] = kern.get(k, 0) + w * v
        return EntryStats(
            self.cost + o.cost.scaled(w),
            self.argument_bytes + w_mem * o.argument_bytes,
            self.output_bytes + w_mem * o.output_bytes,
            self.alias_bytes + w_mem * o.alias_bytes,
            self.temp_peak + w_mem * o.temp_peak, kern)


def _numel(t) -> int:
    n = 1
    for d in t.shape:
        n *= d
    return n


def _nbytes(t) -> int:
    return _numel(t) * t.element_size()


def _leaves(x, out):
    if isinstance(x, (list, tuple)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


def _scan(args, ts: list):
    """The tensors of ``args`` (one level of lists deep) appended to
    ``ts``, and the arguments' signature (tensors by shape, strides, dtype
    and whether on meta); None where a list nests deeper."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            ts.append(a)
            out.append((a.shape, a.stride(), a.dtype, a.is_meta))
        elif isinstance(a, (list, tuple)):
            sub = []
            for b in a:
                if isinstance(b, torch.Tensor):
                    ts.append(b)
                    sub.append((b.shape, b.stride(), b.dtype, b.is_meta))
                elif isinstance(b, (list, tuple, dict)):
                    return None
                else:
                    sub.append(b)
            out.append(tuple(sub))
        elif isinstance(a, dict):
            return None
        else:
            out.append(a)
    return tuple(out)


def _dot_flops(name, ts, outs) -> int:
    if name in ("mm", "bmm", "dot", "vdot", "mv"):
        a, b = ts[0], ts[1]
    elif name in ("addmm", "baddbmm", "addbmm", "addmv"):
        a, b = ts[1], ts[2]
    elif name == "convolution":
        w = ts[1]
        k = 1
        for d in w.shape[1:]:
            k *= d
        return 2 * _numel(outs[0]) * k
    else:                                      # convolution_backward
        w = ts[2]
        k = 1
        for d in w.shape[1:]:
            k *= d
        return 4 * _numel(ts[0]) * k
    if name in ("dot", "vdot"):
        return 2 * _numel(a)
    return 2 * _numel(a) * b.shape[-1]         # (.., M, K) @ (.., K, N)


def op_cost(name: str, ts: list, outs: list) -> CostTotals:
    """One aten op's cost by the rules of the module docstring (``ts``
    its tensor inputs, ``outs`` its tensor outputs)."""
    c = CostTotals()
    if name in _FREE:
        return c
    in_b = sum(_nbytes(t) for t in ts)
    out_b = sum(_nbytes(t) for t in outs)
    if name == "copy_":
        c.bytes = in_b
        return c
    c.bytes = in_b + out_b
    if name in _MOVE:
        return c
    out_n = sum(_numel(t) for t in outs)
    if name in _DOTS:
        c.dot_flops = _dot_flops(name, ts, outs)
        c.flops = c.dot_flops + (out_n if name.startswith("add")
                                 or name == "baddbmm" else 0)
        half = outs and outs[0].dtype in (torch.bfloat16, torch.float16)
        c.flops_by_rate["bf16" if half else "fp32"] = c.flops
        return c
    if name in _REDUCE:
        c.flops = _numel(ts[0]) if ts else out_n
    elif name in _COMPOSITE:
        f, tr = _COMPOSITE[name]
        n = _numel(ts[0]) if ts else out_n
        c.flops, c.transcendentals = f * n, tr * n
    else:
        c.flops = out_n if outs else _numel(ts[0]) if ts else 0
        if name in _TRANSC:
            c.transcendentals = c.flops
    c.flops_by_rate["fp32"] = c.flops
    return c


def _bincount(args, kwargs):
    """``bincount`` on meta: ``minlength`` bins (its bound; the data that
    would lengthen it is not there)."""
    x = args[0]
    weights = kwargs.get("weights", args[1] if len(args) > 1 else None)
    minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.empty((minlength,), dtype=dtype, device=x.device)


_DATA_DEPENDENT = {"bincount": _bincount}


class Counter(TorchDispatchMode):
    """Counts every aten op dispatched inside it, per mesh entry. Use it
    through :func:`counting`, which also routes the kernels' dry-run work
    and the collectives to it. ``memo`` reuses the meta result and cost
    of an op signature seen before."""

    def __init__(self, *, memo: bool = True):
        super().__init__()
        self.costs: dict = {}
        self.kernels: dict = {}
        self.args: dict = {}
        self.live: dict = {}
        self.peak: dict = {}
        # id(storage) -> [entry, nbytes, is_arg, weakref, debt]
        self._owner: dict = {}
        self.current = 0
        self._pinned = None
        self.devices: set = {"meta"}  # the device types of every output
        self._funcs: dict = {}
        self._quiet = 0
        self._memo = {} if memo else None

    # --- ownership --------------------------------------------------------

    def _freed(self, key, _ref):
        info = self._owner.pop(key, None)
        if info is not None and not info[2]:
            self.live[info[0]] -= info[1]

    def own(self, t: torch.Tensor, entry, arg: bool = False) -> None:
        """Make ``t``'s storage belong to ``entry`` (as an argument with
        ``arg``); a storage already owned moves to ``entry``."""
        st = t.untyped_storage()
        key = id(st)
        info = self._owner.get(key)
        if info is not None:
            if info[0] == entry or info[2] or entry == FLOAT:
                return
            if info[0] == FLOAT:
                self._adopt(info, entry)
                return
            self.live[info[0]] -= info[1]
            info[0] = entry
            self._add_live(entry, info[1])
            return
        nbytes = st.nbytes()
        ref = weakref.ref(st, functools.partial(self._freed, key))
        self._owner[key] = [entry, nbytes, arg, ref, None]
        if arg:
            self.args[entry] = self.args.get(entry, 0) + nbytes
        else:
            self._add_live(entry, nbytes)

    def _add_live(self, entry, nbytes):
        v = self.live.get(entry, 0) + nbytes
        self.live[entry] = v
        if v > self.peak.get(entry, 0):
            self.peak[entry] = v

    def entry_of(self, t: torch.Tensor):
        info = self._owner.get(id(t.untyped_storage()))
        return None if info is None else info[0]

    def arguments(self, pairs) -> None:
        """Own each ``(tensor, entry)`` pair as an argument."""
        for t, e in pairs:
            self.own(t, e, arg=True)

    def _entry(self, ts):
        """(the entry an op's cost goes to, the owner of its outputs): the
        owner of its largest owned input, by the input's own bytes (a
        scalar broadcast to every entry, an optimizer's learning rate,
        decides nothing; nor does a slice of a large table that one entry
        holds for all, a decoder's position table on meta). Floating
        inputs (made by ops that had no owned input: positions, masks)
        are adopted by it, and the cost of making them is charged to it.
        An op with only floating inputs, or none, makes floating outputs
        and passes the cost on (None: the cost rides on the outputs), as
        does an op on the host's inputs alone (its outputs stay with the
        host; the first entry to use them pays for them)."""
        owner, host, floats, size = None, [], [], -1
        for t in ts:
            info = self._owner.get(id(t.untyped_storage()))
            if info is None:
                continue
            if info[0] == HOST:
                host.append(info)
            elif info[0] == FLOAT:
                floats.append(info)
            elif (nb := _nbytes(t)) > size:
                owner, size = info[0], nb
        if owner is None and self._pinned is not None:
            owner = self._pinned
        if owner is not None:
            self.current = owner
            for info in floats:
                self._adopt(info, owner)
            for info in host:                # the host's work for it
                if info[4] is not None:
                    if not self._quiet:
                        self._add(owner, info[4])
                    info[4] = None
            return owner, owner
        return None, HOST if host and not floats else FLOAT

    def _adopt(self, info, entry) -> None:
        """A floating storage joins ``entry``, with the cost of making
        it."""
        if info[0] != FLOAT:
            return
        self.live[FLOAT] = self.live.get(FLOAT, 0) - info[1]
        info[0] = entry
        self._add_live(entry, info[1])
        if info[4] is not None:
            if not self._quiet:
                self._add(entry, info[4])
            info[4] = None

    @contextlib.contextmanager
    def at(self, entry):
        """Ops with no owned input inside belong to ``entry``."""
        prev, self._pinned = self._pinned, entry
        try:
            yield
        finally:
            self._pinned = prev

    def _add(self, entry, cost: CostTotals):
        """An op's or a kernel's cost to ``entry`` (no collectives: those
        go through :meth:`end`)."""
        acc = self.costs.get(entry)
        if acc is None:
            acc = self.costs[entry] = CostTotals()
        acc.flops += cost.flops
        acc.bytes += cost.bytes
        acc.transcendentals += cost.transcendentals
        acc.dot_flops += cost.dot_flops
        for r, v in cost.flops_by_rate.items():
            acc.flops_by_rate[r] += v

    # --- the dispatch -----------------------------------------------------

    def _info(self, func):
        """(name, whether its result may come from the signature cache),
        once per op."""
        info = self._funcs.get(func)
        if info is None:
            name = func.overloadpacket.__name__
            info = self._funcs[func] = (name, not func.is_view
                                        and name not in _FREE
                                        and not func._schema.is_mutable
                                        and name not in _DATA_DEPENDENT)
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, memoable = self._info(func)
        ts: list = []
        sig = _scan(args, ts)
        ksig = (tuple(kwargs), _scan(tuple(kwargs.values()), ts)) \
            if kwargs else ()
        if sig is None or (kwargs and ksig[1] is None):
            sig = ksig = None
            ts = [a for a in _leaves(kwargs, _leaves(args, []))
                  if isinstance(a, torch.Tensor)]
        entry, holder = self._entry(ts)
        cached = None
        key = None
        if self._memo is not None and memoable and sig is not None \
                and ksig is not None:
            key = (func, sig, ksig)
            try:
                cached = self._memo.get(key)
            except TypeError:                     # an unhashable argument
                key = None
        if cached is not None:
            specs, kind, cost = cached
            outs = [torch.empty_strided(sh, st, dtype=d, device="meta")
                    for sh, st, d in specs]
            out = outs[0] if kind is None else kind(outs)
        else:
            if name in _DATA_DEPENDENT and any(
                    t.device.type == "meta" for t in ts):
                out = _DATA_DEPENDENT[name](args, kwargs)
            else:
                out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                outs, kind = [out], None
            elif isinstance(out, (tuple, list)) and all(
                    isinstance(o, torch.Tensor) for o in out):
                outs, kind = list(out), type(out)
            else:
                outs = [o for o in _leaves(out, [])
                        if isinstance(o, torch.Tensor)]
                kind = key = None
            cost = op_cost(name, ts, outs)
            if key is not None and outs and all(o.is_meta for o in outs):
                self._memo[key] = ([(o.shape, o.stride(), o.dtype)
                                    for o in outs], kind, cost)
            for o in outs:
                if not o.is_meta:
                    self.devices.add(o.device.type)
        if entry is None:
            debt = cost
            for t in ts:
                info = self._owner.get(id(t.untyped_storage()))
                if info is not None and info[0] in (FLOAT, HOST) \
                        and info[4]:
                    debt = debt + info[4]
                    info[4] = None
            for o in outs:
                self.own(o, holder)
            info = self._owner.get(id(outs[0].untyped_storage())) \
                if outs else None
            if info is not None and info[0] in (FLOAT, HOST):
                info[4] = debt if info[4] is None else info[4] + debt
            return out
        if not self._quiet:
            self._add(entry, cost)
        for o in outs:
            self.own(o, holder)
        return out

    # --- kernels and collectives ----------------------------------------

    def kernel(self, name: str, work: ops.Work) -> None:
        """An ``ops.dry_run`` sink: one kernel call's work, on the current
        entry."""
        cost = CostTotals(flops=work.flops, bytes=work.bytes)
        cost.flops_by_rate[work.rate] = work.flops
        self._add(self.current, cost)
        k = self.kernels.setdefault(self.current, {})
        k[name] = k.get(name, 0) + 1

    def begin(self) -> None:
        self._quiet += 1

    def end(self, kind: str, n: int, parts, outs, owners=None) -> None:
        """One collective over ``n`` participants has delivered ``outs``:
        output ``i`` belongs to ``owners[i]`` (by default the owner of
        ``parts[i]``, or of ``parts[0]``). It counts once at each
        destination; one that fans fewer parts out to more destinations
        (a single entry's share handed back to its peers, the adjoint of
        a gather onto one entry) counts once at each source."""
        self._quiet -= 1
        if self._quiet:
            return
        src = [self.entry_of(p) for p in parts]
        first = next((e for e in src if e is not None and e != HOST),
                     self.current)
        if owners is None:
            owners = src
        dest = [owners[i] if i < len(owners) and owners[i] is not None
                and owners[i] != HOST else first for i in range(len(outs))]
        for o, e in zip(outs, dest):
            self.own(o, e)
        if not outs:
            return
        at = dest if len(outs) <= len(parts) else sorted(
            {e if e is not None and e != HOST else first for e in src},
            key=str)
        for i, e in enumerate(at):
            out_b = _nbytes(outs[min(i, len(outs) - 1)])
            self._add(e, CostTotals(bytes=out_b))
            acc = self.costs[e]
            acc.wire_bytes += rf.wire_bytes(kind, out_b, n)
            acc.collective_counts[kind] += 1

    # --- results ------------------------------------------------------------

    def stats(self, outputs=()) -> dict:
        """``{entry: EntryStats}``; ``outputs`` the ``(tensor, entry)``
        pairs of the step's results (their storages are its outputs,
        aliased where they are arguments)."""
        out_b: dict = {}
        alias: dict = {}
        seen = set()
        for t, e in outputs:
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            info = self._owner.get(id(st))
            nb = st.nbytes()
            out_b[e] = out_b.get(e, 0) + nb
            if info is not None and info[2]:
                alias[e] = alias.get(e, 0) + nb
        entries = (set(self.costs) | set(self.args) | set(self.peak)) \
            - {HOST, FLOAT}
        return {e: EntryStats(self.costs.get(e, CostTotals()),
                              self.args.get(e, 0), out_b.get(e, 0),
                              alias.get(e, 0), self.peak.get(e, 0),
                              dict(self.kernels.get(e, {})))
                for e in entries}


@contextlib.contextmanager
def counting(counter: Counter | None = None):
    """``counter`` (a new one by default) counting every op, kernel call
    and collective inside."""
    counter = counter or Counter()
    with ops.dry_run(counter.kernel), collectives.counting(counter), counter:
        yield counter


def per_device(stats: dict) -> EntryStats:
    """The busiest device's figures: each field the maximum over the
    entries (every entry of an SPMD step does the same work; where the
    port's step gives one entry more, that entry bounds the step)."""
    vals = list(stats.values())
    c = CostTotals(
        max(v.cost.flops for v in vals), max(v.cost.bytes for v in vals),
        max(v.cost.wire_bytes for v in vals),
        max(v.cost.transcendentals for v in vals),
        {k: max(v.cost.collective_counts[k] for v in vals)
         for k in _COLLECTIVES},
        max(v.cost.dot_flops for v in vals),
        {r: max(v.cost.flops_by_rate[r] for v in vals) for r in rf.RATES})
    kern: dict = {}
    for v in vals:
        for k, n in v.kernels.items():
            kern[k] = max(kern.get(k, 0), n)
    best = max(vals, key=lambda v: v.peak_live_bytes)
    return EntryStats(c, max(v.argument_bytes for v in vals),
                      best.output_bytes, best.alias_bytes, best.temp_peak,
                      kern)


def extrapolate(runs: dict, dims: list) -> EntryStats:
    """The busiest device's stats at the full counts from runs at small
    ones.

    ``dims`` lists each repeated count as ``(full, a, memory_saturates)``;
    ``runs`` maps a tuple of counts (``a`` or ``a + 1`` per dim, or the
    full count where ``a`` is None) to ``{entry: EntryStats}``. Every
    figure is extended linearly from ``a`` and ``a + 1`` — weights ``a + 1
    - full`` and ``full - a`` — one dim after another: each entry's costs
    before the busiest is taken, and the memory of each run's busiest
    entry (an entry's peak may fall in another phase of the step at
    another depth; the device's does not); memory takes the ``a + 1``
    value where ``memory_saturates``."""
    corners = [()]
    for full, a, sat in dims:
        nxt = []
        for c in corners:
            if a is None:
                nxt.append(c + ((full, 1, 1),))
            else:
                nxt.append(c + ((a, a + 1 - full, 0 if sat else a + 1 - full),))
                nxt.append(c + ((a + 1, full - a, 1 if sat else full - a),))
        corners = nxt
    entries: dict = {}
    memory = EntryStats(CostTotals())
    for c in corners:
        w = w_mem = 1
        for _, wc, wm in c:
            w *= wc
            w_mem *= wm
        run = runs[tuple(x[0] for x in c)]
        for e, st in run.items():
            entries[e] = (entries.get(e) or EntryStats(CostTotals())).combine(
                st, w, 0)
        memory = memory.combine(per_device(run), 0, w_mem)
    costs = per_device(entries)
    return dataclasses.replace(memory, cost=costs.cost, kernels=costs.kernels)
