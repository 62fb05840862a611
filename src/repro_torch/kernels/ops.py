"""Kernel entry points of the port, its one reader of the environment, and
the per-kernel launch counters.

Each entry point takes tensors and decides by their device alone: on a CPU
tensor it runs the kernel's plain PyTorch version (the transcription of
the JAX reference's math that the tests hold against ``repro``); on a
CUDA tensor it launches the hand-written Hopper kernel, built from
``csrc/`` at first use, or raises. There is no fallback from one to the
other.

``LAUNCHES`` counts kernel launches, one counter per kernel (the two
routes of ``flash_attention`` apart), and nothing else: a caller resets
it (:func:`reset_launches`), drives a path, and reads it to show that the
path went through the kernels.

The program auditor (``repro_torch.analysis.jaxpr_audit``) hooks in here
too: inside :func:`dispatch_scope` the surrogate entry points report
their dispatches (:func:`record_dispatch`) and every kernel entry point
below records ``kernel:<name>`` on every route, so that a CPU run counts
the calls the card would launch (routes come from shapes alone). Outside
a scope the hooks are one attribute check.

The dry run (``launch/dryrun.py``) takes a third route. Inside
:func:`dry_run`, an entry point given meta tensors returns meta outputs
of the kernel's shapes and dtypes, records the kernel's :class:`Work`
(reckoned from the shapes by the ``work`` function beside its wrapper)
with the context's sink, and launches nothing: no counter moves, and the
plain version never runs on meta tensors (plain attention would build the
(S, S) logits the kernel never holds). Outside the context meta tensors
are refused as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os

import torch

LAUNCHES = {"crossbar_target": 0, "flash_attention": 0,
            "flash_attention_simt": 0, "gbdt_walk": 0, "lif_chunk": 0,
            "lif_step": 0, "mlp_surrogate": 0, "mlp_surrogate_heads": 0,
            "network_tick": 0, "network_tick_chunk": 0}


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do: ``flops`` operations at the peak of
    their ``rate`` (``"bf16"``, ``"fp32"`` or ``"fp32_unfused"``, the keys
    of ``launch.roofline.RATES``) and ``bytes`` moved — each input read
    once, each output written once."""
    flops: int
    bytes: int
    rate: str = "fp32"


_DRY_SINKS: list = []


@contextlib.contextmanager
def dry_run(sink=None):
    """Inside, kernel entry points take meta tensors: each returns meta
    outputs and calls ``sink(name, work)`` (when given) instead of
    launching."""
    _DRY_SINKS.append(sink)
    try:
        yield
    finally:
        _DRY_SINKS.pop()


def dry_route(*tensors) -> bool:
    """Whether an entry point takes the dry-run route: inside
    :func:`dry_run` with any argument on the meta device."""
    return bool(_DRY_SINKS) and any(
        isinstance(t, torch.Tensor) and t.device.type == "meta"
        for t in tensors)


def record_work(name: str, work: Work) -> None:
    """Hand one dry-run kernel call's work to the innermost sink."""
    sink = _DRY_SINKS[-1]
    if sink is not None:
        sink(name, work)


def fused_kernel_enabled(override: bool | None = None) -> bool:
    """THE single source of truth for the ``REPRO_FUSED_KERNEL`` knob.

    Resolution order: the explicit ``fused_kernel=`` keyword, then the
    environment (``"1"`` on, ``"0"`` off), then ON — unlike the reference,
    the port takes the kernel path unless the caller asks otherwise."""
    if override is not None:
        return bool(override)
    env = os.environ.get("REPRO_FUSED_KERNEL")
    if env is not None:
        return env == "1"
    return True


def engine_cache_capacity(default: int = 8) -> int:
    """Per-spec engine-LRU capacity (``REPRO_ENGINE_CACHE``), read at each
    call: the environment variable when set and non-empty, else
    ``default``, the caller's compiled-in capacity
    (``lasana.ENGINE_CACHE_CAPACITY``)."""
    env = os.environ.get("REPRO_ENGINE_CACHE")
    return int(env) if env else int(default)


def moe_capacity_factor(default: float) -> float:
    """Expert capacity-factor override (``REPRO_MOE_CF``), read at each
    call; ``default`` is the model config's compiled-in factor."""
    return float(os.environ.get("REPRO_MOE_CF", default))


def microbatches_override():
    """``REPRO_MICROBATCHES`` as an int, or None when unset or empty: the
    training launcher's default ``--microbatches``."""
    env = os.environ.get("REPRO_MICROBATCHES")
    return int(env) if env else None


def fault_plan_path():
    """``REPRO_FAULT_PLAN``: the path of a JSON fault-injection plan, or
    None (unset or empty: injection sites do nothing). The resilience
    layer (``repro_torch.resilience.faults``) resolves its ambient plan
    through this function, so the environment is read only here."""
    return os.environ.get("REPRO_FAULT_PLAN") or None


@contextlib.contextmanager
def env_override(values: dict):
    """Set the environment variables ``values`` for the block, then put
    each back as it was (unset where it was unset): the program auditor's
    pinned knobs, and a caller that runs one configuration under a knob
    of its own. Knobs are still read only by the functions above."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def child_env(src) -> dict:
    """The environment of a child Python process that must import the
    package under ``src``: this process's, with ``src`` first on
    ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(src)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


# --- the program auditor's hooks (see the module docstring) -------------------

_DISPATCH_SCOPE = None
_KERNEL_DEPTH = 0


def record_dispatch(name: str) -> None:
    """Report one surrogate dispatch (a no-op outside an audit)."""
    if _DISPATCH_SCOPE is not None:
        _DISPATCH_SCOPE.append(name)


@contextlib.contextmanager
def dispatch_scope():
    """Collect the ``record_dispatch`` names and ``kernel:<name>`` calls
    made under it. Yields the live list; scopes nest by save and restore,
    so an audit inside an audit never counts twice."""
    global _DISPATCH_SCOPE
    prev, log = _DISPATCH_SCOPE, []
    _DISPATCH_SCOPE = log
    try:
        yield log
    finally:
        _DISPATCH_SCOPE = prev


def in_kernel() -> bool:
    """Whether an audited call is inside a kernel entry point (the
    auditor counts a plain version's ops as the kernel's, not the
    host's)."""
    return _KERNEL_DEPTH > 0


def _kernel_entry(fn):
    """Mark ``fn`` a kernel entry point: inside a :func:`dispatch_scope`
    each call records ``kernel:<fn name>`` and runs with
    :func:`in_kernel` true."""
    name = "kernel:" + fn.__name__

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        global _KERNEL_DEPTH
        if _DISPATCH_SCOPE is None:
            return fn(*args, **kwargs)
        _DISPATCH_SCOPE.append(name)
        _KERNEL_DEPTH += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _KERNEL_DEPTH -= 1
    return entry


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (explicitly or by default)
    and there is no card — a CPU run must say ``device="cpu"``.

    On CUDA, float32 matrix products and convolutions run in full fp32
    (TF32 off), because the reference is fp32 throughout, and bf16
    products reduce in fp32 as XLA's do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` for a Python constant ``c``, as a true fp32 division.

    PyTorch's CUDA backend turns division by a Python scalar into a
    multiplication by its reciprocal (one rounding more); dividing by a
    0-d tensor on ``a``'s own device keeps the division the reference and
    the kernels perform, on the CPU and the card alike."""
    return a / a.new_full((), c)


def check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32):
    """Validate a kernel argument: dtype, shape (-1 = any), contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if t.dim() != len(shape) or any(
            s != -1 and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")


def same_cuda_device(*tensors) -> torch.device:
    """The one CUDA device all ``tensors`` lie on, else raise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("kernel arguments must all lie on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    return dev


@_kernel_entry
def lif_step(state, x, params, *, circ=None):
    """One golden LIF clock period: ``(new_state (N, 3), obs)``."""
    from repro_torch.kernels import lif_scan
    return lif_scan.lif_step(state, x, params, circ=circ)


@_kernel_entry
def lif_chunk(state, x_seq, params, *, circ=None, record_v=False):
    """T golden LIF clock periods in one launch: ``(new_state (N, 3),
    obs)`` with (T, N) observables (and ``v_seq``, each tick's V_mem, with
    ``record_v``)."""
    from repro_torch.kernels import lif_scan
    return lif_scan.lif_chunk(state, x_seq, params, circ=circ,
                              record_v=record_v)


@_kernel_entry
def crossbar_target(v, w, *, circ=None):
    """Crossbar rows' DC target and pole: ``(v_tgt (N,), tau (N,))``."""
    from repro_torch.kernels import crossbar_mvm
    return crossbar_mvm.crossbar_target(v, w, circ=circ)


@_kernel_entry
def crossbar_step(state, x, params, *, circ=None):
    """One golden crossbar-row clock period: ``(new_state (N, 1), obs)``."""
    from repro_torch.kernels import crossbar_mvm
    return crossbar_mvm.crossbar_step(state, x, params, circ=circ)


@_kernel_entry
def mlp_surrogate(x, w1, b1, w2, b2, w3, b3):
    """(N, F) -> (N,): one fused 3-layer ReLU MLP in fp32."""
    from repro_torch.kernels import mlp_surrogate
    return mlp_surrogate.mlp_surrogate(x, w1, b1, w2, b2, w3, b3)


@_kernel_entry
def mlp_surrogate_heads(x, x_mu, x_sd, y_mu, y_sd, w1, b1, w2, b2, w3, b3):
    """(N, F) + P stacked 3-layer MLP heads -> (P, N) physical units."""
    from repro_torch.kernels import mlp_surrogate
    return mlp_surrogate.mlp_surrogate_heads(
        x, x_mu, x_sd, y_mu, y_sd, w1, b1, w2, b2, w3, b3)


@_kernel_entry
def gbdt_walk(x, feat, thr, leaf, base):
    """(N, F) rows through a GBDT head's T complete trees -> (N,):
    ``base`` plus the leaf each tree sends the row to."""
    from repro_torch.kernels import gbdt_walk
    return gbdt_walk.gbdt_walk(x, feat, thr, leaf, base)


@_kernel_entry
def network_tick(*args, **kwargs):
    """One whole LASANA tick (idle -> act -> transition) as ONE kernel."""
    from repro_torch.kernels import tick_megakernel
    return tick_megakernel.network_tick(*args, **kwargs)


@_kernel_entry
def network_tick_chunk(*args, **kwargs):
    """A whole chunk of LASANA ticks as ONE time-looped kernel launch."""
    from repro_torch.kernels import tick_megakernel
    return tick_megakernel.network_tick_chunk(*args, **kwargs)


@_kernel_entry
def flash_attention(q, k, v):
    """Causal attention: q (B, H, S, D), k and v (B, KVH, S, D) with KVH
    dividing H -> (B, H, S, D). Head h attends to KV head h // (H / KVH)."""
    from repro_torch.kernels import flash_attn
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if h % kvh:
        raise ValueError(f"flash_attention: {h} heads over {kvh} KV heads")
    out = flash_attn.flash_attention(
        q.reshape(b * h, s, d), k.reshape(b * kvh, s, d),
        v.reshape(b * kvh, s, d), groups=h // kvh)
    return out.reshape(b, h, s, d)
