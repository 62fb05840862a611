"""``repro_torch.lasana`` — the port's LASANA entry point.

The counterpart of ``repro.lasana`` for simulation::

    import repro_torch.lasana as lasana

    sur = lasana.load("artifacts/lif.npz")                   # on cuda
    run = lasana.simulate(spec, stimulus, surrogates=sur)    # NetworkRun

    # crossbar MLP: one combinational wave of DAC volts, ADC codes out
    xspec = network.crossbar_mlp_spec(ternary_weights)
    run = lasana.simulate(xspec, imgs * 1.6 - 0.8, surrogates=xbar_sur)

    # mixed graph: crossbar front end -> LIF bank with lateral inhibition
    mspec = network.graph_spec(
        [network.crossbar_layer(w1), network.lif_layer(w2, knobs)],
        edges=[network.recurrent_edge(1, 1, inhibit)])
    run = lasana.simulate(mspec, volts_seq, surrogates=lasana.SurrogateLibrary(
        {"crossbar": xbar_sur, "lif": lif_sur}))

Long horizons stream: :func:`simulate_stream` cuts the T axis into chunks
(the same record, bit for bit, in memory bounded by the chunk),
:func:`stream` yields per-chunk records for live consumers, and
:func:`resume` continues a stream from a :class:`StreamCheckpoint`::

    run = lasana.simulate_stream(spec, blocks, chunk_ticks=512,
                                 surrogates=sur)       # blocks: iterator
    for chunk in lasana.stream(spec, x, chunk_ticks=512, surrogates=sur,
                               checkpoint_every=2):
        if chunk.checkpoint is not None:
            chunk.checkpoint.save("ckpt.npz")
    run = lasana.resume("ckpt.npz", spec, x, surrogates=sur)

Surrogates load from the reference's ``.npz`` artifacts, and checkpoints
cross between the two packages; training, exploration, serving and
multi-device batches come with later slices of the port. Everything runs
on ``cuda`` unless ``device=`` says otherwise.

``simulate`` keeps one :class:`NetworkEngine` per live spec and
configuration (an LRU attached to the spec), so repeated calls with
retrained surrogates of equal structure reuse one runner
(``engine(spec).compile_count`` stays 1).
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Optional

from repro_torch.core.network import (NetworkEngine, NetworkRun, NetworkSpec,
                                      StreamingRun)
from repro_torch.core.surrogate import (FORMAT_VERSION, Manifest, Surrogate,
                                        SurrogateLibrary)
from repro_torch.kernels import ops
from repro_torch.resilience.checkpoint import StreamCheckpoint

__all__ = [
    "FORMAT_VERSION",
    "Manifest",
    "NetworkRun",
    "StreamCheckpoint",
    "StreamingRun",
    "Surrogate",
    "SurrogateLibrary",
    "engine",
    "load",
    "resume",
    "save",
    "simulate",
    "simulate_stream",
    "stream",
]

_ENGINE_ATTR = "_lasana_engine_cache"
_ENGINE_LOCK = threading.Lock()

# engine-variant entries kept per live spec
ENGINE_CACHE_CAPACITY = 8


def save(surrogate, path: str) -> None:
    """Persist a :class:`Surrogate` (one ``.npz``) or a
    :class:`SurrogateLibrary` (a directory of ``{kind}.npz``)."""
    surrogate.save(path)


def load(path: str, device=None):
    """Load the artifact at ``path``: a file as a :class:`Surrogate`, a
    directory as a :class:`SurrogateLibrary`, onto ``device``."""
    if os.path.isdir(path):
        return SurrogateLibrary.load(path, device=device)
    return Surrogate.load(path, device=device)


def engine(spec: NetworkSpec, *, backend: str = "lasana",
           mode: str = "standalone", record_hidden: bool = True,
           fused: bool = True, fused_kernel: Optional[bool] = None,
           device=None) -> NetworkEngine:
    """The cached :class:`NetworkEngine` serving ``spec`` for
    :func:`simulate`: one per live ``(spec, backend, mode, record_hidden,
    fused, fused_kernel, device)``, in a bounded LRU attached to the spec."""
    device = ops.resolve_device(device)
    fused_kernel = None if fused_kernel is None else bool(fused_kernel)
    key = (backend, mode, record_hidden, bool(fused), fused_kernel, device)
    with _ENGINE_LOCK:
        cache = getattr(spec, _ENGINE_ATTR, None)
        if cache is None:
            cache = collections.OrderedDict()
            # NetworkSpec is frozen; the cache slot is lifecycle
            # bookkeeping, not spec state
            object.__setattr__(spec, _ENGINE_ATTR, cache)
        eng = cache.get(key)
        if eng is None:
            eng = NetworkEngine(spec, backend=backend, mode=mode,
                                record_hidden=record_hidden, fused=fused,
                                fused_kernel=fused_kernel, device=device)
            cache[key] = eng
        else:
            cache.move_to_end(key)
        while len(cache) > max(int(ENGINE_CACHE_CAPACITY), 1):
            cache.popitem(last=False)
    return eng


def simulate(spec: NetworkSpec, stimulus, *, backend: str = "lasana",
             surrogates=None, mode: str = "standalone",
             record_hidden: bool = True, fused: bool = True,
             fused_kernel: Optional[bool] = None,
             device=None) -> NetworkRun:
    """Simulate a circuit graph and return its :class:`NetworkRun`.

    spec        the graph (``network.snn_spec``, ``crossbar_mlp_spec`` or
                ``graph_spec``)
    stimulus    (T, B, fan_in) in the first layer's units — spike
                amplitudes (lif) or DAC volts in [-0.8, 0.8] (crossbar);
                (B, fan_in) is one tick
    backend     "golden" | "behavioral" | "lasana"
    surrogates  backend="lasana": a :class:`Surrogate` (one circuit kind)
                or a :class:`SurrogateLibrary` / ``{kind: Surrogate}``
    mode        lasana only: "standalone" | "annotation"
    fused       lasana only: stacked ``predict_heads`` tick (default) or
                one ``predict`` per head
    fused_kernel  lasana only: kernel-path switch — None defers to
                ``REPRO_FUSED_KERNEL`` and is otherwise ON; False keeps the
                stacked-einsum 3-dispatch tick, which has no kernel
    device      default ``cuda``; ``"cpu"`` runs the plain versions
    """
    return engine(spec, backend=backend, mode=mode,
                  record_hidden=record_hidden, fused=fused,
                  fused_kernel=fused_kernel,
                  device=device).run(stimulus, surrogates=surrogates)


def simulate_stream(spec: NetworkSpec, stimulus, *,
                    chunk_ticks: Optional[int] = None,
                    backend: str = "lasana", surrogates=None,
                    mode: str = "standalone", record_hidden: bool = False,
                    fused_kernel: Optional[bool] = None,
                    device=None) -> NetworkRun:
    """Streaming-chunked :func:`simulate`: the same record, bit for bit,
    in memory bounded by the chunk.

    ``stimulus`` is a (T, B, fan_in) array or tensor, or an iterator of
    (t_i, B, fan_in) host blocks re-buffered to ``chunk_ticks``;
    ``surrogates`` may be an iterator of surrogates or libraries that
    hot-swaps the weights per chunk (an equal-structure swap builds
    nothing). At most two stream runners (full chunk and remainder) and
    one flush runner are built per batch and surrogate structure.
    ``record_hidden`` defaults to False here: per-layer traces of an
    unbounded stream defeat the point."""
    return engine(spec, backend=backend, mode=mode,
                  record_hidden=record_hidden, fused_kernel=fused_kernel,
                  device=device).run_stream(stimulus,
                                            chunk_ticks=chunk_ticks,
                                            surrogates=surrogates)


def stream(spec: NetworkSpec, stimulus, *,
           chunk_ticks: Optional[int] = None, backend: str = "lasana",
           surrogates=None, mode: str = "standalone",
           record_hidden: bool = False,
           fused_kernel: Optional[bool] = None,
           checkpoint_every: Optional[int] = None, device=None):
    """Generator variant of :func:`simulate_stream`: one :class:`NetworkRun`
    per chunk (chunk k is read while chunk k+1 runs); only the final chunk
    carries ``flush_energy``. Merge with :class:`StreamingRun` or
    :meth:`NetworkRun.merge`.

    ``checkpoint_every=N`` attaches a resumable :class:`StreamCheckpoint`
    to every Nth chunk's record (``run.checkpoint``; persist with
    ``.save(path)``); :func:`resume` continues from it. Requires
    ``chunk_ticks``."""
    return engine(spec, backend=backend, mode=mode,
                  record_hidden=record_hidden, fused_kernel=fused_kernel,
                  device=device).stream(
                      stimulus, chunk_ticks=chunk_ticks,
                      surrogates=surrogates,
                      checkpoint_every=checkpoint_every)


def resume(checkpoint, spec: NetworkSpec, stimulus, *, surrogates=None,
           fused_kernel: Optional[bool] = None,
           checkpoint_every: Optional[int] = None,
           device=None) -> NetworkRun:
    """Continue a checkpointed stream to its end and return the whole-run
    record: the checkpoint's prefix merged with the streamed tail, equal
    to the uninterrupted run bit for bit.

    ``checkpoint`` is a :class:`StreamCheckpoint` or the path of one saved
    with ``.save`` (by this package or by the reference); ``spec`` and
    ``stimulus`` are the ORIGINAL spec and full stimulus — the checkpoint
    pins backend, mode and chunking and checks the spec's content hash,
    and the consumed prefix is skipped. On a warm engine nothing is built.
    ``checkpoint_every`` re-arms checkpointing on the tail."""
    if isinstance(checkpoint, (str, os.PathLike)):
        checkpoint = StreamCheckpoint.load(str(checkpoint))
    eng = engine(spec, backend=checkpoint.backend, mode=checkpoint.mode,
                 record_hidden=checkpoint.record_hidden,
                 fused_kernel=fused_kernel, device=device)
    acc = StreamingRun()
    acc.update(checkpoint.acc_run)
    for chunk in eng.stream(stimulus, surrogates=surrogates,
                            resume_from=checkpoint,
                            checkpoint_every=checkpoint_every):
        acc.update(chunk)
    return acc.result()
