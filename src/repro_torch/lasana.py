"""``repro_torch.lasana`` — the port's LASANA entry point.

The counterpart of ``repro.lasana`` for training and simulation::

    import repro_torch.lasana as lasana

    sur = lasana.train("lif", lasana.TrainConfig(n_runs=300))  # on cuda
    sur.save("artifacts/lif.npz")           # loads in repro.lasana too
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

:func:`train` runs the paper's §IV pipeline on the device: the
randomized testbench, the golden simulation (one ``lif_chunk`` launch
for LIF, a ``crossbar_step`` launch a step for crossbar rows), event
extraction, and the fit of every family per predictor (GBDT histograms,
Adam and every prediction on the card; the MLP heads' predictions through
``mlp_surrogate``). Surrogates load from the reference's ``.npz``
artifacts and save to them, and checkpoints cross between the two
packages.

:func:`explore` prices a batched design space of crossbar accelerators
(:class:`CandidateSpec`) with a crossbar surrogate in one pass on the
device and returns a :class:`DSEReport` (its Pareto frontier included)::

    rep = lasana.explore(lasana.CandidateSpec.sample(4096, seed=0), xsur)
    best = rep.candidates.take(rep.pareto())

:func:`serve` starts a persistent multi-tenant simulation server
(``repro_torch.serve.SimServer``): surrogates registered by name and
version, requests from many threads continuously batched onto lanes of
:func:`engine`'s slot runners, each request's record what a solo
:func:`simulate` gives; ``python -m repro_torch.serve`` speaks its
JSON-lines protocol on stdin::

    with lasana.serve(slot_widths=(32,), chunk_ticks=16) as srv:
        srv.register_surrogate_path("lif", "artifacts/lif.npz")
        run = srv.submit(spec, stimulus, surrogates="lif").result()

The layer runners of the paper's comparisons (golden, behavioral,
LASANA-P / -O, annotation) are ``repro_torch.core.simulate`` and the
legacy bank shims ``repro_torch.core.persist``. ``mesh=`` (a
``repro_torch.launch.mesh.Mesh``) shards the batch of :func:`simulate`,
:func:`simulate_stream`, :func:`stream` and :func:`resume` over its
devices, each listed device a shard (a device may repeat)::

    mesh = make_mesh((2,), ("data",), devices=["cuda:0", "cuda:0"])
    run = lasana.simulate(spec, x, surrogates=sur, mesh=mesh)

Everything runs on ``cuda`` unless ``device=`` (or the mesh) says
otherwise.

``simulate`` keeps one :class:`NetworkEngine` per live spec and
configuration (an LRU attached to the spec), so repeated calls with
retrained surrogates of equal structure reuse one runner
(``engine(spec).compile_count`` stays 1).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Optional

import torch

from repro_torch.core.explore import CandidateSpec, DSEReport
from repro_torch.core.network import (NetworkEngine, NetworkRun, NetworkSpec,
                                      StreamingRun)
from repro_torch.core.surrogate import (FORMAT_VERSION, Manifest, Surrogate,
                                        SurrogateLibrary)
from repro_torch.kernels import ops
from repro_torch.resilience.checkpoint import StreamCheckpoint

__all__ = [
    "CandidateSpec",
    "DSEReport",
    "FORMAT_VERSION",
    "Manifest",
    "NetworkRun",
    "StreamCheckpoint",
    "StreamingRun",
    "Surrogate",
    "SurrogateLibrary",
    "TrainConfig",
    "engine",
    "explore",
    "load",
    "resume",
    "save",
    "serve",
    "simulate",
    "simulate_stream",
    "stream",
    "train",
]

DEFAULT_FAMILIES = ("mean", "table", "linear", "gbdt", "mlp")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Configuration for :func:`train` (testbench scale + model families).

    n_runs    randomized testbench runs golden-simulated for the dataset
    n_steps   digital clock periods per run
    alpha     P(timestep is active) in the randomized testbench (§IV-A)
    seed      testbench seed
    families  model families fit per predictor; the best validation-MSE
              family is selected (paper §IV-B)
    """

    n_runs: int = 1000
    n_steps: int = 125
    alpha: float = 0.8
    seed: int = 0
    families: tuple = DEFAULT_FAMILIES


def train(circuit: str, cfg: Optional[TrainConfig] = None, *,
          verbose: bool = False, device=None) -> Surrogate:
    """Train a :class:`Surrogate` for one circuit kind (paper §IV end to
    end) on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    versions).

    Draws the randomized testbench, golden-simulates it, extracts
    E1/E2/E3 events, splits them run-wise, fits every family in
    ``cfg.families`` per predictor, selects by validation MSE and freezes
    the winners. ``fit_info`` carries every family's fit metrics;
    ``train_report`` the seconds of each stage (testbench, golden, events,
    features, each family, freeze; printed when ``verbose``) and the
    dataset's event counts per kind."""
    from repro_torch.core.dataset import (CircuitDataset, TestbenchConfig,
                                          generate_testbench,
                                          simulate_golden)
    from repro_torch.core.events import extract_events, split_runwise
    from repro_torch.core.predictors import PredictorBank
    dev = ops.resolve_device(device)
    cfg = cfg or TrainConfig()
    tb = TestbenchConfig(n_runs=cfg.n_runs, n_steps=cfg.n_steps,
                         alpha=cfg.alpha, seed=cfg.seed)
    seconds = {}
    t0 = time.perf_counter()

    def stage(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1

    active, inputs, params = generate_testbench(circuit, tb, dev)
    stage("testbench")
    trace = simulate_golden(circuit, active, inputs, params, dev)
    stage("golden")
    train_ev, test_ev, val_ev = split_runwise(extract_events(trace),
                                              cfg.n_runs, seed=cfg.seed)
    ds = CircuitDataset(circuit_name=circuit, train=train_ev, test=test_ev,
                        val=val_ev, gen_seconds=sum(seconds.values()),
                        n_runs=cfg.n_runs)
    stage("events")
    bank = PredictorBank(circuit, families=tuple(cfg.families), device=dev)
    bank.fit(ds, verbose=verbose)
    stage("fit")
    sur = Surrogate.from_bank(bank)
    stage("freeze")
    del seconds["fit"]
    seconds.update({k: bank.seconds[k] for k in ("features",
                                                 *cfg.families)})
    sur.train_report = {"seconds": seconds, "events": ds.counts()}
    if verbose:
        print("train " + circuit + ": " + ", ".join(
            f"{k} {v:.3f} s" for k, v in seconds.items()))
    return sur

_ENGINE_ATTR = "_lasana_engine_cache"
_ENGINE_LOCK = threading.Lock()

# engine-variant entries kept per live spec (REPRO_ENGINE_CACHE, read
# through ops.engine_cache_capacity at each call, overrides it)
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
           mode: str = "standalone", mesh=None, record_hidden: bool = True,
           fused: bool = True, fused_kernel: Optional[bool] = None,
           device=None) -> NetworkEngine:
    """The cached :class:`NetworkEngine` serving ``spec`` for
    :func:`simulate`: one per live ``(spec, backend, mode, mesh,
    record_hidden, fused, fused_kernel, device)``, in a bounded LRU
    attached to the spec. The mesh keys by value (its devices and axis
    names), never by identity, as the reference's does: equal meshes share
    an engine, and a new mesh can never reuse a dead one's. With a mesh
    the device is the mesh's first (a ``device=`` beside it must agree)."""
    if mesh is not None:
        first = ops.resolve_device(mesh.flat()[0])
        if device is not None and ops.resolve_device(device) != first:
            raise ValueError(f"device={device!r} disagrees with the mesh, "
                             f"whose first device is {first}")
        device = first
    device = ops.resolve_device(device)
    fused_kernel = None if fused_kernel is None else bool(fused_kernel)
    key = (backend, mode, mesh, record_hidden, bool(fused), fused_kernel,
           device)
    with _ENGINE_LOCK:
        cache = getattr(spec, _ENGINE_ATTR, None)
        if cache is None:
            cache = collections.OrderedDict()
            # NetworkSpec is frozen; the cache slot is lifecycle
            # bookkeeping, not spec state
            object.__setattr__(spec, _ENGINE_ATTR, cache)
        eng = cache.get(key)
        if eng is None:
            eng = NetworkEngine(spec, backend=backend, mode=mode, mesh=mesh,
                                record_hidden=record_hidden, fused=fused,
                                fused_kernel=fused_kernel, device=device)
            cache[key] = eng
        else:
            cache.move_to_end(key)
        capacity = ops.engine_cache_capacity(ENGINE_CACHE_CAPACITY)
        while len(cache) > max(capacity, 1):
            cache.popitem(last=False)
    return eng


def simulate(spec: NetworkSpec, stimulus, *, backend: str = "lasana",
             surrogates=None, mode: str = "standalone", mesh=None,
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
    mesh        optional ``repro_torch.launch.mesh.Mesh``: shard the batch
                over its devices (the batch must divide by its size)
    fused       lasana only: stacked ``predict_heads`` tick (default) or
                one ``predict`` per head
    fused_kernel  lasana only: kernel-path switch — None defers to
                ``REPRO_FUSED_KERNEL`` and is otherwise ON; False keeps the
                stacked-einsum 3-dispatch tick, which has no kernel
    device      default ``cuda``; ``"cpu"`` runs the plain versions
    """
    return engine(spec, backend=backend, mode=mode, mesh=mesh,
                  record_hidden=record_hidden, fused=fused,
                  fused_kernel=fused_kernel,
                  device=device).run(stimulus, surrogates=surrogates)


def simulate_stream(spec: NetworkSpec, stimulus, *,
                    chunk_ticks: Optional[int] = None,
                    backend: str = "lasana", surrogates=None,
                    mode: str = "standalone", mesh=None,
                    record_hidden: bool = False,
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
    return engine(spec, backend=backend, mode=mode, mesh=mesh,
                  record_hidden=record_hidden, fused_kernel=fused_kernel,
                  device=device).run_stream(stimulus,
                                            chunk_ticks=chunk_ticks,
                                            surrogates=surrogates)


def stream(spec: NetworkSpec, stimulus, *,
           chunk_ticks: Optional[int] = None, backend: str = "lasana",
           surrogates=None, mode: str = "standalone", mesh=None,
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
    return engine(spec, backend=backend, mode=mode, mesh=mesh,
                  record_hidden=record_hidden, fused_kernel=fused_kernel,
                  device=device).stream(
                      stimulus, chunk_ticks=chunk_ticks,
                      surrogates=surrogates,
                      checkpoint_every=checkpoint_every)


def resume(checkpoint, spec: NetworkSpec, stimulus, *, surrogates=None,
           mesh=None, fused_kernel: Optional[bool] = None,
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
                 mesh=mesh, record_hidden=checkpoint.record_hidden,
                 fused_kernel=fused_kernel, device=device)
    acc = StreamingRun()
    acc.update(checkpoint.acc_run)
    for chunk in eng.stream(stimulus, surrogates=surrogates,
                            resume_from=checkpoint,
                            checkpoint_every=checkpoint_every):
        acc.update(chunk)
    return acc.result()


def explore(candidates: CandidateSpec, surrogates, *,
            engine=None) -> DSEReport:
    """Vectorized design-space exploration over crossbar surrogates.

    Prices every candidate in ``candidates`` (a batched
    :class:`CandidateSpec`: layer widths, tile size, V_dd, MoE shape,
    circuit mix): tile counts / MoE utilization / FLOP fractions are exact
    vectorized array math, and per-tile energy/latency comes from one
    ``Surrogate.predict_heads`` pass over all candidates at once on the
    engine's device. ``surrogates`` is a crossbar :class:`Surrogate` (or a
    :class:`SurrogateLibrary` / ``{kind: Surrogate}`` dict carrying a
    ``"crossbar"`` entry; a fitted ``PredictorBank`` is frozen).

    ``lasana.explore`` shares one process-wide
    :class:`repro_torch.core.explore.DSEEngine` on ``cuda`` (pass
    ``engine=`` for an isolated one, e.g. ``DSEEngine(device="cpu")``);
    re-sweeping with retrained weights of equal structure sets nothing up
    again, and the returned :class:`DSEReport` carries the engine's
    ``compile_count``. ``DSEReport.pareto()`` extracts the
    energy/latency/analog-fraction frontier."""
    from repro_torch.core.explore import evaluate_candidates
    return evaluate_candidates(candidates, surrogates, engine=engine)


def serve(config=None, **overrides):
    """Start a persistent multi-tenant simulation server (LASANA-as-a-
    service; see docs/serving.md).

    Returns a started :class:`repro_torch.serve.SimServer`: a long-lived
    process-local service that owns a surrogate artifact store
    (register/hot-swap by ``name@version``), quantizes heterogeneous
    requests onto a bounded set of slot-runner shape buckets, and packs
    concurrent requests along the batch axis of one runner (continuous
    batching — requests join/leave at chunk boundaries, with per-slot
    masks keeping every tenant's energy/latency/event records what a solo
    :func:`simulate` of that request would produce). Its driver thread
    owns every launch on the device.

    ``config`` is a :class:`repro_torch.serve.ServeConfig`; keyword
    overrides are applied on top (e.g. ``lasana.serve(chunk_ticks=16,
    max_in_flight=8)``; ``device="cpu"`` runs the plain versions — the
    default ``cuda`` raises here when there is no card). Use as a context
    manager or call ``close()``::

        with lasana.serve(chunk_ticks=8) as srv:       # no-run
            srv.register_surrogate("lif", sur)
            h = srv.submit(spec, stimulus, surrogates="lif")
            run = h.result()                           # NetworkRun
            print(srv.stats()["requests_completed"])
    """
    from repro_torch.serve import ServeConfig, SimServer
    if config is None:
        config = ServeConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    srv = SimServer(config)
    srv.start()
    return srv
