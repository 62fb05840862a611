"""Network-level event-driven LASANA engine (port of ``repro.core.network``).

A :class:`NetworkSpec` is a chain of circuit banks of two kinds — LIF
neuron layers and PCM crossbar-row layers, whose ternary weight matrices
are tiled onto ``seg_width``-input rows behind an ADC — plus optional
one-tick-delayed edges (:class:`EdgeSpec`: lateral inhibition, feedback).
Every tick, the signal layer i-1 publishes is the event queue layer i
consumes, converted by :func:`adapt_signal`; a per-circuit ``changed``
mask marks the neurons an input spike reached through a nonzero weight,
or the crossbar rows with a live input line. One engine serves the three
backends:

  golden      the golden integrators (``ops.lif_step``, ``ops.crossbar_step``)
  behavioral  the ideal discrete updates (no energy/latency)
  lasana      Algorithm 1 (``wrapper.lasana_step``) over trained
              surrogates — one per circuit kind — ``standalone`` or
              ``annotation``

The tick loop runs on the engine's device with no host synchronisation:
tick times live in a device tensor, records stay on the device, and the
host fetches them once, after the last tick (:meth:`NetworkEngine.dispatch`
enqueues, :meth:`PendingRun.result` fetches). A "program" here is the
engine's runner for one (batch, ticks, surrogate structure) key: built
once, it serves every same-structure surrogate (``compile_count``).

Streaming (:meth:`NetworkEngine.run_stream` / :meth:`NetworkEngine.stream`)
cuts the T axis into chunks through at most two stream runners (full chunk
and remainder) and one flush runner; chunk k is enqueued before chunk k-1's
records are read, from pinned host buffers behind a CUDA event, and the
merged record (:class:`StreamingRun`) equals the monolithic run bit for
bit. A graph of one LIF layer and no edges runs a whole chunk through one
time-looped kernel: ``network_tick_chunk`` (lasana, standalone, packable
heads) or ``lif_chunk`` (golden); monolithic runs take the same path.

Continuous batching (:meth:`NetworkEngine.slot_programs`, driven by
``repro_torch.serve.scheduler.Lane``) runs a ``b``-slot batch in which
requests own disjoint slots: ``join`` resets a request's slots at a chunk
boundary (``t_last`` at the join tick, so every tau equals a solo run's),
``step`` advances all slots one chunk under a per-slot live mask (slot s
is live at tick k iff ``k < end_ks[s]``, compared on the device) with
energy, latency and events kept per slot, and ``flush`` charges a leaving
request's trailing idle energy from its own slots.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.core.circuits import (CrossbarRow, LIFNeuron, get_circuit,
                                       row_sum)
from repro_torch.core.surrogate import (SurrogateLibrary, as_surrogate,
                                        structure_key)
from repro_torch.core.wrapper import LasanaState, init_state, lasana_step
from repro_torch.kernels import ops

BACKENDS = ("golden", "behavioral", "lasana")
MODES = ("standalone", "annotation")
CIRCUIT_KINDS = ("lif", "crossbar")

# a crossbar row-segment has an input event iff any of its sample-and-hold
# input lines carries a live (nonzero) voltage this tick
_XBAR_EVENT_EPS = 1e-6


# --- network specification ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One bank of circuits of a single ``circuit`` kind.

    weight      (fan_in, n_out): synaptic matrix (lif) or the ternary
                matrix tiled onto ``seg_width``-input crossbar rows
    params      lif: (n_p,) broadcast knobs or (n_out, n_p); crossbar: None
    circuit     "lif" | "crossbar"
    seg_width   crossbar: row segment width (the circuit's ``n_inputs``)
    adc_bits    crossbar: ADC resolution applied to each row output
    activation  crossbar: digital activation applied to this layer's ADC
                codes before they drive a downstream layer ("tanh"|"none")
    """

    weight: Any
    params: Any = None
    circuit: str = "lif"
    seg_width: int = 32
    adc_bits: int = 8
    activation: str = "tanh"

    @property
    def fan_in(self) -> int:
        return self.weight.shape[0]

    @property
    def n_out(self) -> int:
        return self.weight.shape[1]

    @property
    def n_seg(self) -> int:
        return -(-self.fan_in // self.seg_width)

    def n_circuits(self, batch: int) -> int:
        """Circuit instances this layer simulates for one batch."""
        if self.circuit == "crossbar":
            return batch * self.n_out * self.n_seg
        return batch * self.n_out


@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    """An extra (typically recurrent) connection between two layers,
    delivered with a ONE-TICK DELAY: at tick t the destination receives the
    source's output published at tick t-1 (zeros at t = 0).

    weight   (n_out[src], n_out[dst]) for a lif destination (synaptic
             drive) or (n_out[src], fan_in[dst]) for a crossbar destination
             (DAC input volts).
    """

    src: int
    dst: int
    weight: Any


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def recurrent_edge(src: int, dst: int, weight) -> EdgeSpec:
    """One-tick-delayed edge from layer ``src``'s output to layer ``dst``."""
    return EdgeSpec(src=src, dst=dst, weight=_f32(weight))


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """A layered circuit graph: the chain network-input -> layers[0] ->
    layers[1] -> ... evaluated within one tick, plus the one-tick-delayed
    ``edges``."""

    layers: tuple
    edges: tuple = ()
    spike_amp: float = 1.5      # V_dd spike amplitude on the event queues

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def circuits(self) -> tuple:
        return tuple(l.circuit for l in self.layers)

    def edges_into(self, i: int) -> tuple:
        return tuple(e for e in self.edges if e.dst == i)


def lif_layer(weight, params) -> LayerSpec:
    """LIF neuron bank: weight (fan_in, n_out), params (n_p,) | (n_out, n_p)."""
    return LayerSpec(weight=_f32(weight), params=_f32(params), circuit="lif")


def crossbar_layer(weight, *, seg_width: int = 32, adc_bits: int = 8,
                   activation: str = "tanh") -> LayerSpec:
    """Ternary matrix (fan_in, n_out) tiled onto seg_width-input rows."""
    return LayerSpec(weight=_f32(weight), params=None, circuit="crossbar",
                     seg_width=seg_width, adc_bits=adc_bits,
                     activation=activation)


def snn_spec(weights, params_per_layer, *, spike_amp: float = 1.5,
             edges=()) -> NetworkSpec:
    """Feed-forward SNN of LIF banks: weights[i] (fan_in_i, n_out_i)."""
    layers = tuple(lif_layer(w, p)
                   for w, p in zip(weights, params_per_layer))
    return NetworkSpec(layers=layers, edges=tuple(edges),
                       spike_amp=spike_amp)


def crossbar_mlp_spec(weights, *, seg_width: int = 32, adc_bits: int = 8,
                      activation: str = "tanh") -> NetworkSpec:
    """Ternary-weight MLP tiled onto ``seg_width``-input crossbar rows."""
    layers = tuple(crossbar_layer(w, seg_width=seg_width, adc_bits=adc_bits,
                                  activation=activation) for w in weights)
    return NetworkSpec(layers=layers)


def graph_spec(layers, *, edges=(), spike_amp: float = 1.5) -> NetworkSpec:
    """Arbitrary mixed-circuit graph from LayerSpecs + EdgeSpecs."""
    return NetworkSpec(layers=tuple(layers), edges=tuple(edges),
                       spike_amp=spike_amp)


# --- typed inter-layer adapters -----------------------------------------------

def _digital_activation(y, activation: str):
    if activation == "tanh":
        return torch.tanh(y)
    return y


def adapt_signal(src_kind: str, dst_kind: str, y, *, spike_amp: float = 1.5,
                 activation: str = "tanh"):
    """A source layer's published output in dst-native input units.

    Published outputs: lif — spike amplitudes in {0, spike_amp} V;
    crossbar — post-ADC, gain-compensated codes in weight-sum units;
    "input" — the stimulus, already in the first layer's units. The
    conversions (``activation`` is the SOURCE crossbar layer's):

      lif      -> lif       identity
      lif      -> crossbar  spike -> DAC volts: s * input_hi / spike_amp
      crossbar -> lif       code -> signed drive: act(y) * spike_amp
      crossbar -> crossbar  code -> DAC volts: act(y) * input_hi
    """
    if src_kind == "input":
        return y
    xb = get_circuit("crossbar")
    if src_kind == "lif" and dst_kind == "lif":
        return y
    if src_kind == "lif" and dst_kind == "crossbar":
        return y * (xb.input_hi / spike_amp)
    if src_kind == "crossbar" and dst_kind == "lif":
        return _digital_activation(y, activation) * spike_amp
    if src_kind == "crossbar" and dst_kind == "crossbar":
        return _digital_activation(y, activation) * xb.input_hi
    raise ValueError(f"no adapter for {src_kind!r} -> {dst_kind!r}")


def event_threshold(src_kind: str, spike_amp: float) -> float:
    """|u| above this counts as an input event at a LIF destination:
    spiking sources emit V_dd pulses (half-amplitude discriminator),
    analog crossbar sources count any appreciable drive."""
    if src_kind in ("input", "lif"):
        return 0.5 * spike_amp
    return 0.05 * spike_amp


def drive_to_circuit_inputs(drive, *, spike_amp: float = 1.5,
                            n_spk: float = 5.0):
    """Aggregate synaptic drive -> (w, x, n) LIF circuit inputs."""
    w = torch.clamp(drive, -1.0, 1.0)
    return torch.stack([w, torch.full_like(drive, spike_amp),
                        torch.full_like(drive, n_spk)], dim=-1)


def _count_events(changed):
    """Exact int32 count of a ``changed`` mask (stays on the device)."""
    return changed.sum(dtype=torch.int32)


def _slot_events(changed, b: int):
    """Per-slot int32 counts of a batch-major ``changed`` mask: (b,)."""
    return changed.reshape(b, -1).sum(1, dtype=torch.int32)


def _tile_params(p, b: int, n_out: int):
    if p.dim() == 1:                      # one knob set for the whole layer
        return p[None].expand(b * n_out, p.shape[0]).contiguous()
    return p.repeat(b, 1)                 # per-neuron knobs, batch-tiled


def _row_segments(w, seg_width: int) -> np.ndarray:
    """(n_in, n_out) ternary matrix -> (n_out * n_seg, seg_width + 1)
    crossbar row params, output-major (the last column is the bias row,
    unused here)."""
    w = np.asarray(w)
    n_in, n_out = w.shape
    n_seg = -(-n_in // seg_width)
    wp = np.pad(w, ((0, n_seg * seg_width - n_in), (0, 0)))
    segs = (wp.reshape(n_seg, seg_width, n_out)
            .transpose(2, 0, 1).reshape(-1, seg_width))
    return np.concatenate([segs, np.zeros((len(segs), 1))],
                          axis=1).astype(np.float32)


def _iter_chunks(stimulus, chunk_ticks, fan_in: int, skip_ticks: int = 0):
    """Yield (t_i, B, fan_in) stimulus chunks for the streaming path.

    ``stimulus`` is either one (T, B, fan_in) array (numpy or a tensor) —
    sliced into ``chunk_ticks``-tick chunks — or an iterator of
    (t_i, B, fan_in) blocks, re-buffered to ``chunk_ticks`` ticks when a
    chunk size is given (the last chunk may be short). 2-D (B, fan_in)
    blocks promote to one tick. ``skip_ticks`` drops the leading ticks
    before chunking (checkpoint resume: the caller re-supplies the FULL
    original stimulus and the consumed prefix is skipped here, so the
    tail re-chunks exactly as the uninterrupted run would have)."""
    if chunk_ticks is not None and chunk_ticks <= 0:
        raise ValueError(f"chunk_ticks must be positive: {chunk_ticks}")

    def check(blk):
        if blk.ndim == 2:
            blk = blk[None]
        if blk.ndim != 3:
            raise ValueError(f"stimulus chunks must be (T, B, n_in), got "
                             f"shape {tuple(blk.shape)}")
        if blk.shape[-1] != fan_in:
            raise ValueError(f"input width {blk.shape[-1]} != layer-0 "
                             f"fan_in {fan_in}")
        return blk

    skip = int(skip_ticks)
    if hasattr(stimulus, "ndim"):              # one whole array
        x = check(stimulus)[skip:]
        step = int(chunk_ticks) if chunk_ticks else x.shape[0]
        for a in range(0, x.shape[0], step):
            yield x[a:a + step]
        return
    parts, have = [], 0                        # iterator of blocks
    for block in stimulus:
        blk = check(np.asarray(block, np.float32))
        if skip:                               # resume: drop consumed prefix
            if blk.shape[0] <= skip:
                skip -= blk.shape[0]
                continue
            blk = blk[skip:]
            skip = 0
        if chunk_ticks is None:
            yield blk
            continue
        parts.append(blk)
        have += blk.shape[0]
        while have >= chunk_ticks:             # one concat per emitted chunk
            buf = parts[0] if len(parts) == 1 \
                else np.concatenate(parts, axis=0)
            yield buf[:chunk_ticks]
            rest = buf[chunk_ticks:]
            parts = [rest] if rest.shape[0] else []
            have = rest.shape[0]
    if have:
        yield parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


def _t_end(k: int, circ) -> float:
    """Run-end time after ``k`` ticks in ``circ``'s clock, rounded to f32
    once — the same number in the monolithic and the streaming flush."""
    return float(np.float32(k * circ.clock_ns))


# --- run record ---------------------------------------------------------------

@dataclasses.dataclass
class NetworkRun:
    """Record of one network simulation over T ticks (combinational: T=1)."""

    backend: str
    mode: str
    outputs: np.ndarray           # lif last layer: (B, n_cls) spike counts;
                                  # crossbar last layer: (B, n_cls) codes
    out_spikes: Optional[np.ndarray]   # lif last layer: (T, B, n_cls) amps
    layer_spikes: Optional[list]  # per layer (T, B, n_i) published outputs
    energy: np.ndarray            # (T, L) joules per tick per layer
    latency: np.ndarray           # (T, L) ns — max over the layer's circuits
    events: np.ndarray            # (T, L) input events processed
    flush_energy: np.ndarray      # (L,) end-of-run idle static energy
    n_circuits: np.ndarray        # (L,) circuits per layer (B-included)
    clock_ns: float
    wall_seconds: float           # dispatch to fetched records (no build)
    circuits: tuple = ()          # (L,) per-layer circuit kind
    compile_seconds: float = 0.0  # one-time build of this runner
    checkpoint: Optional[Any] = None   # StreamCheckpoint when this chunk
                                  # closed a checkpoint interval (stream
                                  # with checkpoint_every=); merge and
                                  # StreamingRun ignore it

    def report(self) -> dict:
        """Aggregate per-layer energy/latency/events + network totals."""
        t_steps, n_layers = self.energy.shape
        circuits = self.circuits or ("?",) * n_layers
        e_layer = self.energy.sum(axis=0) + self.flush_energy
        ev_layer = self.events.sum(axis=0)
        max_lat = self.latency.max(axis=0, initial=0.0)
        mean_lat = (self.latency.mean(axis=0) if t_steps
                    else np.zeros(n_layers, np.float64))
        layers = []
        for i in range(n_layers):
            layers.append({
                "layer": i,
                "circuit": circuits[i],
                "backend": self.backend,
                "n_circuits": int(self.n_circuits[i]),
                "energy_j": float(e_layer[i]),
                "flush_energy_j": float(self.flush_energy[i]),
                "events": int(ev_layer[i]),
                "max_latency_ns": float(max_lat[i]),
                "mean_tick_latency_ns": float(mean_lat[i]),
            })
        total_events = int(ev_layer.sum()) if n_layers else 0
        by_kind: dict = {}
        for l in layers:
            agg = by_kind.setdefault(l["circuit"],
                                     {"energy_j": 0.0, "events": 0})
            agg["energy_j"] += l["energy_j"]
            agg["events"] += l["events"]
        return {
            "backend": self.backend,
            "mode": self.mode,
            "layers": layers,
            "by_circuit": by_kind,
            "network": {
                "ticks": t_steps,
                "sim_time_ns": t_steps * self.clock_ns,
                "energy_j": float(sum(l["energy_j"] for l in layers)),
                "events": total_events,
                "events_per_sec": total_events / max(self.wall_seconds, 1e-9),
                "wall_seconds": self.wall_seconds,
                "compile_seconds": self.compile_seconds,
            },
        }

    @classmethod
    def merge(cls, chunks) -> "NetworkRun":
        """Merge consecutive per-chunk records into one whole-run record,
        bit-identical to the monolithic run over the concatenated
        stimulus: spike counts sum (a crossbar last layer keeps the last
        chunk's codes), per-tick records concatenate, the flush (only on a
        stream's final chunk) applies once, wall/compile seconds sum."""
        acc = StreamingRun()
        for c in chunks:
            acc.update(c)
        return acc.result()


class StreamingRun:
    """Incremental accumulator of per-chunk :class:`NetworkRun` records.

    :meth:`NetworkEngine.run_stream` feeds it one chunk at a time and
    :meth:`result` freezes a :class:`NetworkRun` bit-identical to the
    monolithic run (see :meth:`NetworkRun.merge`). Live totals —
    :attr:`ticks`, :attr:`events`, :attr:`energy_j` — update as chunks
    arrive."""

    def __init__(self):
        self._first: Optional[NetworkRun] = None
        self._last: Optional[NetworkRun] = None
        self._counts = None            # lif last layer: running spike counts
        self._out_chunks: list = []
        self._hidden_chunks: list = []
        self._energy: list = []
        self._latency: list = []
        self._events: list = []
        self._flush = None
        self.ticks = 0                 # ticks accumulated so far
        self.events = 0                # input events accumulated so far
        self.energy_j = 0.0            # joules accumulated so far (no flush)
        self.wall_seconds = 0.0
        self.compile_seconds = 0.0

    def update(self, chunk: NetworkRun) -> "StreamingRun":
        """Fold the next consecutive chunk record in; returns ``self``."""
        if self._first is None:
            self._first = chunk
            self._flush = np.zeros_like(chunk.flush_energy)
        elif (chunk.backend != self._first.backend
                or chunk.mode != self._first.mode
                or chunk.circuits != self._first.circuits):
            raise ValueError("cannot merge chunks from different runs: "
                             f"{chunk.backend}/{chunk.mode} vs "
                             f"{self._first.backend}/{self._first.mode}")
        self._last = chunk
        if chunk.circuits and chunk.circuits[-1] == "lif":
            c = np.asarray(chunk.outputs, np.int64)
            self._counts = c if self._counts is None else self._counts + c
            self._out_chunks.append(chunk.out_spikes)
        if chunk.layer_spikes is not None:
            self._hidden_chunks.append(chunk.layer_spikes)
        self._energy.append(chunk.energy)
        self._latency.append(chunk.latency)
        self._events.append(chunk.events)
        self._flush = self._flush + chunk.flush_energy
        self.ticks += chunk.energy.shape[0]
        self.events += int(chunk.events.sum())
        self.energy_j += float(chunk.energy.sum())
        self.wall_seconds += chunk.wall_seconds
        self.compile_seconds += chunk.compile_seconds
        return self

    def result(self) -> NetworkRun:
        """Freeze the accumulated chunks into one :class:`NetworkRun`."""
        if self._first is None or self._last is None:
            raise ValueError("StreamingRun.result() before any update()")
        first, last = self._first, self._last
        last_lif = first.circuits and first.circuits[-1] == "lif"
        if last_lif:
            outputs = self._counts.astype(first.outputs.dtype)
            out_spikes = np.concatenate(self._out_chunks, axis=0)
        else:
            outputs = last.outputs
            out_spikes = None
        hidden = None
        if self._hidden_chunks:
            hidden = [np.concatenate([h[i] for h in self._hidden_chunks],
                                     axis=0)
                      for i in range(len(self._hidden_chunks[0]))]
        return NetworkRun(
            backend=first.backend, mode=first.mode,
            outputs=outputs, out_spikes=out_spikes, layer_spikes=hidden,
            energy=np.concatenate(self._energy, axis=0),
            latency=np.concatenate(self._latency, axis=0),
            events=np.concatenate(self._events, axis=0),
            flush_energy=self._flush,
            n_circuits=first.n_circuits, clock_ns=first.clock_ns,
            wall_seconds=self.wall_seconds, circuits=first.circuits,
            compile_seconds=self.compile_seconds)


@dataclasses.dataclass(frozen=True)
class SlotPrograms:
    """The continuous-batching runners of one (batch width, chunk ticks,
    surrogate structure) bucket — what the serving layer's scheduler
    drives (see :meth:`NetworkEngine.slot_programs` for the calling
    conventions and the parity contract)."""

    step: Any                      # one chunk of every slot, live-masked
    flush: Any                     # per-slot leave-time idle flush
    join: Any                      # masked slot (re)initialisation
    compile_seconds: float         # 0.0 when every runner was cached


def _nbytes(tensors) -> int:
    return sum(t.nbytes for t in tensors if t is not None)


class PendingRun:
    """A run enqueued on the device: its records are device tensors until
    :meth:`result` waits for them (on ``event``, recorded behind the run
    on the card) and builds the :class:`NetworkRun`. ``call`` is the id
    of the dispatch's trace spans."""

    def __init__(self, engine, b, t0, compile_s, out, event, call):
        self._engine, self._b, self._t0 = engine, b, t0
        self._compile_s, self._out = compile_s, out
        self._event, self._call = event, call

    def result(self) -> NetworkRun:
        eng, spec = self._engine, self._engine.spec
        primary, out_seq, hidden, e_tl, l_tl, ev_tl, flush = self._out
        last_lif = spec.circuits[-1] == "lif"
        with trace.span("run.result", self._call):
            with trace.span("run.wait"):
                if self._event is not None:
                    self._event.synchronize()
            with trace.span("run.fetch"):
                records = [primary, out_seq if last_lif else None, *hidden,
                           e_tl, l_tl, ev_tl, flush]
                host = [None if t is None else t.cpu().numpy()
                        for t in records]
                trace.count("records.bytes", _nbytes(records))
                outputs, out_spikes = host[:2]
                layers = host[2:2 + len(hidden)]
                energy, latency, events, flush_e = host[2 + len(hidden):]
                return NetworkRun(
                    backend=eng.backend, mode=eng.mode, outputs=outputs,
                    out_spikes=out_spikes,
                    layer_spikes=layers if eng.record_hidden else None,
                    energy=energy, latency=latency,
                    events=events.astype(np.int64), flush_energy=flush_e,
                    n_circuits=np.asarray([l.n_circuits(self._b)
                                           for l in spec.layers]),
                    clock_ns=eng.clock_ns,
                    wall_seconds=time.perf_counter() - self._t0,
                    circuits=spec.circuits, compile_seconds=self._compile_s)


# --- the engine ----------------------------------------------------------------

class NetworkEngine:
    """A heterogeneous circuit graph under one event-driven tick loop.

    backend   "golden" | "behavioral" | "lasana"
    mode      lasana only: "standalone" or "annotation"
    surrogates  backend="lasana": a :class:`Surrogate` (one circuit kind)
              or a :class:`SurrogateLibrary` / ``{kind: Surrogate}``
              mapping (mixed graphs); may be given per :meth:`run` instead
    record_hidden  keep per-layer output traces
    fused     lasana only: the stacked ``predict_heads`` tick (default) or
              one ``predict`` per head (``fused=False``)
    fused_kernel  lasana only: tri-state kernel-path switch (None =
              ``REPRO_FUSED_KERNEL``, else on): packable heads tick through
              ``network_tick`` (one cross-kind pack for a mixed library),
              other stacked MLP heads through ``mlp_surrogate_heads``;
              ``False`` keeps the einsum path
    mesh      optional :class:`repro_torch.launch.mesh.Mesh`: the batch
              shards over every mesh axis (``core/distributed.py``); each
              shard runs on its device through a replica of this engine
              (shards on one device run in turn), energy, events and flush
              are summed and latency is maxed across shards. The batch
              must divide by the mesh size
    device    where the engine runs (default ``cuda``; see
              ``ops.resolve_device``); with a mesh, its first device, and a
              ``device=`` given beside a mesh must be that device
    """

    def __init__(self, spec: NetworkSpec, backend: str = "lasana", *,
                 surrogates=None, mode: str = "standalone", mesh=None,
                 record_hidden: bool = True, fused: bool = True,
                 fused_kernel: bool | None = None, device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}: {backend}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}: {mode}")
        for layer in spec.layers:
            if layer.circuit not in CIRCUIT_KINDS:
                raise ValueError(f"unknown circuit kind {layer.circuit!r}; "
                                 f"registered kinds: {CIRCUIT_KINDS}")
        self.spec = spec
        self.backend = backend
        self.mode = mode if backend == "lasana" else "standalone"
        self.record_hidden = record_hidden
        self.fused = bool(fused)
        self.fused_kernel = (None if fused_kernel is None
                             else bool(fused_kernel))
        self.mesh = mesh
        shard_devs = []
        if mesh is not None:
            shard_devs = [ops.resolve_device(d) for d in mesh.flat()]
            if device is not None \
                    and ops.resolve_device(device) != shard_devs[0]:
                raise ValueError(
                    f"device={device!r} disagrees with the mesh, whose "
                    f"first device is {shard_devs[0]}")
            device = shard_devs[0]
        self.device = ops.resolve_device(device)
        self.circs = tuple(get_circuit(l.circuit) for l in spec.layers)
        if surrogates is not None and backend != "lasana":
            raise ValueError(
                f"backend={backend!r} does not use surrogates; pass "
                "surrogates= only with backend='lasana'")
        self.surrogates = (self._normalize_surrogates(surrogates)
                           if surrogates is not None else None)
        for i, (layer, circ) in enumerate(zip(spec.layers, self.circs)):
            if isinstance(circ, LIFNeuron) and spec.spike_amp != circ.vdd:
                raise ValueError(
                    f"spike_amp {spec.spike_amp} != circuit V_dd "
                    f"{circ.vdd}; the LIF event queues carry V_dd spikes")
            if isinstance(circ, CrossbarRow) \
                    and layer.seg_width != circ.n_inputs:
                raise ValueError(
                    f"layer {i}: seg_width {layer.seg_width} != crossbar "
                    f"row n_inputs {circ.n_inputs}")
        self._validate_edges()
        # one global digital clock; per-layer tick times use each
        # circuit's native clock
        self.clock_ns = max(c.clock_ns for c in self.circs)
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        self._weights = [torch.as_tensor(l.weight, **f32)
                         for l in spec.layers]
        self._params = [None if l.params is None
                        else torch.as_tensor(l.params, **f32)
                        for l in spec.layers]
        # lif layers: (|w| > 0) connectivity for event detection; crossbar
        # layers: their row params, output-major (b-tiled per run)
        self._conn = [(torch.abs(w) > 0).float()
                      if l.circuit == "lif" else None
                      for w, l in zip(self._weights, spec.layers)]
        self._segs = [torch.as_tensor(_row_segments(l.weight, l.seg_width),
                                      **f32)
                      if l.circuit == "crossbar" else None
                      for l in spec.layers]
        # one-tick-delayed edges into each layer: (src, weight, conn)
        self._rec = [[] for _ in spec.layers]
        for e in spec.edges:
            we = torch.as_tensor(e.weight, **f32)
            conn = ((torch.abs(we) > 0).float()
                    if spec.layers[e.dst].circuit == "lif" else None)
            self._rec[e.dst].append((e.src, we, conn))
        self._runners: dict = {}
        self._lock = threading.Lock()
        self.compile_count = 0        # tick-loop runners built
        # one replica engine per other device of the mesh: a shard runs
        # the replica's runner on the replica's copy of the weights
        self._replicas = {}
        for dev in shard_devs:
            if dev != self.device and str(dev) not in self._replicas:
                self._replicas[str(dev)] = NetworkEngine(
                    spec, backend, mode=mode, record_hidden=record_hidden,
                    fused=fused, fused_kernel=fused_kernel, device=dev)
        if self.surrogates is not None:
            self._load_libraries(self.surrogates)

    def _normalize_surrogates(self, src) -> SurrogateLibrary:
        """Coerce surrogates into a validated library on the engine's device."""
        kinds = set(self.spec.circuits)
        if isinstance(src, SurrogateLibrary):
            mapping = dict(src.items())
        elif isinstance(src, dict):
            mapping = dict(src)
        else:
            if len(kinds) > 1:
                raise ValueError(
                    "mixed-circuit graphs need a {circuit: Surrogate} "
                    f"library, got a single surrogate for kinds "
                    f"{sorted(kinds)}")
            mapping = {next(iter(kinds)): src}
        missing = kinds - set(mapping)
        if missing:
            raise ValueError("backend='lasana' is missing a Surrogate for "
                             f"circuit kind(s) {sorted(missing)}")
        lib = {}
        for kind in sorted(kinds):
            s = as_surrogate(mapping[kind])
            if s.circuit != kind:
                raise ValueError(
                    f"surrogate trained for circuit {s.circuit!r} bound to "
                    f"layer kind {kind!r}")
            lib[kind] = s.to(self.device)
        return SurrogateLibrary(lib)

    def _validate_edges(self):
        spec = self.spec
        n = spec.n_layers
        for e in spec.edges:
            if not (0 <= e.src < n and 0 <= e.dst < n):
                raise ValueError(f"edge {e.src}->{e.dst} out of range for "
                                 f"{n} layers")
            dst = spec.layers[e.dst]
            want = (spec.layers[e.src].n_out,
                    dst.n_out if dst.circuit == "lif" else dst.fan_in)
            got = tuple(np.shape(e.weight))
            if got != want:
                raise ValueError(
                    f"edge {e.src}->{e.dst} weight shape {got} != {want} "
                    f"(src n_out, dst {'n_out' if dst.circuit == 'lif' else 'fan_in'})")

    def _runtime_banks(self, surrogates) -> SurrogateLibrary:
        if self.backend != "lasana":
            if surrogates is not None:
                raise ValueError(
                    f"backend={self.backend!r} does not use surrogates; "
                    "pass surrogates= only with backend='lasana'")
            return SurrogateLibrary()
        banks = (self._normalize_surrogates(surrogates)
                 if surrogates is not None else self.surrogates)
        if banks is None:
            raise ValueError("backend='lasana' requires surrogates: pass "
                             "surrogates= to NetworkEngine or run()")
        return banks

    # --- public entry points ----------------------------------------------------

    def run(self, inputs, *, surrogates=None) -> NetworkRun:
        """inputs: (T, B, n_in) per-tick stimulus in the first layer's
        native units (spike amplitudes for lif, DAC volts for crossbar); a
        (B, n_in) input is one combinational wave (T = 1). ``surrogates``
        overrides the engine-bound library for this run; a same-structure
        swap reuses the runner (no rebuild)."""
        return self.dispatch(inputs, surrogates=surrogates).result()

    def dispatch(self, inputs, *, surrogates=None) -> PendingRun:
        """Enqueue a whole run on the device and return at once; the tick
        loop makes no host synchronisation (inputs and surrogates already
        on the device stay there); on the card an event recorded behind
        the run is what :meth:`PendingRun.result` waits on."""
        with trace.span("engine.dispatch") as call:
            x = torch.as_tensor(inputs, dtype=torch.float32,
                                device=self.device)
            if x.dim() == 2:
                x = x[None]
            if x.shape[-1] != self.spec.layers[0].fan_in:
                raise ValueError(f"input width {x.shape[-1]} != layer-0 "
                                 f"fan_in {self.spec.layers[0].fan_in}")
            t_steps, b, _ = x.shape
            self._check_mesh_batch(b)
            banks = self._runtime_banks(surrogates)
            key = self._program_key("mono", b, t_steps, banks)
            hid = 1 if self.record_hidden else []
            runner, compile_s = self._compiled(key, lambda: self._sharded(
                lambda eng, bl: eng._build_sim(bl, t_steps), b, banks,
                in_specs=(1, 0, None),
                out_specs=(0, 1, hid, "sum", "max", "sum", "sum")))
            t0 = time.perf_counter()
            carries = [self._init_carry(i, b)
                       for i in range(self.spec.n_layers)]
            with trace.span("engine.enqueue"):
                out = runner(x, carries, banks)
            return PendingRun(self, b, t0, compile_s, out, self._event(),
                              call.id)

    def run_stream(self, stimulus, *, chunk_ticks: Optional[int] = None,
                   surrogates=None) -> NetworkRun:
        """Streaming-chunked :meth:`run`: the same record, bit for bit, in
        memory bounded by the chunk.

        stimulus    (T, B, fan_in) array or tensor — sliced into chunks —
                    or an iterator of (t_i, B, fan_in) host blocks,
                    re-buffered to ``chunk_ticks`` when it is given
        chunk_ticks ticks per chunk (default: one chunk = whole stimulus)
        surrogates  as :meth:`run`; an *iterator* of surrogates or
                    libraries hot-swaps the weights per chunk (``None``
                    entries and exhaustion hold the last); equal-structure
                    swaps build nothing
        """
        acc = StreamingRun()
        for chunk in self.stream(stimulus, chunk_ticks=chunk_ticks,
                                 surrogates=surrogates):
            acc.update(chunk)
        return acc.result()

    def stream(self, stimulus, *, chunk_ticks: Optional[int] = None,
               surrogates=None, checkpoint_every: Optional[int] = None,
               resume_from=None):
        """Generator variant of :meth:`run_stream`: one :class:`NetworkRun`
        per chunk, yielded once chunk k+1 is enqueued; only the final chunk
        carries ``flush_energy``. Arguments as :meth:`run_stream`, plus:

        checkpoint_every  attach a resumable
                    :class:`~repro_torch.resilience.checkpoint.StreamCheckpoint`
                    to every Nth chunk's record (``.checkpoint``; never
                    the final, flush-bearing chunk). Requires
                    ``chunk_ticks``.
        resume_from  a ``StreamCheckpoint``: restore the carries and the
                    tick offset and continue. The caller re-supplies the
                    FULL original stimulus (the consumed prefix is
                    skipped); only post-resume chunks are yielded.

        Argument errors raise here, not at the first ``next()``."""
        spec = self.spec
        if chunk_ticks is not None and chunk_ticks <= 0:
            raise ValueError(f"chunk_ticks must be positive: {chunk_ticks}")
        if resume_from is not None:
            resume_from.verify_engine(self, spec)
            if chunk_ticks is None:
                chunk_ticks = resume_from.chunk_ticks
            elif chunk_ticks != resume_from.chunk_ticks:
                raise ValueError(
                    f"chunk_ticks {chunk_ticks} != checkpoint's "
                    f"{resume_from.chunk_ticks}: the resumed tail must "
                    "re-chunk exactly as the original stream")
        # after the resume's chunk size is known, so that a resumed tail
        # can re-arm checkpoints without naming the chunk size again
        if checkpoint_every is not None:
            if checkpoint_every <= 0:
                raise ValueError("checkpoint_every must be positive: "
                                 f"{checkpoint_every}")
            if chunk_ticks is None:
                raise ValueError(
                    "checkpoint_every requires chunk_ticks: checkpoints "
                    "sit at chunk boundaries")
        if hasattr(stimulus, "ndim"):
            if stimulus.ndim not in (2, 3):
                raise ValueError("stimulus must be (T, B, n_in) or "
                                 f"(B, n_in), got shape "
                                 f"{tuple(stimulus.shape)}")
            if stimulus.shape[-1] != spec.layers[0].fan_in:
                raise ValueError(f"input width {stimulus.shape[-1]} != "
                                 f"layer-0 fan_in "
                                 f"{spec.layers[0].fan_in}")
        sur_iter, static_banks = None, None
        if surrogates is not None and hasattr(surrogates, "__next__"):
            if self.backend != "lasana":
                raise ValueError(
                    f"backend={self.backend!r} does not use surrogates; "
                    "pass surrogates= only with backend='lasana'")
            sur_iter = surrogates
        else:
            static_banks = self._runtime_banks(surrogates)
        return self._stream_gen(stimulus, chunk_ticks, static_banks,
                                sur_iter, checkpoint_every, resume_from)

    def _stream_gen(self, stimulus, chunk_ticks, static_banks, sur_iter,
                    checkpoint_every=None, resume_from=None):
        from repro_torch.resilience import faults
        spec = self.spec
        chunks = _iter_chunks(stimulus, chunk_ticks, spec.layers[0].fan_in,
                              skip_ticks=(resume_from.k0
                                          if resume_from is not None else 0))
        i = 0                          # the index of chunk ``cur``
        with trace.span("stream.block", i):
            cur = next(chunks, None)
        if cur is None:
            raise ValueError("streaming run needs at least one stimulus "
                             "tick" + (" past the checkpoint offset"
                                       if resume_from is not None else ""))
        b = cur.shape[1]
        self._check_mesh_batch(b)
        n_layers = spec.n_layers
        last_lif = spec.circuits[-1] == "lif"
        carries = [self._init_carry(i, b) for i in range(n_layers)]
        prev_ys = [torch.zeros((b, l.n_out), device=self.device)
                   for l in spec.layers]
        k0 = 0
        if resume_from is not None:
            carries, prev_ys = self._restore_state(resume_from, carries,
                                                   prev_ys, b)
            k0 = int(resume_from.k0)
        banks = static_banks
        # the accumulator mirrors every yielded record so that a
        # checkpoint carries the exact merged prefix
        acc = None
        if checkpoint_every is not None:
            acc = StreamingRun()
            if resume_from is not None:
                acc.update(resume_from.acc_run)

        mark = time.perf_counter()     # segment boundary for the wall split
        comp_seg = 0.0                 # build seconds in the current segment
        n_circuits = np.asarray([l.n_circuits(b) for l in spec.layers])

        def finalize(pend, flush):
            nonlocal mark, comp_seg
            host, snap, event, comp_s, k_end, idx = pend
            with trace.span("stream.wait", idx):
                if event is not None:
                    event.synchronize()    # this chunk's copies only
            with trace.span("stream.convert", idx):
                primary, out_seq, e_tl, l_tl, ev_tl, *hidden = host
                now = time.perf_counter()
                wall = max(now - mark - comp_seg, 0.0)
                mark, comp_seg = now, 0.0
                run = NetworkRun(
                    backend=self.backend, mode=self.mode,
                    outputs=primary.numpy(),
                    out_spikes=out_seq.numpy() if last_lif else None,
                    layer_spikes=[h.numpy() for h in hidden]
                    if self.record_hidden else None,
                    energy=e_tl.numpy(), latency=l_tl.numpy(),
                    events=ev_tl.numpy().astype(np.int64),
                    flush_energy=flush, n_circuits=n_circuits,
                    clock_ns=self.clock_ns, wall_seconds=wall,
                    circuits=spec.circuits, compile_seconds=comp_s)
                if acc is not None:
                    acc.update(run)
                    if snap is not None:
                        leaves, prev = snap
                        run.checkpoint = self._make_checkpoint(
                            [np.array(a.numpy()) for a in leaves],
                            [np.array(a.numpy()) for a in prev], k_end,
                            int(chunk_ticks), b, acc)
            return run

        pending = None                 # the previous chunk's host copies
        inflight = None                # the latest chunk's copy event
        try:
            while cur is not None:
                faults.stall("chunk.stall")
                with trace.span("stream.upload", i):
                    x_chunk = self._upload(cur)
                if x_chunk.shape[1] != b:
                    raise ValueError(
                        f"stimulus chunk batch {x_chunk.shape[1]} "
                        f"!= first chunk batch {b}")
                if sur_iter is not None:
                    swap = next(sur_iter, None)
                    if swap is not None:
                        banks = self._runtime_banks(swap)
                    elif banks is None:
                        raise ValueError("surrogate iterator must yield a "
                                         "library for the first chunk")
                tc = x_chunk.shape[0]
                key = self._program_key("stream", b, tc, banks)
                hid = 1 if self.record_hidden else []
                step, comp_s = self._compiled(key, lambda: self._sharded(
                    lambda eng, bl: eng._build_stream_step(tc), b, banks,
                    in_specs=(1, None, 0, 0, None),
                    out_specs=(0, 1, hid, "sum", "max", "sum", 0, 0)), i)
                comp_seg += comp_s
                # enqueue chunk k, then read chunk k-1's records
                with trace.span("engine.enqueue", i):
                    (primary, out_seq, hidden, e_tl, l_tl, ev_tl, carries,
                     prev_ys) = step(x_chunk, k0, carries, prev_ys, banks)
                k0 += tc
                records = [primary, out_seq if last_lif else None, e_tl,
                           l_tl, ev_tl, *hidden]
                due = acc is not None and (
                    -(-k0 // int(chunk_ticks)) % checkpoint_every == 0)
                with trace.span("stream.to_host", i):
                    (host, *snap), event = self._to_host(
                        records, *((_carry_leaves(carries), prev_ys) if due
                                   else ()))
                    trace.count("records.bytes", _nbytes(records))
                inflight = event
                if pending is not None:
                    yield finalize(pending, np.zeros((n_layers,),
                                                     np.float32))
                pending = (host, snap or None, event, comp_s, k0, i)
                if k0 > 2 ** 24 and k0 - tc <= 2 ** 24:
                    # tick times and LasanaState.t_last are f32: past 2^24
                    # ticks consecutive tick times collide, so tau-dependent
                    # records (merged-E2 idle energy, flush) lose precision
                    warnings.warn(
                        f"stream passed tick 2^24 ({k0} ticks): f32 tick "
                        "times can no longer distinguish consecutive ticks; "
                        "tau-dependent energy records degrade beyond here",
                        RuntimeWarning, stacklevel=2)
                i += 1
                with trace.span("stream.block", i):
                    cur = next(chunks, None)

            flush = np.zeros((n_layers,), np.float32)
            if self.backend == "lasana":
                fkey = self._program_key("flush", b, None, banks)
                flush_fn, comp_s = self._compiled(fkey, lambda: self._sharded(
                    lambda eng, bl: eng._build_flush(), b, banks,
                    in_specs=(0, None, None), out_specs="sum"), i - 1)
                comp_seg += comp_s
                t_ends = [_t_end(k0, c) for c in self.circs]
                with trace.span("stream.flush", i - 1):
                    flush_d = flush_fn(carries, t_ends, banks)
                    ((flush_t,),), ev = self._to_host([flush_d])
                    trace.count("records.bytes", flush_d.nbytes)
                    if ev is not None:
                        ev.synchronize()
                flush = flush_t.numpy()
            # the final chunk never carries a checkpoint: its record holds
            # the end-of-run flush, which a resumed tail would charge again
            host, _, event, comp_s, k_end, idx = pending
            yield finalize((host, None, event, comp_s, k_end, idx), flush)
        finally:
            # a consumer that stops mid-stream closes the generator with a
            # chunk in flight: let it finish before its buffers are dropped
            if inflight is not None:
                inflight.synchronize()

    def _upload(self, a, dtype=torch.float32):
        """A host block (numpy or tensor) as a ``dtype`` tensor on the
        engine's device; a CPU block reaches the card through pinned
        memory and an asynchronous copy (no host synchronisation)."""
        t = torch.as_tensor(a, dtype=dtype)
        if self.device.type != "cuda" or t.device == self.device:
            return t.to(self.device)
        if t.device.type == "cpu":
            t = t.contiguous().pin_memory()
        return t.to(self.device, non_blocking=True)

    def _to_host(self, *groups):
        """``(groups, event)``: each group (a list of tensors or None) as
        host tensors. On CUDA each tensor is copied into pinned host
        memory asynchronously and one CUDA event is recorded behind the
        copies (wait on it, not on the device); on the CPU the tensors
        are their own host copies and there is no event."""
        if self.device.type != "cuda":
            return [list(g) for g in groups], None
        out = []
        for group in groups:
            host = []
            for t in group:
                h = None
                if t is not None:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                host.append(h)
            out.append(host)
        return out, self._event()

    def _event(self):
        """A CUDA event recorded now on the engine's stream, behind
        everything enqueued so far (None off the card)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _restore_state(self, ckpt, init_carries, init_prev, b: int):
        """Device carries and prev_ys from a checkpoint's host leaves,
        poured into the structure of fresh tick-0 carries for batch ``b``;
        shape mismatches fail here, at resume."""
        if ckpt.batch != b:
            raise ValueError(f"checkpoint batch {ckpt.batch} != stimulus "
                             f"batch {b}")
        flat = _carry_leaves(init_carries)
        if len(ckpt.carry_leaves) != len(flat):
            raise ValueError(
                f"checkpoint has {len(ckpt.carry_leaves)} carry leaves, "
                f"engine expects {len(flat)} — different network or "
                "backend")
        leaves = []
        for ref, leaf in zip(flat, ckpt.carry_leaves):
            if tuple(ref.shape) != tuple(np.shape(leaf)):
                raise ValueError(
                    f"checkpoint carry leaf shape {tuple(np.shape(leaf))} "
                    f"!= engine's {tuple(ref.shape)}")
            leaves.append(self._upload(np.asarray(leaf, np.float32)))
        carries, it = [], iter(leaves)
        for c in init_carries:
            vals = [next(it) for _ in c]
            carries.append(type(c)(*vals) if isinstance(c, LasanaState)
                           else tuple(vals))
        if len(ckpt.prev_ys) != len(init_prev):
            raise ValueError(
                f"checkpoint has {len(ckpt.prev_ys)} prev_ys entries, "
                f"engine expects {len(init_prev)}")
        prev_ys = []
        for ref, p in zip(init_prev, ckpt.prev_ys):
            if tuple(ref.shape) != tuple(np.shape(p)):
                raise ValueError(
                    f"checkpoint prev_ys shape {tuple(np.shape(p))} != "
                    f"engine's {tuple(ref.shape)}")
            prev_ys.append(self._upload(p))
        return carries, prev_ys

    def _make_checkpoint(self, leaves, prev, k0: int, chunk_ticks: int,
                         b: int, acc):
        """Freeze one chunk-boundary snapshot into a StreamCheckpoint."""
        from repro_torch.resilience.checkpoint import (StreamCheckpoint,
                                                       spec_key_of)
        return StreamCheckpoint(
            k0=int(k0), chunk_ticks=int(chunk_ticks), batch=int(b),
            spec_key=spec_key_of(self.spec), backend=self.backend,
            mode=self.mode, record_hidden=self.record_hidden,
            carry_leaves=leaves, prev_ys=prev, acc_run=acc.result())

    # --- per-layer state ------------------------------------------------------

    def _init_carry(self, i: int, b: int):
        layer = self.spec.layers[i]
        circ = self.circs[i]
        n = layer.n_circuits(b)
        if layer.circuit == "crossbar":
            segs = self._segs[i]
            params = segs[None].expand(b, *segs.shape).reshape(
                -1, segs.shape[1])
        else:
            params = _tile_params(self._params[i], b, layer.n_out)
        if self.backend == "golden":
            return circ.init_state(n, device=self.device), params
        if self.backend == "behavioral":
            return params.new_zeros((n,)), params
        # lasana: annotation mode keeps the behavioral state in .v
        return init_state(n, params)

    # --- per-layer tick function ------------------------------------------------

    def _lif_tick(self, i: int, slot_records: bool = False):
        """tick(carry, drive, changed, t, bank, pack, layout) -> (carry',
        spikes (B, n), e, l, events): ``drive`` is the combined synaptic
        drive, ``t`` this tick's time (0-d device tensor), ``bank`` the
        layer's Surrogate (lasana only), ``pack``/``layout`` its
        megakernel head pack or None. ``slot_records`` counts events per
        batch slot, (B,) int32, instead of one scalar (rows are
        batch-major)."""
        layer = self.spec.layers[i]
        amp = self.spec.spike_amp
        circ = self.circs[i]
        clock = circ.clock_ns
        n_out = layer.n_out
        backend, mode = self.backend, self.mode
        fused, fused_kernel = self.fused, self.fused_kernel

        def tick(carry, drive, changed, t, bank, pack=None, layout=None):
            xin = drive_to_circuit_inputs(drive, spike_amp=amp).reshape(-1, 3)
            if backend == "golden":
                state, params = carry
                new_state, obs = circ.step(state, xin, params)
                spikes = torch.where(obs["spiked"], amp, 0.0)
                e = obs["energy"]
                l = torch.where(obs["spiked"], obs["latency"], 0.0)
                carry = (new_state, params)
            elif backend == "behavioral":
                v, params = carry
                xin_m = torch.where(changed[:, None], xin, 0.0)
                v_new, out = circ.behavioral_step(v, xin_m, params)
                spikes = out
                e = torch.zeros_like(v)
                l = torch.zeros_like(v)
                carry = (v_new, params)
            elif mode == "annotation":
                xin_m = torch.where(changed[:, None], xin, 0.0)
                v_new, out = circ.behavioral_step(carry.v, xin_m,
                                                  carry.params)
                ns, e, l, _ = lasana_step(bank, carry, changed, xin, t,
                                          clock, spiking=True, vdd=amp,
                                          known_out=out, fused=fused,
                                          fused_kernel=fused_kernel,
                                          megakernel_pack=pack,
                                          megakernel_layout=layout)
                spikes = out
                carry = ns._replace(v=v_new, o=out)
            else:                                           # standalone
                ns, e, l, o = lasana_step(bank, carry, changed, xin, t,
                                          clock, spiking=True, vdd=amp,
                                          fused=fused,
                                          fused_kernel=fused_kernel,
                                          megakernel_pack=pack,
                                          megakernel_layout=layout)
                spikes = torch.where(changed, o, 0.0)
                carry = ns
            spikes = spikes.reshape(-1, n_out)
            ev = (_slot_events(changed, spikes.shape[0]) if slot_records
                  else _count_events(changed))
            return carry, spikes, e, l, ev

        return tick

    def _xbar_tick(self, i: int, slot_records: bool = False):
        """tick(carry, x_volts (B, fan_in), t, bank, pack, layout) ->
        (carry', codes (B, n_out), e, l, events), arguments and
        ``slot_records`` as in :meth:`_lif_tick`.

        Rows are combinational with sample-and-hold inputs: a row segment
        has an input event iff any of its input lines is live (|x| > eps)
        this tick; event-less rows hold their previous settled output."""
        layer = self.spec.layers[i]
        circ = self.circs[i]
        seg_w, n_seg, n_out = layer.seg_width, layer.n_seg, layer.n_out
        pad = n_seg * seg_w - layer.fan_in
        clock = circ.clock_ns
        gain = -circ.r_f * circ.g_unit
        levels = float(2 ** layer.adc_bits - 1)
        v_sat = circ.v_sat
        backend, mode = self.backend, self.mode
        fused, fused_kernel = self.fused, self.fused_kernel

        def tick(carry, x, t, bank, pack=None, layout=None):
            b_l = x.shape[0]
            xs = F.pad(x, (0, pad)).reshape(b_l, 1, n_seg, seg_w)
            # the same segment inputs drive the segment's row of every output
            xin = xs.expand(b_l, n_out, n_seg, seg_w).reshape(-1, seg_w)
            changed = (torch.abs(xs) > _XBAR_EVENT_EPS).any(-1).expand(
                b_l, n_out, n_seg).reshape(-1)
            if backend == "golden":
                state, pall = carry
                _, obs = circ.step(state, xin, pall)
                v = torch.where(changed, obs["output"], state[:, 0])
                e = torch.where(changed, obs["energy"], 0.0)
                l = torch.where(changed, obs["latency"], 0.0)
                carry = (v[:, None], pall)
            elif backend == "behavioral":
                held, pall = carry
                _, settled = circ.behavioral_step(held, xin, pall)
                v = torch.where(changed, settled, held)
                e = torch.zeros_like(v)
                l = torch.zeros_like(v)
                carry = (v, pall)
            else:
                known = None
                if mode == "annotation":
                    _, known = circ.behavioral_step(carry.v, xin,
                                                    carry.params)
                ns, e, l, _ = lasana_step(bank, carry, changed, xin, t,
                                          clock, known_out=known,
                                          fused=fused,
                                          fused_kernel=fused_kernel,
                                          megakernel_pack=pack,
                                          megakernel_layout=layout)
                if known is not None:
                    # the behavioral value is both published output and state
                    ns = ns._replace(v=ns.o)
                carry = ns
                v = ns.o
            # adc_bits ADC over [-v_sat, v_sat], then digital gain comp
            code = torch.round(ops.div(v + v_sat, 2 * v_sat) * levels)
            v_adc = ops.div(code, levels) * 2 * v_sat - v_sat
            y = ops.div(row_sum(v_adc.reshape(-1, n_out, n_seg)), gain)
            ev = (_slot_events(changed, b_l) if slot_records
                  else _count_events(changed))
            return carry, y, e, l, ev

        return tick

    def _flush(self, carry, i: int, t_end_ns: float, bank):
        """Charge trailing-idle static energy (merged E2 to the run end).
        Only stateful lif layers are flushed: combinational
        sample-and-hold crossbar rows charge nothing in the golden
        reference while their inputs are dead."""
        if self.backend != "lasana" or self.spec.layers[i].circuit != "lif":
            return torch.zeros((), device=self.device)
        return self._idle_energy(carry, i, t_end_ns, bank).sum()

    def _idle_energy(self, lst, i: int, t_end_ns, bank):
        """Each lasana circuit's merged E2 static energy from its
        ``t_last`` to ``t_end_ns`` (a float, or a per-circuit tensor);
        zero where that span is empty."""
        tau = t_end_ns - lst.t_last
        feats = torch.cat(
            [lst.v.new_zeros((lst.v.shape[0], self.circs[i].n_inputs)),
             lst.v[:, None], tau[:, None], lst.params], dim=1)
        return torch.where(tau > 0, bank.predict("M_ES", feats), 0.0)

    # --- the graph runner ---------------------------------------------------------

    def _make_cascade(self, slot_records: bool = False):
        """``cascade(banks, carries, prev_ys, u_in, ts_k, packs, live) ->
        (new_carries, new_ys, e (L,), l (L,), events (L,) int32)``: one
        network tick. ``prev_ys`` are the layers' outputs of the previous
        tick, which the one-tick-delayed edges deliver.

        ``slot_records=True`` is the continuous-batching variant behind
        :meth:`slot_programs`: the records stay per batch slot — ``(L, B)``
        instead of ``(L,)`` — and ``live`` (B,) bool freezes the slots
        that are not live this tick: their LIF event detection is forced
        off and their crossbar input volts are zeroed after the clamp, so
        a dead or empty slot processes no event, charges no energy and
        holds its carry."""
        spec = self.spec
        amp = spec.spike_amp
        kinds = spec.circuits
        ticks = [self._lif_tick(i, slot_records) if kinds[i] == "lif"
                 else self._xbar_tick(i, slot_records)
                 for i in range(spec.n_layers)]
        act = lambda i: "tanh" if i is None else spec.layers[i].activation

        def cascade(banks, carries, prev_ys, u_in, ts_k, packs, live=None):
            bsz = u_in.shape[0]
            cur, src_kind, src = u_in, "input", None
            new_carries, new_ys, es, ls, evs = [], [], [], [], []
            for i in range(spec.n_layers):
                pk, ly = packs.get(kinds[i], (None, None))
                bank = banks.get(kinds[i])
                if kinds[i] == "lif":
                    with trace.span("layer.drive"):
                        # feed-forward + delayed-edge synaptic drive
                        u = adapt_signal(src_kind, "lif", cur, spike_amp=amp,
                                         activation=act(src))
                        drive = ops.div(u @ self._weights[i], amp)
                        pre = (torch.abs(u)
                               > event_threshold(src_kind, amp)).float()
                        incoming = (pre @ self._conn[i]) > 0.5
                        for j, we, conn in self._rec[i]:
                            ur = adapt_signal(kinds[j], "lif", prev_ys[j],
                                              spike_amp=amp,
                                              activation=act(j))
                            drive = drive + ops.div(ur @ we, amp)
                            pr = (torch.abs(ur)
                                  > event_threshold(kinds[j], amp)).float()
                            incoming = incoming | ((pr @ conn) > 0.5)
                        if live is not None:
                            incoming = incoming & live[:, None]
                    with trace.span("layer.step"):
                        carry, y, e, l, ev = ticks[i](
                            carries[i], drive, incoming.reshape(-1),
                            ts_k[i], bank, pk, ly)
                else:
                    circ = self.circs[i]
                    with trace.span("layer.drive"):
                        xv = adapt_signal(src_kind, "crossbar", cur,
                                          spike_amp=amp, activation=act(src))
                        for j, we, _ in self._rec[i]:
                            xv = xv + adapt_signal(
                                kinds[j], "crossbar", prev_ys[j],
                                spike_amp=amp, activation=act(j)) @ we
                        xv = torch.clamp(xv, circ.input_lo, circ.input_hi)
                        if live is not None:
                            xv = torch.where(live[:, None], xv, 0.0)
                    with trace.span("layer.step"):
                        carry, y, e, l, ev = ticks[i](carries[i], xv,
                                                      ts_k[i], bank, pk, ly)
                new_carries.append(carry)
                new_ys.append(y)
                if slot_records:       # per-tenant attribution: per slot
                    es.append(e.reshape(bsz, -1).sum(1))
                    ls.append(l.reshape(bsz, -1).amax(1))
                else:
                    es.append(e.sum())
                    ls.append(l.max())
                evs.append(ev)
                cur, src_kind, src = y, kinds[i], i
            return (new_carries, new_ys, torch.stack(es), torch.stack(ls),
                    torch.stack(evs))

        return cascade

    def _mk_pack(self, banks):
        """``{kind: (pack, PackLayout)}`` for the megakernel tick: empty
        unless the lasana fused path runs with the kernel switch on. One
        cross-kind ``pack_library`` pack when every kind packs; otherwise
        the kinds that pack get their own packs and the rest take the
        stacked-dispatch tick."""
        if self.backend != "lasana" or not self.fused:
            return {}
        if not ops.fused_kernel_enabled(self.fused_kernel):
            return {}
        from repro_torch.kernels import tick_megakernel as mk
        pack, layouts = mk.pack_library(banks)
        if pack is not None:
            return {kind: (pack, lo) for kind, lo in layouts.items()}
        packs = {}
        for kind in banks.kinds():
            p, lo = mk.pack_heads(banks[kind])
            if p is not None:
                packs[kind] = (p, lo)
        return packs

    def _chunk_eligible(self, pack_layout=None) -> bool:
        """Whether :meth:`_chunk_fast_path` can replace the per-tick loop:
        a single-LIF-layer standalone lasana graph with no delayed edges
        (the only tick-to-tick dataflow is then the LIF carry, which the
        time-looped kernel owns). Given the layer's ``(pack, layout)``,
        also whether the chunk kernel takes that pack: where it does not,
        the per-tick loop launches ``network_tick`` once a tick, which a
        chunk equals bit for bit."""
        spec = self.spec
        graph = (self.backend == "lasana" and self.mode == "standalone"
                 and self.fused and spec.n_layers == 1
                 and spec.circuits == ("lif",) and not spec.edges)
        if pack_layout is None or not graph:
            return graph
        from repro_torch.kernels import tick_megakernel as mk
        return mk.pack_chunk_takes("lif", pack_layout[0])

    def _golden_chunk_eligible(self) -> bool:
        """Whether :meth:`_golden_chunk` can replace the per-tick loop: a
        golden single-LIF-layer graph with no delayed edges. Golden LIF
        steps every neuron every tick, ungated by events, so a chunk is T
        chained periods — one ``lif_chunk`` launch."""
        spec = self.spec
        return (self.backend == "golden" and spec.n_layers == 1
                and spec.circuits == ("lif",) and not spec.edges)

    def _chunk_inputs(self, x, live=None):
        """``(changed (T, N) bool, LIF inputs (T, N, 3))`` of a one-LIF-layer
        graph over a chunk ``x`` (T, B, fan_in). Event detection is one
        product over the chunk, exact in any order (sums of 0/1 terms);
        the synaptic drive, a float sum whose rounding follows the
        product's blocking, is computed tick by tick at the per-tick
        path's shape, so every chunk size gives the same bits. ``live``
        (T, B) bool, the slot programs' mask, turns off the events of the
        slots that are not live."""
        amp = self.spec.spike_amp
        t_steps = x.shape[0]
        drive = torch.stack([ops.div(u @ self._weights[0], amp) for u in x])
        pre = (torch.abs(x) > event_threshold("input", amp)).float()
        changed = (pre @ self._conn[0]) > 0.5
        if live is not None:
            changed = changed & live[:, :, None]
        changed = changed.reshape(t_steps, -1)
        xin = drive_to_circuit_inputs(drive, spike_amp=amp)
        return changed, xin.reshape(t_steps, -1, 3)

    def _chunk_records(self, carry, spikes, e_seq, l_seq, changed,
                       slots: bool = False):
        """A time-looped chunk's per-tick records, reduced as the per-tick
        path reduces each tick: the energy of tick k is the sum of a fresh
        (N,) tensor (a row of the chunk that sits at another alignment is
        copied first: a CUDA reduction's order follows the alignment).
        ``slots`` keeps them per batch slot, ``(T, 1, B)``, as the slot
        cascade does."""
        hidden = [spikes] if self.record_hidden else []
        if slots:
            t_steps, b = spikes.shape[:2]
            per = lambda a: a.reshape(t_steps, b, -1)
            return ([carry], [spikes[-1]], spikes, hidden,
                    per(e_seq).sum(-1)[:, None], per(l_seq).amax(-1)[:, None],
                    per(changed).sum(-1, dtype=torch.int32)[:, None])
        aligned = e_seq.device.type == "cpu" or e_seq.shape[1] % 4 == 0
        es = torch.stack([(r if aligned else r.clone()).sum() for r in e_seq])
        out = (spikes, hidden, es[:, None], l_seq.amax(1)[:, None],
               changed.sum(1, dtype=torch.int32)[:, None])
        return [carry], [spikes[-1]], *out

    def _chunk_fast_path(self, pack_layout, carries, x, ks, live=None):
        """The whole chunk as ONE ``network_tick_chunk`` launch; returns
        what :meth:`_run_ticks` returns (per slot under a ``live``
        mask)."""
        from repro_torch.kernels.tick_megakernel import megakernel_chunk
        layer = self.spec.layers[0]
        amp = self.spec.spike_amp
        clock = self.circs[0].clock_ns
        pack, layout = pack_layout
        t_steps, b = x.shape[0], x.shape[1]
        with trace.span("layer.drive"):
            changed, xin = self._chunk_inputs(x, live)
        with trace.span("layer.step"):
            new_state, o_seq, e_seq, l_seq = megakernel_chunk(
                pack, layer.circuit, carries[0], changed, xin,
                (ks + 1.0) * clock, clock, spiking=True, vdd=amp,
                layout=layout)
        spikes = torch.where(changed, o_seq, 0.0
                             ).reshape(t_steps, b, layer.n_out)
        return self._chunk_records(new_state, spikes, e_seq, l_seq, changed,
                                   slots=live is not None)

    def _golden_chunk(self, carries, x):
        """The whole golden chunk as ONE ``lif_chunk`` launch over the
        chunk's circuit inputs; spikes, energy, latency and events as
        :meth:`_lif_tick`'s golden branch derives them."""
        layer = self.spec.layers[0]
        amp = self.spec.spike_amp
        t_steps, b = x.shape[0], x.shape[1]
        with trace.span("layer.drive"):
            changed, xin = self._chunk_inputs(x)
        state, params = carries[0]
        with trace.span("layer.step"):
            new_state, obs = ops.lif_chunk(state, xin, params,
                                           circ=self.circs[0])
        spiked = obs["spiked"]
        spikes = torch.where(spiked, amp, 0.0).reshape(t_steps, b,
                                                       layer.n_out)
        l_seq = torch.where(spiked, obs["latency"], 0.0)
        return self._chunk_records((new_state, params), spikes,
                                   obs["energy"], l_seq, changed)

    def _run_ticks(self, cascade, banks, carries, prev_ys, x, ks, live=None):
        """Advance the graph over one block of ticks ``x`` (T, B, fan_in)
        with global tick indices ``ks`` (T,) f32. Returns ``(carries,
        prev_ys, out_seq (T, B, n_last), hidden, e (T, L), l (T, L),
        events (T, L))``. The megakernel head packs are built here, once
        per block; eligible one-LIF-layer graphs take a time-looped
        kernel instead of the per-tick loop. ``live`` (T, B) bool is the
        slot programs' mask (with a ``slot_records`` cascade): the records
        are then ``(T, L, B)``."""
        with trace.span("engine.pack"):
            packs = self._mk_pack(banks)
        if "lif" in packs and self._chunk_eligible(packs["lif"]):
            with trace.span("chunk"):
                return self._chunk_fast_path(packs["lif"], carries, x, ks,
                                             live)
        if self._golden_chunk_eligible():
            with trace.span("chunk"):
                return self._golden_chunk(carries, x)
        ts = [(ks + 1.0) * c.clock_ns for c in self.circs]
        outs, hidden, es, ls, evs = [], [], [], [], []
        for k in range(x.shape[0]):
            with trace.span("tick"):
                carries, prev_ys, e, l, ev = cascade(
                    banks, carries, prev_ys, x[k], [t[k] for t in ts], packs,
                    None if live is None else live[k])
            outs.append(prev_ys[-1])
            if self.record_hidden:
                hidden.append(prev_ys)
            es.append(e)
            ls.append(l)
            evs.append(ev)
        hid = [torch.stack([h[i] for h in hidden])
               for i in range(self.spec.n_layers)] if self.record_hidden \
            else []
        return (carries, prev_ys, torch.stack(outs), hid, torch.stack(es),
                torch.stack(ls), torch.stack(evs))

    def _primary(self, out_seq):
        """The last layer's spike counts (lif) or its final codes."""
        if self.spec.circuits[-1] == "lif":
            return (out_seq > 0.5 * self.spec.spike_amp).sum(
                0, dtype=torch.int32)
        return out_seq[-1]

    def _flush_all(self, carries, t_ends, banks):
        kinds = self.spec.circuits
        with trace.span("engine.flush"):
            return torch.stack([
                self._flush(carries[i], i, t_ends[i], banks.get(kinds[i]))
                for i in range(self.spec.n_layers)])

    def _build_sim(self, b: int, t_steps: int):
        """The runner for batch ``b`` and ``t_steps`` ticks: ``runner(x,
        carries, banks)`` enqueues every tick and returns device tensors
        ``(primary, out_seq, hidden, e, l, events, flush)``; ``primary`` is
        the last layer's spike counts (lif) or its final codes (crossbar)."""
        spec = self.spec
        cascade = self._make_cascade()
        ks = torch.arange(t_steps, dtype=torch.float32, device=self.device)
        t_ends = [_t_end(t_steps, c) for c in self.circs]

        def runner(x, carries, banks):
            prev_ys = [x.new_zeros((b, l.n_out)) for l in spec.layers]
            carries, _, out_seq, hid, e, l, ev = self._run_ticks(
                cascade, banks, carries, prev_ys, x, ks)
            return (self._primary(out_seq), out_seq, hid, e, l, ev,
                    self._flush_all(carries, t_ends, banks))

        return runner

    def _build_stream_step(self, t_steps: int):
        """The chunk runner of the stream: ``step(x, k0, carries, prev_ys,
        banks)`` runs ``t_steps`` ticks from global tick ``k0`` and returns
        ``(primary, out_seq, hidden, e, l, events, carries, prev_ys)``,
        ``primary`` reduced over this chunk only (spike counts, or the last
        tick's codes) so that :class:`StreamingRun` merges exactly. The
        caller's carries and surrogates are read, never written."""
        cascade = self._make_cascade()
        base = torch.arange(t_steps, dtype=torch.float32, device=self.device)

        def step(x, k0, carries, prev_ys, banks):
            ks = base + float(k0)           # exact: integers below 2^24
            carries, prev_ys, out_seq, hid, e, l, ev = self._run_ticks(
                cascade, banks, carries, prev_ys, x, ks)
            return (self._primary(out_seq), out_seq, hid, e, l, ev,
                    carries, prev_ys)

        return step

    def _build_flush(self):
        """The end-of-stream flush runner: ``flush_fn(carries, t_ends,
        banks) -> (L,)``, the trailing idle static energy from the final
        carries with per-layer run-end times ``t_ends`` — the monolithic
        runner's flush, applied once at the true end of the stream."""
        return self._flush_all

    # --- continuous-batching slot programs (the serving layer) ----------------

    def _build_slot_step(self, b: int, chunk_ticks: int):
        """The slot-masked chunk runner of continuous batching:
        ``step(x, k0, end_ks, carries, prev_ys, banks)`` is the stream's
        chunk runner with two serving extensions.

          * ``end_ks`` (b,) f32 on the device — each slot's global end
            tick: at tick ``k`` only slots with ``k < end_ks[slot]`` are
            live, a comparison made on the device. Dead slots (request
            finished mid-chunk, or seat empty) are frozen by the cascade's
            ``live`` mask, so one runner serves every mix of request
            lengths.
          * per-slot records — energy and latency ``(T, L, b)`` and event
            counts ``(T, L, b)`` int32, so that the scheduler can slice
            each tenant's rows out of the shared batch.

        ``k0`` is the chunk's first global tick (a Python number or a 0-d
        tensor). Returns ``(primary, out_seq, hidden, e, l, events,
        carries, prev_ys, banks)``; the caller's carries are read, never
        written, and nothing synchronises with the host."""
        cascade = self._make_cascade(slot_records=True)
        base = torch.arange(chunk_ticks, dtype=torch.float32,
                            device=self.device)

        def step(x, k0, end_ks, carries, prev_ys, banks):
            ks = base + k0                  # exact: integers below 2^24
            live = ks[:, None] < end_ks[None, :]
            carries, prev_ys, out_seq, hid, e, l, ev = self._run_ticks(
                cascade, banks, carries, prev_ys, x, ks, live)
            return (self._primary(out_seq), out_seq, hid, e, l, ev,
                    carries, prev_ys, banks)

        return step

    def _build_slot_flush(self, b: int):
        """The per-slot leave-time flush: ``flush(carries, t_ends (L, b),
        banks) -> (L, b)`` is :meth:`_flush` with a per-layer per-slot end
        time (f32, layer-native clocks) and per-slot energy sums. It reads
        the carries and never writes them; a slot whose end time is not
        past its ``t_last`` (tau <= 0, e.g. every slot of a request not
        leaving) charges exactly zero."""
        spec = self.spec
        kinds = spec.circuits

        def flush(carries, t_ends, banks):
            rows = []
            for i, layer in enumerate(spec.layers):
                if self.backend != "lasana" or kinds[i] == "crossbar":
                    rows.append(t_ends.new_zeros((b,)))
                    continue
                t_end = t_ends[i].repeat_interleave(layer.n_circuits(b) // b)
                e = self._idle_energy(carries[i], i, t_end,
                                      banks.get(kinds[i]))
                rows.append(e.reshape(b, -1).sum(1))
            return torch.stack(rows)

        return flush

    def _build_slot_join(self, b: int):
        """The masked slot (re)initialisation: ``join(carries, prev_ys,
        mask (b,) bool, g0) -> (carries, prev_ys)`` resets the masked slots
        to a request start at global tick ``g0`` (a 0-d f32 tensor on the
        device): carries back to :meth:`_init_carry`, published outputs
        zeroed and — lasana — ``t_last = g0 * clock`` in each layer's own
        clock. Time enters the surrogate features only through ``tau = t -
        t_last``, so a request seated at ``g0`` sees the tau sequence of a
        request started at tick 0. Unmasked slots pass through unchanged."""
        spec = self.spec
        inits = [self._init_carry(i, b) for i in range(spec.n_layers)]
        n_per = [l.n_circuits(b) // b for l in spec.layers]

        def join(carries, prev_ys, mask, g0):
            new_carries, new_prev = [], []
            for i, (init, old) in enumerate(zip(inits, carries)):
                m = mask.repeat_interleave(n_per[i])
                leaves = [torch.where(m.reshape(-1, *[1] * (o.dim() - 1)),
                                      n, o) for n, o in zip(init, old)]
                if isinstance(old, LasanaState):
                    carry = LasanaState(*leaves)
                    carry = carry._replace(t_last=torch.where(
                        m, g0 * self.circs[i].clock_ns, carry.t_last))
                else:
                    carry = tuple(leaves)
                new_carries.append(carry)
                new_prev.append(torch.where(mask[:, None], 0.0, prev_ys[i]))
            return new_carries, new_prev

        return join

    def slot_programs(self, b: int, chunk_ticks: int,
                      surrogates=None) -> SlotPrograms:
        """Build (or fetch) the continuous-batching runners of one bucket.

        One :class:`SlotPrograms` per (``b``, ``chunk_ticks``, surrogate
        structure). The scheduler owns the calling protocol: ``join``
        seats joining requests, ``step`` advances all live slots one
        chunk, ``flush`` charges leavers' trailing idle energy. The
        runners are cached in the engine (only ``step`` counts toward
        :attr:`compile_count`) and take surrogates as arguments, so
        same-structure hot swaps and co-resident surrogate versions share
        them. ``golden`` is refused: its stepping is far off serving
        latencies; ``behavioral`` is the serving layer's fallback."""
        if self.backend not in ("lasana", "behavioral"):
            raise ValueError("slot_programs requires backend='lasana' or "
                             f"'behavioral' (got {self.backend!r})")
        if self.mesh is not None:
            raise ValueError("slot_programs does not support mesh "
                             "sharding yet")
        if chunk_ticks <= 0:
            raise ValueError(f"chunk_ticks must be positive: {chunk_ticks}")
        banks = self._runtime_banks(surrogates)
        step, cs_step = self._compiled(
            self._program_key("slot", b, chunk_ticks, banks),
            lambda: self._build_slot_step(b, chunk_ticks))
        flush, cs_flush = self._compiled(
            self._program_key("slotflush", b, None, banks),
            lambda: self._build_slot_flush(b))
        join, cs_join = self._compiled(
            self._program_key("slotjoin", b, None, banks),
            lambda: self._build_slot_join(b))
        # a lane's first step must build nothing: the kernel libraries its
        # routes launch are built (or loaded) here, with the runners
        cs_libs = self._load_libraries(banks)
        return SlotPrograms(step=step, flush=flush, join=join,
                            compile_seconds=(cs_step + cs_flush + cs_join
                                             + cs_libs))

    def _load_libraries(self, banks) -> float:
        """Build (or load) the kernel libraries this engine's routes launch
        with ``banks`` when it runs on the card, so that no run or shard
        builds one; the seconds it took when anything loaded, else 0."""
        if self.device.type != "cuda" and not any(
                e.device.type == "cuda" for e in self._replicas.values()):
            return 0.0
        from repro_torch.kernels import _build
        t0, loaded = time.perf_counter(), _build.n_loaded()
        for name in self._route_libraries(banks):
            _build.library(name)
        return (time.perf_counter() - t0 if _build.n_loaded() != loaded
                else 0.0)

    def _check_mesh_batch(self, b: int):
        if self.mesh is not None and b % self.mesh.size:
            raise ValueError(f"batch {b} not divisible by mesh size "
                             f"{self.mesh.size}")

    def _sharded(self, build, b: int, banks, in_specs, out_specs):
        """``build(engine, batch)`` — the unsharded runner — or, with a
        mesh, that runner built by each shard device's engine at the
        shard's batch and wrapped by ``shard_over_batch``: the caller
        passes and gets back whole-batch tensors on :attr:`device`. A
        shard's kernel libraries load here, before its first launch."""
        if self.mesh is None:
            return build(self, b)
        from repro_torch.core.distributed import shard_over_batch
        self._load_libraries(banks)
        bl = b // self.mesh.size
        bodies = {str(self.device): build(self, bl)}
        for key, eng in self._replicas.items():
            bodies[key] = build(eng, bl)
        return shard_over_batch(bodies, self.mesh, in_specs, out_specs)

    def _route_libraries(self, banks) -> tuple:
        """The kernel libraries (``csrc/`` sources) a tick of this engine
        launches with ``banks`` on the card, sorted: ``network_tick``
        where a kind's heads pack (one tick or chunk kernel), and
        ``mlp_heads`` where a kind that does not pack has MLP heads (the
        stacked-dispatch tick's ``mlp_surrogate_heads``). Empty off the
        lasana kernel path."""
        packs = self._mk_pack(banks)
        libs = {"network_tick"} if packs else set()
        if self.backend == "lasana" and self.fused \
                and ops.fused_kernel_enabled(self.fused_kernel):
            for kind in banks.kinds():
                if kind not in packs and any(
                        fam == "mlp"
                        for _, fam in banks[kind].manifest.families):
                    libs.add("mlp_heads")
        return tuple(sorted(libs))

    def _program_key(self, kind: str, b: int, t_steps, banks) -> tuple:
        """Runner cache key: the kind (``"mono"``, ``"stream"``,
        ``"flush"``, ``"slot"``, ``"slotflush"``, ``"slotjoin"``), shapes,
        the ``fused`` flag, the resolved fused-kernel switch and the
        surrogate structure — a retrained surrogate of equal structure is
        a weight swap, not a rebuild."""
        return (kind, self.fused, ops.fused_kernel_enabled(self.fused_kernel),
                b, t_steps, structure_key(banks))

    def _compiled(self, key, build, span_id=None):
        """``(runner, build_seconds)``; builds once per key (0.0 on a hit).
        Tick-loop runners (``mono``, ``stream``, ``slot``) count toward
        :attr:`compile_count`; the flush and join helpers do not.
        ``span_id`` is the id of the build's trace span (a stream's chunk
        index; a dispatch's spans pass theirs down)."""
        entry = self._runners.get(key)
        if entry is not None:
            return entry, 0.0
        with self._lock:
            entry = self._runners.get(key)
            if entry is not None:
                return entry, 0.0
            with trace.span("engine.build", span_id):
                t0 = time.perf_counter()
                runner = build()
                self._runners[key] = runner
                if key[0] in ("mono", "stream", "slot"):
                    self.compile_count += 1
            trace.count("runner.builds")
        return runner, time.perf_counter() - t0


def _carry_leaves(carries) -> list:
    """The carries' tensors in the reference's pytree flatten order: layer
    by layer, ``(state, params)`` (golden), ``(v, params)`` (behavioral)
    or ``LasanaState(v, o, t_last, params)`` (lasana)."""
    return [leaf for c in carries for leaf in c]
