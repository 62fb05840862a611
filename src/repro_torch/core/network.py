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

Streaming comes with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
        """Merge consecutive per-chunk records into one whole-run record:
        spike counts sum (a crossbar last layer keeps the last chunk's
        codes), per-tick records concatenate, flushes add (only a stream's
        final chunk carries one), wall/compile seconds sum."""
        chunks = list(chunks)
        if not chunks:
            raise ValueError("NetworkRun.merge needs at least one record")
        first = chunks[0]
        for c in chunks[1:]:
            if (c.backend, c.mode, c.circuits) != (
                    first.backend, first.mode, first.circuits):
                raise ValueError("cannot merge chunks from different runs: "
                                 f"{c.backend}/{c.mode} vs "
                                 f"{first.backend}/{first.mode}")
        cat = lambda f: np.concatenate([getattr(c, f) for c in chunks])
        hidden = None
        if first.layer_spikes is not None:
            hidden = [np.concatenate([c.layer_spikes[i] for c in chunks])
                      for i in range(len(first.layer_spikes))]
        if first.circuits and first.circuits[-1] != "lif":
            outputs, out_spikes = chunks[-1].outputs, None
        else:
            outputs = sum(np.asarray(c.outputs, np.int64) for c in chunks
                          ).astype(first.outputs.dtype)
            out_spikes = cat("out_spikes")
        return cls(
            backend=first.backend, mode=first.mode, outputs=outputs,
            out_spikes=out_spikes, layer_spikes=hidden,
            energy=cat("energy"), latency=cat("latency"),
            events=cat("events"),
            flush_energy=sum(c.flush_energy for c in chunks),
            n_circuits=first.n_circuits, clock_ns=first.clock_ns,
            wall_seconds=sum(c.wall_seconds for c in chunks),
            circuits=first.circuits,
            compile_seconds=sum(c.compile_seconds for c in chunks))


class PendingRun:
    """A run enqueued on the device: its records are device tensors until
    :meth:`result` waits for them and builds the :class:`NetworkRun`."""

    def __init__(self, engine, b, t0, compile_s, out):
        self._engine, self._b, self._t0 = engine, b, t0
        self._compile_s, self._out = compile_s, out

    def result(self) -> NetworkRun:
        eng, spec = self._engine, self._engine.spec
        primary, out_seq, hidden, e_tl, l_tl, ev_tl, flush = self._out
        to_np = lambda a: a.cpu().numpy()
        outputs = to_np(primary)          # the first fetch waits for the run
        run = NetworkRun(
            backend=eng.backend, mode=eng.mode, outputs=outputs,
            out_spikes=(to_np(out_seq) if spec.circuits[-1] == "lif"
                        else None),
            layer_spikes=[to_np(h) for h in hidden]
            if eng.record_hidden else None,
            energy=to_np(e_tl), latency=to_np(l_tl),
            events=to_np(ev_tl).astype(np.int64), flush_energy=to_np(flush),
            n_circuits=np.asarray([l.n_circuits(self._b)
                                   for l in spec.layers]),
            clock_ns=eng.clock_ns, wall_seconds=time.time() - self._t0,
            circuits=spec.circuits, compile_seconds=self._compile_s)
        return run


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
    device    where the engine runs (default ``cuda``; see
              ``ops.resolve_device``)
    """

    def __init__(self, spec: NetworkSpec, backend: str = "lasana", *,
                 surrogates=None, mode: str = "standalone",
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
        self.compile_count = 0        # distinct runners built

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
        on the device stay there)."""
        x = torch.as_tensor(inputs, dtype=torch.float32, device=self.device)
        if x.dim() == 2:
            x = x[None]
        if x.shape[-1] != self.spec.layers[0].fan_in:
            raise ValueError(f"input width {x.shape[-1]} != layer-0 fan_in "
                             f"{self.spec.layers[0].fan_in}")
        t_steps, b, _ = x.shape
        banks = self._runtime_banks(surrogates)
        key = self._program_key("mono", b, t_steps, banks)
        runner, compile_s = self._compiled(
            key, lambda: self._build_sim(b, t_steps))
        t0 = time.time()
        carries = [self._init_carry(i, b) for i in range(self.spec.n_layers)]
        return PendingRun(self, b, t0, compile_s, runner(x, carries, banks))

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

    def _lif_tick(self, i: int):
        """tick(carry, drive, changed, t, bank, pack, layout) -> (carry',
        spikes (B, n), e, l, events): ``drive`` is the combined synaptic
        drive, ``t`` this tick's time (0-d device tensor), ``bank`` the
        layer's Surrogate (lasana only), ``pack``/``layout`` its
        megakernel head pack or None."""
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
            return carry, spikes.reshape(-1, n_out), e, l, \
                _count_events(changed)

        return tick

    def _xbar_tick(self, i: int):
        """tick(carry, x_volts (B, fan_in), t, bank, pack, layout) ->
        (carry', codes (B, n_out), e, l, events), arguments as in
        :meth:`_lif_tick`.

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
            return carry, y, e, l, _count_events(changed)

        return tick

    def _flush(self, carry, i: int, t_end_ns: float, bank):
        """Charge trailing-idle static energy (merged E2 to the run end).
        Only stateful lif layers are flushed: combinational
        sample-and-hold crossbar rows charge nothing in the golden
        reference while their inputs are dead."""
        if self.backend != "lasana" or self.spec.layers[i].circuit != "lif":
            return torch.zeros((), device=self.device)
        circ = self.circs[i]
        lst = carry
        tau = t_end_ns - lst.t_last
        feats = torch.cat(
            [lst.v.new_zeros((lst.v.shape[0], circ.n_inputs)),
             lst.v[:, None], tau[:, None], lst.params], dim=1)
        e = bank.predict("M_ES", feats)
        return torch.where(tau > 0, e, 0.0).sum()

    # --- the graph runner ---------------------------------------------------------

    def _make_cascade(self):
        """``cascade(banks, carries, prev_ys, u_in, ts_k, packs) ->
        (new_carries, new_ys, e (L,), l (L,), events (L,) int32)``: one
        network tick. ``prev_ys`` are the layers' outputs of the previous
        tick, which the one-tick-delayed edges deliver."""
        spec = self.spec
        amp = spec.spike_amp
        kinds = spec.circuits
        ticks = [self._lif_tick(i) if kinds[i] == "lif"
                 else self._xbar_tick(i) for i in range(spec.n_layers)]
        act = lambda i: "tanh" if i is None else spec.layers[i].activation

        def cascade(banks, carries, prev_ys, u_in, ts_k, packs):
            cur, src_kind, src = u_in, "input", None
            new_carries, new_ys, es, ls, evs = [], [], [], [], []
            for i in range(spec.n_layers):
                pk, ly = packs.get(kinds[i], (None, None))
                bank = banks.get(kinds[i])
                if kinds[i] == "lif":
                    # feed-forward + delayed-edge synaptic drive
                    u = adapt_signal(src_kind, "lif", cur, spike_amp=amp,
                                     activation=act(src))
                    drive = ops.div(u @ self._weights[i], amp)
                    pre = (torch.abs(u)
                           > event_threshold(src_kind, amp)).float()
                    incoming = (pre @ self._conn[i]) > 0.5
                    for j, we, conn in self._rec[i]:
                        ur = adapt_signal(kinds[j], "lif", prev_ys[j],
                                          spike_amp=amp, activation=act(j))
                        drive = drive + ops.div(ur @ we, amp)
                        pr = (torch.abs(ur)
                              > event_threshold(kinds[j], amp)).float()
                        incoming = incoming | ((pr @ conn) > 0.5)
                    carry, y, e, l, ev = ticks[i](
                        carries[i], drive, incoming.reshape(-1), ts_k[i],
                        bank, pk, ly)
                else:
                    circ = self.circs[i]
                    xv = adapt_signal(src_kind, "crossbar", cur,
                                      spike_amp=amp, activation=act(src))
                    for j, we, _ in self._rec[i]:
                        xv = xv + adapt_signal(
                            kinds[j], "crossbar", prev_ys[j], spike_amp=amp,
                            activation=act(j)) @ we
                    xv = torch.clamp(xv, circ.input_lo, circ.input_hi)
                    carry, y, e, l, ev = ticks[i](carries[i], xv, ts_k[i],
                                                  bank, pk, ly)
                new_carries.append(carry)
                new_ys.append(y)
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

    def _build_sim(self, b: int, t_steps: int):
        """The runner for batch ``b`` and ``t_steps`` ticks: ``runner(x,
        carries, banks)`` enqueues every tick and returns device tensors
        ``(primary, out_seq, hidden, e, l, events, flush)``; ``primary`` is
        the last layer's spike counts (lif) or its final codes (crossbar)."""
        spec = self.spec
        amp = spec.spike_amp
        kinds = spec.circuits
        cascade = self._make_cascade()
        record_hidden = self.record_hidden
        dev = self.device
        # t = (k + 1) * clock in f32, per layer clock, computed once
        ks = torch.arange(t_steps, dtype=torch.float32, device=dev)
        ts = [(ks + 1.0) * c.clock_ns for c in self.circs]
        t_ends = [t_steps * c.clock_ns for c in self.circs]

        def runner(x, carries, banks):
            packs = self._mk_pack(banks)
            prev_ys = [x.new_zeros((b, l.n_out)) for l in spec.layers]
            outs, hidden, es, ls, evs = [], [], [], [], []
            for k in range(t_steps):
                carries, prev_ys, e, l, ev = cascade(
                    banks, carries, prev_ys, x[k], [t[k] for t in ts], packs)
                outs.append(prev_ys[-1])
                if record_hidden:
                    hidden.append(prev_ys)
                es.append(e)
                ls.append(l)
                evs.append(ev)
            out_seq = torch.stack(outs)
            if kinds[-1] == "lif":
                primary = (out_seq > 0.5 * amp).sum(0, dtype=torch.int32)
            else:
                primary = out_seq[-1]
            hid = [torch.stack([h[i] for h in hidden])
                   for i in range(spec.n_layers)] if record_hidden else []
            flush = torch.stack([
                self._flush(carries[i], i, t_ends[i], banks.get(kinds[i]))
                for i in range(spec.n_layers)])
            return (primary, out_seq, hid, torch.stack(es), torch.stack(ls),
                    torch.stack(evs), flush)

        return runner

    def _program_key(self, kind: str, b: int, t_steps, banks) -> tuple:
        """Runner cache key: shapes, the ``fused`` flag, the resolved
        fused-kernel switch and the surrogate structure — a retrained
        surrogate of equal structure is a weight swap, not a rebuild."""
        return (kind, self.fused, ops.fused_kernel_enabled(self.fused_kernel),
                b, t_steps, structure_key(banks))

    def _compiled(self, key, build):
        """``(runner, build_seconds)``; builds once per key (0.0 on a hit)."""
        entry = self._runners.get(key)
        if entry is not None:
            return entry, 0.0
        with self._lock:
            entry = self._runners.get(key)
            if entry is not None:
                return entry, 0.0
            t0 = time.time()
            runner = build()
            self._runners[key] = runner
            self.compile_count += 1
        return runner, time.time() - t0
