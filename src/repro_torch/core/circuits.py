"""Golden transient circuit models — the SPICE stand-in.

Port of ``repro.core.circuits``: the same physical constants and the same
fp32 arithmetic in the same order. ``LIFNeuron.step`` integrates one
digital clock period through ``ops.lif_step`` and ``CrossbarRow.step``
through ``ops.crossbar_step`` — each the hand-written CUDA kernel on a
CUDA tensor, its plain PyTorch version on a CPU tensor.

Row reductions (the crossbar's ``w . x`` and its power sums) run in index
order, one rounding per term: that is the order in which the reference's
XLA-CPU reductions sum a 32-wide row, and the order the kernels use.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


def row_sum(a):
    """Sum over the last axis in index order: ``((a0 + a1) + a2) + ...``."""
    acc = a[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k]
    return acc


def _gen_device(gen, device):
    """The device the testbench draws land on: the generator's own unless
    given (torch refuses a generator on another device)."""
    return gen.device if device is None else device


def _uniform(gen, shape, device, lo, hi):
    """fp32 uniform draws in [lo, hi) from ``gen``."""
    u = torch.rand(shape, generator=gen, device=device)
    return u * (hi - lo) + lo


@dataclasses.dataclass(frozen=True)
class CrossbarRow:
    """One n-input differential PCM crossbar row driving a TIA (cf. [3]).

    inputs  x[i] in [-0.8, 0.8] V
    params  w[i] in {-1, 0, 1} (n weights + 1 bias row)
    state   none (combinational + output pole); state feature is 0
    output  V_out in [-2, 2] V
    """

    n_inputs: int = 32
    clock_ns: float = 4.0            # 250 MHz digital clock
    n_substeps: int = 64
    g_unit: float = 12e-6            # PCM on-conductance per pair (S)
    g_leak: float = 1e-6             # parasitic leak per column (S)
    r_f: float = 40e3                # TIA feedback (ohm)
    v_sat: float = 2.0               # output saturation (V)
    c_load: float = 500e-15          # load capacitance (F)
    tau_base_ns: float = 0.15        # output pole (ns); t90 ~ 2.3*tau
    v_bias: float = 0.8              # bias row drive voltage
    vdd: float = 1.2                 # supply for the TIA stage

    @property
    def n_params(self) -> int:
        return self.n_inputs + 1

    @property
    def input_lo(self):
        return -0.8

    @property
    def input_hi(self):
        return 0.8

    def sample_params(self, gen, n, device=None):
        """Random row weights and bias in {-1, 0, 1}, (n, n_params), drawn
        from ``gen`` (a ``torch.Generator`` on ``device``)."""
        return torch.randint(-1, 2, (n, self.n_params), generator=gen,
                             device=_gen_device(gen, device)).float()

    def sample_inputs(self, gen, shape, device=None):
        """Mixture testbench, as the reference's: 70% uniform analog levels
        in [-0.8, 0.8], 30% full-swing "digital" patterns ({-0.8, 0, 0.8}),
        chosen per (run, step). Matches the reference in distribution
        (``jax.random`` streams cannot be replayed here)."""
        dev = _gen_device(gen, device)
        full = (*shape, self.n_inputs)
        uni = _uniform(gen, full, dev, self.input_lo, self.input_hi)
        lvl = torch.randint(-1, 2, full, generator=gen, device=dev)
        dig = lvl.float() * self.input_hi
        is_dig = torch.rand((*shape, 1), generator=gen, device=dev) < 0.3
        return torch.where(is_dig, dig, uni)

    def init_state(self, n: int, device=None):
        """V_out zeros, (n, 1), on ``device`` (as :meth:`LIFNeuron.init_state`)."""
        dev = ops.resolve_device() if device is None else device
        return torch.zeros((n, 1), dtype=torch.float32, device=dev)

    def surrogate_features(self, x, params):
        """The derived interface feature, the aggregate row drive
        ``w . x + bias * v_bias`` (no ``g_unit``), summed in index order."""
        w = params[..., : self.n_inputs]
        bias = params[..., self.n_inputs]
        i_sig = row_sum(w * x) + bias * self.v_bias
        return i_sig[..., None]

    def _target(self, v_in, params):
        """DC target and output pole per row: ``(v_tgt (N,), tau (N,))``
        through ``ops.crossbar_target``."""
        return ops.crossbar_target(v_in, params, circ=self)

    def behavioral_step(self, v, v_in, params):
        """SV-RNM-style ideal update: instant settle to the DC target.
        Returns ``(v_new, output)``; no energy/latency."""
        tgt, _ = self._target(v_in, params)
        return tgt, tgt

    def step(self, state, v_in, params):
        """One clock period. state (N, 1); v_in (N, n_in); params (N, n_p).
        Returns ``(new_state (N, 1), {output, energy, latency, spiked})``."""
        return ops.crossbar_step(state, v_in, params, circ=self)


@dataclasses.dataclass(frozen=True)
class LIFNeuron:
    """Adaptive leaky-integrate-and-fire neuron (cf. Indiveri [16]).

    inputs  x in [0, 1.5] V spike amplitude, n_spk in [0,5] spikes/period,
            w in [-1, 1] synapse weight -> drive = w * x * n_spk
    params  (V_leak, V_th, V_adap, V_refrac) in [0.5, 0.8] V
    state   (V_mem, I_adap, t_refrac) — V_mem is the exposed state feature
    output  pulse amplitude in {0, 1.5} V (V_dd spike)
    """

    n_inputs: int = 3                # (w, x_amplitude, n_spikes)
    clock_ns: float = 5.0            # 200 MHz digital clock
    n_substeps: int = 64
    vdd: float = 1.5
    c_mem: float = 250e-15           # membrane cap (F)
    g_syn: float = 260e-6            # synapse transconductance (S)
    i_leak0: float = 5e-6            # leak scale (A)
    ut: float = 0.13                 # leak-knob slope (V)
    c_spike: float = 900e-15         # switched cap per spike (F)
    g_static: float = 0.8e-6         # static bias path (S)

    @property
    def n_params(self) -> int:
        return 4

    def sample_params(self, gen, n, device=None):
        """Knobs (V_leak, V_th, V_adap, V_refrac) uniform in [0.5, 0.8],
        (n, 4), drawn from ``gen`` (a ``torch.Generator`` on ``device``)."""
        return _uniform(gen, (n, 4), _gen_device(gen, device), 0.5, 0.8)

    def sample_inputs(self, gen, shape, device=None):
        """Mixture testbench, as the reference's: 70% independent (w, x, n)
        draws (w in [-1, 1], x in [0, 1.5], n in {0..5}), 30% aggregated
        drives (signed w, x = V_dd, n = 5), chosen per (run, step).
        Matches the reference in distribution."""
        dev = _gen_device(gen, device)
        w = _uniform(gen, shape, dev, -1.0, 1.0)
        x = _uniform(gen, shape, dev, 0.0, 1.5)
        n = torch.randint(0, 6, shape, generator=gen, device=dev).float()
        uni = torch.stack([w, x, n], dim=-1)
        w_agg = _uniform(gen, shape, dev, -1.0, 1.0)
        agg = torch.stack([w_agg, torch.full_like(w_agg, 1.5),
                           torch.full_like(w_agg, 5.0)], dim=-1)
        is_agg = torch.rand((*shape, 1), generator=gen, device=dev) < 0.3
        return torch.where(is_agg, agg, uni)

    def init_state(self, n: int, device=None):
        """(V_mem, I_adap, t_ref) zeros on ``device`` (default: the port's
        default device; a given device is used as it is, so the engine's
        per-run carry costs no device query)."""
        dev = ops.resolve_device() if device is None else device
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def surrogate_features(self, x, params):
        """The derived interface feature w * x_amp * n_spikes / 5."""
        drive = ops.div(x[..., 0] * x[..., 1] * x[..., 2], 5.0)
        return drive[..., None]

    def behavioral_step(self, v, v_in, params):
        """SV-RNM-style ideal discrete LIF update for one clock period:
        (v_new, output in {0, V_dd}); no energy/latency."""
        thresh = 0.8 + 1.0 * (params[:, 1] - 0.5)
        leak = torch.exp(-(self.i_leak0 / self.c_mem) * torch.exp(
            ops.div(params[:, 0] - 0.5, self.ut)) * 1e-9 * self.clock_ns)
        drive = ops.div(ops.div(
            self.g_syn * v_in[:, 0] * v_in[:, 1] * v_in[:, 2], 5.0),
            self.c_mem) * self.clock_ns * 1e-9
        v_new = (v + drive) * leak
        fire = v_new >= thresh
        v_new = torch.where(fire, 0.0, torch.clamp(v_new, 0.0, self.vdd))
        out = torch.where(fire, self.vdd, 0.0)
        return v_new, out

    def step(self, state, v_in, params):
        """One clock period. state: (N,3); v_in: (N,3); params: (N,4).
        Returns ``(new_state (N, 3), {output, energy, latency, spiked})``."""
        return ops.lif_step(state, v_in, params, circ=self)


CIRCUITS = {"crossbar": CrossbarRow(), "lif": LIFNeuron()}


def get_circuit(name):
    if isinstance(name, str):
        return CIRCUITS[name]
    return name


def augment_features(circuit, feats):
    """Append ``circuit``'s derived interface features to raw feature rows
    ``(x[:n_inputs], v, tau, params[:n_params], ...)`` — the fit/predict
    feature-symmetry contract of the reference."""
    if circuit is None:
        return feats
    fn = getattr(circuit, "surrogate_features", None)
    if fn is None:
        return feats
    n_in, n_p = circuit.n_inputs, circuit.n_params
    x = feats[:, :n_in]
    p = feats[:, n_in + 2: n_in + 2 + n_p]
    return torch.cat([feats, fn(x, p)], dim=1)
