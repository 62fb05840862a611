"""Golden transient circuit models — the SPICE stand-in (LIF subset).

Port of ``repro.core.circuits``: the same physical constants and the same
fp32 arithmetic in the same order. ``LIFNeuron.step`` integrates one
digital clock period through ``ops.lif_step`` — the hand-written CUDA
kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor.
``CrossbarRow`` comes with the crossbar slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


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


CIRCUITS = {"lif": LIFNeuron()}


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
