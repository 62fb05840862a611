"""Plain reference of the LASANA network simulation the benchmark checks.

A frozen, self-contained copy of what the paper's §III-IV define and the
two case studies of §V-E run: Algorithm 1 (idle catch-up, active heads,
transition heads, the masked state write-back), the LIF and crossbar
circuits' interface features, the inter-layer adapters, the 8-bit ADC,
and the surrogate heads of the ``.npz`` artifacts (standardised MLP,
linear, mean and complete-tree GBDT). It is written in plain PyTorch
fp32 and imports nothing of the program: every head evaluates on every
row, a stage's result is selected with ``where``, and the per-tick
records are summed in float64.

``matmul="tf32"`` rounds both operands of every matrix product to TF32's
10-bit mantissa first (round to nearest, ties away from zero, as the
tensor cores take fp32 operands): the control of the comparison, the
reference one precision below the configuration's fp32.
"""

from __future__ import annotations

import json

import numpy as np
import torch

# circuit constants of the artifacts' circuits (paper §V-A, §V-B)
LIF = dict(n_inputs=3, n_params=4, clock_ns=5.0, vdd=1.5, n_spk=5.0)
XBAR = dict(n_inputs=32, clock_ns=4.0, v_sat=2.0, r_f=40e3, g_unit=12e-6,
            v_bias=0.8, input_lo=-0.8, input_hi=0.8, event_eps=1e-6)
OUT_EPS = 0.02           # Algorithm 1's output-change threshold (analog)


def tf32_round(a):
    """``a`` (fp32) rounded to TF32's 10 explicit mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Matmul:
    """``a @ b`` in fp32, or with TF32-rounded operands."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown matmul precision {precision!r}")
        self.tf32 = precision == "tf32"
        # fp32 products in full fp32; TF32 only by the explicit rounding
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __call__(self, a, b):
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b


def div(a, c: float):
    """``a / c`` as a true fp32 division (not a product by 1/c); the
    divisor is filled on the device, with no copy from the host."""
    return a / a.new_full((), c)


# --- surrogate heads ------------------------------------------------------

class Heads:
    """The five predictors of one ``.npz`` surrogate artifact, read with
    numpy and evaluated in plain PyTorch."""

    def __init__(self, path: str, device, matmul: Matmul):
        with np.load(path) as z:
            meta = json.loads(bytes(z["__manifest__"].tobytes()).decode())
            self.circuit = meta["circuit"]
            self.families = dict(meta["families"])
            self.scales = {k: float(v) for k, v in meta["scales"].items()}
            self.arrays = {
                p: {k.split("/", 1)[1]: torch.as_tensor(z[k], device=device)
                    for k in z.files if k.startswith(p + "/")}
                for p in self.families}
        self.mm = matmul

    def __call__(self, pname: str, x, block: int = 1 << 19):
        """Head ``pname`` on augmented feature rows ``x`` (N, F), in
        physical units, ``block`` rows at a time."""
        fam = self.families[pname]
        a = self.arrays[pname]
        fn = {"mlp": self._mlp, "linear": self._linear, "mean": self._mean,
              "gbdt": self._gbdt}[fam]
        out = torch.cat([fn(a, x[i:i + block])
                         for i in range(0, x.shape[0], block)]) \
            if x.shape[0] else x.new_zeros((0,))
        return div(out, self.scales[pname])

    def _mlp(self, a, x):
        h = (x - a["x_mu"]) / a["x_sd"]
        n = sum(1 for k in a if k.startswith("w"))
        for i in range(n):
            h = self.mm(h, a[f"w{i}"]) + a[f"b{i}"]
            if i < n - 1:
                h = torch.relu(h)
        return h[:, 0] * a["y_sd"][0] + a["y_mu"][0]

    def _linear(self, a, x):
        xs = (x - a["mu"]) / a["sd"]
        return self.mm(xs, a["w"][:-1, None])[:, 0] + a["w"][-1]

    def _mean(self, a, x):
        return a["mu"].reshape(()).expand(x.shape[0]).clone()

    def _gbdt(self, a, x):
        feat, thr, leaf = a["feat"].long(), a["thr"], a["leaf"]
        depth = int(round(np.log2(feat.shape[1] + 1)))
        trees = torch.arange(feat.shape[0], device=x.device)[None, :]
        node = torch.zeros((x.shape[0], feat.shape[0]), dtype=torch.long,
                           device=x.device)
        for _ in range(depth):
            xv = torch.gather(x, 1, feat[trees, node])
            node = 2 * node + 1 + (xv > thr[trees, node]).long()
        return a["base"] + leaf[trees, node - (2 ** depth - 1)].sum(-1)


# --- Algorithm 1 ----------------------------------------------------------

def _augment(circuit: str, raw):
    """Raw rows ``(x, v, tau, params[, o_prev, o_new])`` plus the circuit's
    derived interface feature, appended last."""
    if circuit == "lif":
        x = raw[:, :3]
        d = div(x[:, 0] * x[:, 1] * x[:, 2], 5.0)
    else:
        n = XBAR["n_inputs"]
        w, bias = raw[:, n + 2:2 * n + 2], raw[:, 2 * n + 2]
        d = (w * raw[:, :n]).sum(1) + bias * XBAR["v_bias"]
    return torch.cat([raw, d[:, None]], dim=1)


def algorithm1(heads: Heads, state: dict, changed, x, t: float,
               clock: float, spiking: bool, vdd: float = 1.5):
    """One tick of Algorithm 1 for N circuits. ``state`` holds v, o,
    t_last (N,) and params (N, n_p); returns the new state, energy (N,),
    latency (N,), whether each row was stale and whether its output
    changed."""
    v, o, t_last, p = state["v"], state["o"], state["t_last"], state["p"]
    c = heads.circuit
    n = v.shape[0]
    # lines 3-9: one merged idle event catches a stale circuit up
    stale = changed & (t_last < t - clock)
    tau_idle = torch.clamp_min(t - t_last - clock, 0.0)
    idle = _augment(c, torch.cat([torch.zeros_like(x), v[:, None],
                                  tau_idle[:, None], p], dim=1))
    v_cur = torch.where(stale, heads("M_V", idle), v)
    e = torch.where(stale, heads("M_ES", idle), 0.0)
    # lines 10-22: the active heads on the caught-up state
    raw = torch.cat([x, v_cur[:, None], v.new_full((n, 1), clock), p], dim=1)
    act = _augment(c, raw)
    o_hat, v_new, e_s = heads("M_O", act), heads("M_V", act), \
        heads("M_ES", act)
    if spiking:
        out_changed = o_hat > 0.5 * vdd
        o_res = torch.where(out_changed, vdd, 0.0)
    else:
        out_changed = torch.abs(o_hat - o) > OUT_EPS
        o_res = o_hat
    # lines 23-29: the transition heads see the previous and new outputs
    tr = _augment(c, torch.cat([raw, o[:, None], o_res[:, None]], dim=1))
    e_d, lat = heads("M_ED", tr), heads("M_L", tr)
    e = e + torch.where(changed, torch.where(out_changed, e_d, e_s), 0.0)
    lat = torch.where(changed & out_changed, lat, 0.0)
    new = {"v": torch.where(changed, v_new, v_cur),
           "o": torch.where(changed, o_res, o),
           "t_last": torch.where(changed, t_last.new_full((), t), t_last),
           "p": p}
    return new, e, lat, stale, changed & out_changed


def idle_flush(heads: Heads, state: dict, t_end: float):
    """Static energy of each circuit's trailing idle span to ``t_end``."""
    v, p = state["v"], state["p"]
    tau = t_end - state["t_last"]
    n_in = LIF["n_inputs"] if heads.circuit == "lif" else XBAR["n_inputs"]
    feats = _augment(heads.circuit, torch.cat(
        [v.new_zeros((v.shape[0], n_in)), v[:, None], tau[:, None], p], 1))
    return torch.where(tau > 0, heads("M_ES", feats), 0.0)


# --- networks -------------------------------------------------------------

class _Records:
    """Per-tick records, float64 sums on the device, fetched once."""

    def __init__(self):
        self.cols = {k: [] for k in ("energy", "latency", "events",
                                     "changed", "stale", "out_changed")}

    def add(self, layer_rows):
        for k in self.cols:
            self.cols[k].append(torch.stack([r[k] for r in layer_rows]))

    def host(self) -> dict:
        return {k: torch.stack(v).cpu().numpy() for k, v in self.cols.items()}


def _layer_row(e, lat, changed, stale, out_changed):
    return {"energy": e.double().sum(), "latency": lat.max(),
            "events": changed.sum(), "changed": changed.sum(),
            "stale": stale.sum(), "out_changed": out_changed.sum()}


class SNN:
    """Feed-forward SNN of LIF banks: weights[i] (fan_in, n_out), one knob
    set per layer. Call :meth:`start` for a batch, then :meth:`advance`
    over consecutive tick blocks, then :meth:`flush`."""

    def __init__(self, weights, knobs, heads: Heads, device,
                 matmul: Matmul):
        f32 = dict(dtype=torch.float32, device=device)
        self.w = [torch.as_tensor(np.asarray(w, np.float32), **f32)
                  for w in weights]
        self.conn = [(torch.abs(w) > 0).float() for w in self.w]
        self.knobs = [torch.as_tensor(np.asarray(k, np.float32), **f32)
                      for k in knobs]
        self.heads, self.mm, self.device = heads, matmul, device
        self.amp = LIF["vdd"]

    def start(self, batch: int):
        self.b, self.k = batch, 0
        self.state = []
        for w, kn in zip(self.w, self.knobs):
            n = batch * w.shape[1]
            z = torch.zeros(n, dtype=torch.float32, device=self.device)
            self.state.append({"v": z, "o": z.clone(), "t_last": z.clone(),
                               "p": kn[None].expand(n, -1).contiguous()})

    def advance(self, x, keep_hidden: bool = True) -> dict:
        """Ticks ``x`` (T, B, fan_in) of V_dd spikes: every layer's
        published spikes as fired / not fired (T, B, n_i) when
        ``keep_hidden`` (else the last layer's) and the per-tick records
        (T, L)."""
        amp, clock = self.amp, LIF["clock_ns"]
        recs, spikes = _Records(), [[] for _ in self.w]
        for xk in x:
            u, rows = xk, []
            t = float(np.float32(np.float32(self.k) + np.float32(1.0))
                      * np.float32(clock))
            for i, (w, conn) in enumerate(zip(self.w, self.conn)):
                drive = div(self.mm(u, w), amp)
                pre = (torch.abs(u) > 0.5 * amp).float()
                changed = (pre @ conn > 0.5).reshape(-1)
                xin = torch.stack([torch.clamp(drive, -1.0, 1.0),
                                   torch.full_like(drive, amp),
                                   torch.full_like(drive, LIF["n_spk"])],
                                  dim=-1).reshape(-1, 3)
                self.state[i], e, lat, stale, oc = algorithm1(
                    self.heads, self.state[i], changed, xin, t, clock,
                    spiking=True, vdd=amp)
                u = torch.where(changed, self.state[i]["o"], 0.0
                                ).reshape(self.b, -1)
                rows.append(_layer_row(e, lat, changed, stale, oc))
                if keep_hidden or i == len(self.w) - 1:
                    spikes[i].append(u > 0.5 * amp)
            recs.add(rows)
            self.k += 1
        out = recs.host()
        out["spikes"] = [torch.stack(s).cpu().numpy() if s else None
                         for s in spikes]
        return out

    def flush(self) -> np.ndarray:
        """(L,) trailing idle static energy at the end of the run."""
        t_end = float(np.float32(self.k * LIF["clock_ns"]))
        return np.array([idle_flush(self.heads, s, t_end).double().sum()
                         .item() for s in self.state])


def row_segments(w, seg: int) -> np.ndarray:
    """(fan_in, n_out) ternary matrix -> (n_out * n_seg, seg + 1) row
    params, output-major; the last column is the (unused) bias row."""
    n_in, n_out = w.shape
    n_seg = -(-n_in // seg)
    wp = np.pad(np.asarray(w, np.float32), ((0, n_seg * seg - n_in), (0, 0)))
    rows = wp.reshape(n_seg, seg, n_out).transpose(2, 0, 1).reshape(-1, seg)
    return np.concatenate([rows, np.zeros((len(rows), 1), np.float32)], 1)


class Crossbar:
    """Ternary MLP tiled onto 32-input crossbar rows behind an 8-bit ADC,
    tanh between layers, one combinational wave (one tick)."""

    def __init__(self, weights, heads: Heads, device, matmul: Matmul,
                 adc_bits: int = 8):
        self.w = [np.asarray(w, np.float32) for w in weights]
        self.heads, self.mm, self.device = heads, matmul, device
        self.levels = float(2 ** adc_bits - 1)
        seg = XBAR["n_inputs"]
        self.segs = [torch.as_tensor(row_segments(w, seg), device=device)
                     for w in self.w]

    def wave(self, volts, forced=None, block: int = 2048) -> dict:
        """DAC volts (B, fan_in) -> the last layer's outputs (B, n_out)
        in gain-compensated weight-sum units, every layer's outputs, and
        the (1, L) records; ``block`` images at a time. ``forced`` (a
        list of each layer's (B, n_i) outputs from elsewhere) drives each
        layer after the first from the given outputs of the layer before
        it, in place of this reference's own."""
        outs, parts = [], []
        for a in range(0, volts.shape[0], block):
            fb = None if forced is None else [
                torch.as_tensor(np.asarray(f[a:a + block], np.float32),
                                device=volts.device) for f in forced]
            y, layers, rows = self._wave(volts[a:a + block], fb)
            outs.append(y)
            parts.append((layers, rows))
        n_layers = len(self.w)
        rec = {}
        for k in ("energy", "latency", "events", "changed", "stale",
                  "out_changed"):
            vals = [torch.stack([r[i][k] for r in (p[1] for p in parts)])
                    for i in range(n_layers)]
            red = (lambda v: v.max()) if k == "latency" else \
                (lambda v: v.sum())
            rec[k] = torch.stack([red(v) for v in vals])[None].cpu().numpy()
        rec["outputs"] = torch.cat(outs).cpu().numpy()
        rec["layers"] = [torch.cat([p[0][i] for p in parts]).cpu().numpy()
                         for i in range(n_layers)]
        return rec

    def _wave(self, x, forced=None):
        c = XBAR
        seg, clock = c["n_inputs"], c["clock_ns"]
        gain = -c["r_f"] * c["g_unit"]
        cur, layers, rows = x, [], []
        for i, (w, segs) in enumerate(zip(self.w, self.segs)):
            if i:
                if forced is not None:
                    cur = forced[i - 1]
                cur = torch.tanh(cur) * c["input_hi"]
            xv = torch.clamp(cur, c["input_lo"], c["input_hi"])
            b = xv.shape[0]
            n_in, n_out = w.shape
            n_seg = -(-n_in // seg)
            xs = torch.nn.functional.pad(xv, (0, n_seg * seg - n_in)) \
                .reshape(b, 1, n_seg, seg)
            xin = xs.expand(b, n_out, n_seg, seg).reshape(-1, seg)
            changed = (torch.abs(xs) > c["event_eps"]).any(-1).expand(
                b, n_out, n_seg).reshape(-1)
            n = xin.shape[0]
            z = torch.zeros(n, device=x.device)
            state = {"v": z, "o": z.clone(), "t_last": z.clone(),
                     "p": segs[None].expand(b, -1, -1).reshape(n, -1)}
            state, e, lat, stale, oc = algorithm1(
                self.heads, state, changed, xin, clock, clock, spiking=False)
            v = state["o"]
            code = torch.round(div(v + c["v_sat"], 2 * c["v_sat"])
                               * self.levels)
            v_adc = div(code, self.levels) * 2 * c["v_sat"] - c["v_sat"]
            cur = div(v_adc.reshape(b, n_out, n_seg).sum(-1), gain)
            layers.append(cur)
            rows.append(_layer_row(e, lat, changed, stale, oc))
        return cur, layers, rows
