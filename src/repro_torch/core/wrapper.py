"""Algorithm 1 — the ML inference wrapper (port of ``repro.core.wrapper``).

The paper's wrapper walks the set S of circuits whose input changed at
tick t; here S is a boolean mask and both the idle catch-up (lines 3-9)
and the active path (lines 10-22) are evaluated for all N circuits with
``where``-selection (lines 23-29).

:func:`lasana_step` takes one of three paths, as the reference does:

* the whole-tick megakernel (``kernels.tick_megakernel``) when the
  fused-kernel switch resolves on (the port's default) and the
  surrogate's five heads pack — ONE ``network_tick`` launch per tick;
* the fused 3-dispatch path (``Surrogate.predict_heads``: idle heads ->
  active heads -> transition heads), whose stacked MLP heads go through
  the ``mlp_surrogate_heads`` kernel when the switch is on;
* ``fused=False``: one ``Surrogate.predict`` per head.

:func:`lasana_step_reference` is the literal per-circuit numpy
transcription, the parity oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops


class LasanaState(NamedTuple):
    """Per-circuit simulator state (all (N,) or (N, k))."""

    v: torch.Tensor          # latest predicted state v'
    o: torch.Tensor          # latest output
    t_last: torch.Tensor     # latest update time t'
    params: torch.Tensor     # (N, n_p) fixed circuit parameters


def init_state(n: int, params) -> LasanaState:
    z = params.new_zeros((n,))
    return LasanaState(v=z, o=z.clone(), t_last=z.clone(), params=params)


def _features(x, v, tau, params, o_prev=None, o_new=None):
    cols = [x, v[:, None], tau[:, None], params]
    if o_prev is not None:
        cols.append(o_prev[:, None])
    if o_new is not None:
        cols.append(o_new[:, None])     # chained M_O prediction
    return torch.cat(cols, dim=1)


def _splice_transition(aug_act, f_base: int, o_prev, o_new):
    """Transition matrix as a column splice of the augmented active one:
    ``o_prev``/``o_new`` go in BEFORE the circuit's derived features."""
    return torch.cat([aug_act[:, :f_base], o_prev[:, None], o_new[:, None],
                      aug_act[:, f_base:]], dim=1)


def _resolve_output(o_hat, o_prev, *, out_eps, spiking, vdd):
    """Lines 23-25: classify the event and resolve the published output."""
    if spiking:
        out_changed = o_hat > 0.5 * vdd          # spike fired this tick
        return out_changed, torch.where(out_changed, vdd, 0.0)
    return torch.abs(o_hat - o_prev) > out_eps, o_hat


def lasana_step(surrogate, state: LasanaState, changed, x, t, clock_ns, *,
                out_eps: float = 0.02, spiking: bool = False,
                known_out=None, vdd: float = 1.5, fused: bool = True,
                fused_kernel: bool | None = None, megakernel_pack=None,
                megakernel_layout=None):
    """One digital tick for N circuits (Algorithm 1).

    surrogate  a :class:`repro_torch.core.surrogate.Surrogate`
    state      :class:`LasanaState`
    changed    (N,) bool — the set S as a mask
    x          (N, n_in) inputs applied at t
    t          this tick's time (ns): a 0-d float32 tensor on the state's
               device (the network engine's form: no host round trip), or
               a Python float
    known_out  (N,) optional — annotation mode: outputs come from an
               external behavioral model; LASANA resolves the event class
               and predicts energy/latency only
    vdd        spiking circuits: the supply a fired spike resolves to
    fused      take the stacked ``predict_heads`` path (default) instead
               of one ``predict`` per head
    fused_kernel  kernel-path override (None = ``REPRO_FUSED_KERNEL``,
               else on; see ``ops.fused_kernel_enabled``): with packable
               heads the tick is ONE ``network_tick`` launch, otherwise
               stacked MLP heads launch ``mlp_surrogate_heads``
    megakernel_pack / megakernel_layout  a pre-built
               ``tick_megakernel.pack_heads`` pack (network engines build
               one per run); derived from ``surrogate`` when None
    returns    (new_state, e (N,), l (N,), o (N,))
    """
    if fused:
        if ops.fused_kernel_enabled(fused_kernel):
            from repro_torch.kernels import tick_megakernel as mk
            pack, layout = megakernel_pack, megakernel_layout
            if pack is None:
                pack, layout = mk.pack_heads(surrogate)
            if pack is not None:
                return mk.megakernel_step(
                    pack, surrogate.manifest.circuit, state, changed, x, t,
                    clock_ns, out_eps=out_eps, spiking=spiking,
                    known_out=known_out, vdd=vdd, layout=layout)
        return _lasana_step_fused(surrogate, state, changed, x, t, clock_ns,
                                  out_eps=out_eps, spiking=spiking,
                                  known_out=known_out, vdd=vdd,
                                  fused_kernel=fused_kernel)
    return _lasana_step_percall(surrogate, state, changed, x, t, clock_ns,
                                out_eps=out_eps, spiking=spiking,
                                known_out=known_out, vdd=vdd)


def _lasana_step_fused(surrogate, state, changed, x, t, clock_ns, *,
                       out_eps, spiking, known_out, vdd, fused_kernel=None):
    """Algorithm 1 via ``Surrogate.predict_heads``: three stacked
    dispatches per tick (idle M_ES+M_V -> active M_O+M_V+M_ES ->
    transition M_ED+M_L), one in annotation mode."""
    from repro_torch.core.surrogate import _augment

    n = state.v.shape[0]
    annotate = known_out is not None
    circuit = surrogate.manifest.circuit

    # --- lines 3-9: catch up stale circuits with one merged idle event
    stale = changed & (state.t_last < t - clock_ns)
    tau_idle = torch.clamp_min(t - state.t_last - clock_ns, 0.0)
    feats_idle = _features(torch.zeros_like(x), state.v, tau_idle,
                           state.params)
    tau_act = state.v.new_full((n,), clock_ns)

    if annotate:
        v_cur = state.v            # behavioral state: never stale
        v_new = v_cur              # caller overwrites with behavioral state
        o_hat = known_out
        feats = _features(x, v_cur, tau_act, state.params)
        out_changed, o_resolved = _resolve_output(
            o_hat, state.o, out_eps=out_eps, spiking=spiking, vdd=vdd)
        aug_act = _augment(circuit, feats)
        aug_tr = _splice_transition(aug_act, feats.shape[1], state.o,
                                    o_resolved)
        r = surrogate.predict_heads(
            feats_idle=_augment(circuit, feats_idle), feats_act=aug_act,
            feats_tr=aug_tr,
            heads={"idle": ("M_ES",), "act": ("M_ES",),
                   "tr": ("M_ED", "M_L")},
            augmented=True, fused_kernel=fused_kernel)
        e_s_idle = r["idle"]["M_ES"]
        e_s, e_d, lat = r["act"]["M_ES"], r["tr"]["M_ED"], r["tr"]["M_L"]
    else:
        r1 = surrogate.predict_heads(feats_idle=feats_idle,
                                     heads={"idle": ("M_ES", "M_V")},
                                     fused_kernel=fused_kernel)
        e_s_idle = r1["idle"]["M_ES"]
        v_cur = torch.where(stale, r1["idle"]["M_V"], state.v)

        # --- lines 10-22: one stacked pass over the whole active variant
        feats = _features(x, v_cur, tau_act, state.params)
        aug_act = _augment(circuit, feats)
        r2 = surrogate.predict_heads(feats_act=aug_act,
                                     heads={"act": ("M_O", "M_V", "M_ES")},
                                     augmented=True,
                                     fused_kernel=fused_kernel)
        o_hat, v_new, e_s = (r2["act"]["M_O"], r2["act"]["M_V"],
                             r2["act"]["M_ES"])
        out_changed, o_resolved = _resolve_output(
            o_hat, state.o, out_eps=out_eps, spiking=spiking, vdd=vdd)
        aug_tr = _splice_transition(aug_act, feats.shape[1], state.o,
                                    o_resolved)
        r3 = surrogate.predict_heads(feats_tr=aug_tr,
                                     heads={"tr": ("M_ED", "M_L")},
                                     augmented=True,
                                     fused_kernel=fused_kernel)
        e_d, lat = r3["tr"]["M_ED"], r3["tr"]["M_L"]

    return _finish_tick(state, changed, stale, e_s_idle, e_d, e_s, lat,
                        out_changed, o_hat, v_cur, v_new, t,
                        spiking=spiking, vdd=vdd)


def _lasana_step_percall(surrogate, state, changed, x, t, clock_ns, *,
                         out_eps, spiking, known_out, vdd):
    """Algorithm 1 with one ``predict`` per head (the pre-fusion path)."""
    n = state.v.shape[0]
    annotate = known_out is not None

    # --- lines 3-9: catch up stale circuits with one merged idle event
    stale = changed & (state.t_last < t - clock_ns)
    tau_idle = torch.clamp_min(t - state.t_last - clock_ns, 0.0)
    feats_idle = _features(torch.zeros_like(x), state.v, tau_idle,
                           state.params)
    e_s_idle = surrogate.predict("M_ES", feats_idle)
    if annotate:
        v_cur = state.v            # behavioral state: never stale
    else:
        v_hat = surrogate.predict("M_V", feats_idle)
        v_cur = torch.where(stale, v_hat, state.v)

    # --- lines 10-22: all predictors on the active batch; M_O first so
    # its prediction chains into the transition-aware heads
    tau_act = state.v.new_full((n,), clock_ns)
    feats = _features(x, v_cur, tau_act, state.params)
    if annotate:
        o_hat = known_out
        v_new = v_cur              # caller overwrites with behavioral state
    else:
        o_hat = surrogate.predict("M_O", feats)
        v_new = surrogate.predict("M_V", feats)

    # --- lines 23-29: select dynamic vs static by output behaviour
    out_changed, o_resolved = _resolve_output(
        o_hat, state.o, out_eps=out_eps, spiking=spiking, vdd=vdd)
    feats_tr = _features(x, v_cur, tau_act, state.params, o_prev=state.o,
                         o_new=o_resolved)
    e_d = surrogate.predict("M_ED", feats_tr)
    e_s = surrogate.predict("M_ES", feats)
    lat = surrogate.predict("M_L", feats_tr)
    return _finish_tick(state, changed, stale, e_s_idle, e_d, e_s, lat,
                        out_changed, o_hat, v_cur, v_new, t,
                        spiking=spiking, vdd=vdd)


def _finish_tick(state, changed, stale, e_s_idle, e_d, e_s, lat,
                 out_changed, o_hat, v_cur, v_new, t, *, spiking, vdd):
    """Lines 23-30 tail shared by every path: select dynamic vs static
    records and write back the masked state update."""
    e = torch.where(stale, e_s_idle, 0.0)
    e_evt = torch.where(out_changed, e_d, e_s)
    l_evt = torch.where(out_changed, lat, 0.0)
    e = e + torch.where(changed, e_evt, 0.0)
    l = torch.where(changed, l_evt, 0.0)
    if spiking:
        o_out = torch.where(changed, torch.where(out_changed, vdd, 0.0),
                            state.o)
    else:
        o_out = torch.where(changed, o_hat, state.o)
    new_state = LasanaState(
        v=torch.where(changed, v_new, v_cur),
        o=o_out,
        t_last=torch.where(changed, t, state.t_last),   # line 30
        params=state.params,
    )
    return new_state, e, l, o_out


def lasana_step_reference(surrogate, state: LasanaState, changed, x, t,
                          clock_ns, *, out_eps: float = 0.02,
                          spiking: bool = False, vdd: float = 1.5):
    """Literal per-circuit transcription of Algorithm 1 (numpy, for tests).

    Returns ``(new_state, e, l, o)`` with ``e``/``l``/``o`` numpy arrays."""
    n = state.v.shape[0]
    v = state.v.cpu().numpy().copy()
    o = state.o.cpu().numpy().copy()
    t_last = state.t_last.cpu().numpy().copy()
    params = state.params.cpu().numpy()
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    changed = np.asarray(changed.cpu() if isinstance(changed, torch.Tensor)
                         else changed)
    t = float(t)
    e = np.zeros(n)
    l = np.zeros(n)

    for i in range(n):
        if not changed[i]:
            continue
        if t_last[i] < t - clock_ns:                      # lines 4-6
            tau = t - t_last[i] - clock_ns
            fi = np.concatenate([np.zeros_like(x[i]), [v[i]], [tau], params[i]])
            v[i] = float(surrogate.predict_np("M_V", fi[None])[0])
            e[i] += float(surrogate.predict_np("M_ES", fi[None])[0])
        f = np.concatenate([x[i], [v[i]], [clock_ns], params[i]])
        o_hat = float(surrogate.predict_np("M_O", f[None])[0])
        v_new = float(surrogate.predict_np("M_V", f[None])[0])
        if spiking:
            changed_out = o_hat > 0.5 * vdd
            o_res = vdd if changed_out else 0.0
        else:
            changed_out = abs(o_hat - o[i]) > out_eps
            o_res = o_hat
        fp = np.concatenate([x[i], [v[i]], [clock_ns], params[i], [o[i]],
                             [o_res]])
        e_d = float(surrogate.predict_np("M_ED", fp[None])[0])
        e_s = float(surrogate.predict_np("M_ES", f[None])[0])
        lat = float(surrogate.predict_np("M_L", fp[None])[0])
        if changed_out:                                    # lines 24-27
            e[i] += e_d
            l[i] = lat
        else:
            e[i] += e_s
        v[i] = v_new
        if spiking:
            o[i] = vdd if changed_out else 0.0
        else:
            o[i] = o_hat
        t_last[i] = t
    f32 = torch.float32
    new_state = LasanaState(v=torch.as_tensor(v, dtype=f32),
                            o=torch.as_tensor(o, dtype=f32),
                            t_last=torch.as_tensor(t_last, dtype=f32),
                            params=state.params)
    return new_state, e, l, new_state.o.numpy()
