"""Golden LIF transient integrator — the "SPICE farm" hot loop.

``_period_math`` is the plain PyTorch version: the transcription of the
reference's ``kernels/lif_scan.py:_period_math`` (itself the same math as
``circuits.LIFNeuron.step``), with the per-neuron constants hoisted out
of the 64-substep loop. :func:`lif_step` runs it on CPU tensors and
launches ``csrc/lif_step.cu`` — one thread per neuron, the substep loop
compiled in and unrolled — on CUDA tensors. :func:`lif_chunk` is the
time-looped variant: T periods in one launch, the state resident across the chunk; its plain
version chains :func:`_period_math` T times, and the kernel calls the same
device function as ``lif_step``, so both equal T ``lif_step`` calls bit
for bit. Asked with ``record_v=True``, it also returns each tick's
end-of-period ``V_mem`` (``v_seq`` (T, N), the golden simulation's
exposed state), which is ``new_state[:, 0]`` after t + 1 ``lif_step``
calls.

:func:`work` reckons a call's operations and bytes from its shapes (the
bound of ``chip_smoke.py``'s kernel line and the dry run's count); in
``ops.dry_run`` both entry points take meta tensors and record it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.circuits import LIFNeuron
from repro_torch.kernels import _build, ops


# one LIF substep (lif_step.cu loop body): update 2, clamp 2, threshold 2,
# compare 1, refractory 2, adaptation 2, first spike 1, static energy
# 2+1+3, integration energy 5, accumulate 2
FLOPS_PER_SUBSTEP = 27
FLOPS_SETUP = 25


def work(n: int, n_substeps: int, t_steps: int | None = None,
         record_v: bool = False) -> ops.Work:
    """One ``lif_step`` over ``n`` neurons (``t_steps`` None) or one
    ``lif_chunk`` of ``t_steps`` periods: unfused fp32 operations (the
    kernels are built with --fmad=false); bytes of state, inputs and
    params read and of the state and observables written (``spiked`` one
    byte), and ``v_seq`` with ``record_v``."""
    per = FLOPS_SETUP + n_substeps * FLOPS_PER_SUBSTEP
    if t_steps is None:
        return ops.Work(n * per, n * (3 + 3 + 4) * 4 + n * (3 + 3) * 4 + n,
                        "fp32_unfused")
    n_bytes = n * (3 + 4 + 3) * 4 + t_steps * n * (3 * 4 + 3 * 4 + 1)
    if record_v:
        n_bytes += t_steps * n * 4
    return ops.Work(t_steps * n * per, n_bytes, "fp32_unfused")


def _dry(name, circ, state, lead, record_v=False):
    """The dry-run route: meta outputs of the kernel's shapes, its work
    recorded, nothing launched."""
    n = state.shape[0]
    t_steps = lead[0] if lead else None
    ops.record_work(name, work(n, circ.n_substeps, t_steps, record_v))
    meta = dict(device="meta")
    outs = [torch.empty_like(state, **meta)] + [
        torch.empty((*lead, n), dtype=torch.float32, **meta)
        for _ in range(3)] + [torch.empty((*lead, n), dtype=torch.bool,
                                          **meta)]
    if record_v:
        outs.append(torch.empty((*lead, n), dtype=torch.float32, **meta))
    return tuple(outs)


def _period_math(circ: LIFNeuron, st, xx, pp):
    """Integrate ONE clock period for N neurons. Returns ``(new_state
    (N, 3), out, energy, latency, spiked)``."""
    dt = circ.clock_ns / circ.n_substeps
    v0, adap0, ref0 = st[:, 0], st[:, 1], st[:, 2]
    w, x, n_spk = xx[:, 0], xx[:, 1], xx[:, 2]
    v_leak, v_th_knob, v_adap, v_ref = pp[:, 0], pp[:, 1], pp[:, 2], pp[:, 3]

    i_in = ops.div(circ.g_syn * w * x * n_spk, 5.0)
    leak_rate = (circ.i_leak0 / circ.c_mem) * torch.exp(
        ops.div(v_leak - 0.5, circ.ut)) * 1e-9
    tau_ref_ns = 2.0 + 10.0 * (v_ref - 0.5)
    thresh = 0.8 + 1.0 * (v_th_knob - 0.5)
    adap_gain = 0.15 * (1.0 + 2.0 * (v_adap - 0.5))
    dv = ops.div(i_in, circ.c_mem) * 1e-9 * dt
    decay = torch.exp(-leak_rate * dt)
    adap_decay = torch.exp(st.new_full((), -dt / 8.0))
    e_spike = circ.c_spike * circ.vdd ** 2

    v, adap, ref = v0, adap0, ref0
    out = torch.zeros_like(v0)
    energy = torch.zeros_like(v0)
    t_spk = torch.full_like(v0, -1.0)
    for i in range(circ.n_substeps):
        in_ref = ref > 0.0
        v_new = torch.where(in_ref, 0.0, (v + dv) * decay)
        v_new = torch.clamp(v_new, 0.0, circ.vdd)
        eff_th = thresh + adap * 1.0
        fire = (v_new >= eff_th) & ~in_ref
        v_new = torch.where(fire, 0.0, v_new)
        ref = torch.where(fire, tau_ref_ns, torch.clamp_min(ref - dt, 0.0))
        adap = adap * adap_decay + torch.where(fire, adap_gain, 0.0)
        out = torch.where(fire, circ.vdd, out)
        t_now = float(np.float32(i + 1) * np.float32(dt))
        t_spk = torch.where(fire & (t_spk < 0), t_now, t_spk)
        s = v_leak + v_new * 0.3
        e_sub = circ.g_static * (s * s) * dt * 1e-9
        e_sub = e_sub + torch.abs(i_in) * torch.abs(v_new) * dt * 1e-9 * 0.5
        energy = energy + e_sub + torch.where(fire, e_spike, 0.0)
        v = v_new
    spiked = t_spk > 0
    new_state = torch.stack([v, adap, ref], dim=-1)
    latency = torch.where(spiked, t_spk, circ.clock_ns)
    return new_state, out, energy, latency, spiked


def chunk_plain(circ: LIFNeuron, state, x_seq, params, record_v=False):
    """T chained periods: ``(new_state, out, energy, latency, spiked)``,
    the last four ``(T, N)``; with ``record_v``, also ``v_seq`` (T, N),
    each period's end-of-period ``V_mem``."""
    outs = []
    for x in x_seq:
        state, *obs = _period_math(circ, state, x, params)
        outs.append((*obs, state[:, 0]) if record_v else obs)
    if not outs:
        empty = state.new_zeros((0, state.shape[0]))
        return (state, empty, empty, empty, empty.bool(),
                *((empty,) if record_v else ()))
    return (state, *(torch.stack(col) for col in zip(*outs)))


# csrc/lif_step.cu lif_step_launch / lif_chunk_launch: 8 pointers (9:
# lif_chunk's v_seq, null when not recorded), the ints (n, n_substeps,
# device / n, t_steps, n_substeps, device), the 9 floats of _consts, the
# stream
ARGTYPES = {name: [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
            + [ctypes.c_float] * 9 + [ctypes.c_void_p]
            for name, n_ptr, n_int in (("lif_step", 8, 3),
                                       ("lif_chunk", 9, 4))}


@functools.cache
def _kernel(name: str = "lif_step"):
    lib = _build.library("lif_step")
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES[name]
    return lib, fn


def _consts(circ: LIFNeuron):
    return (circ.clock_ns / circ.n_substeps, circ.clock_ns, circ.g_syn,
            circ.c_mem, circ.i_leak0 / circ.c_mem, circ.ut, circ.vdd,
            circ.g_static, circ.c_spike * circ.vdd ** 2)


def _launch(circ: LIFNeuron, state, x, params):
    dev = ops.same_cuda_device(state, x, params)
    n = state.shape[0]
    ops.check(state, "state", (n, 3))
    ops.check(x, "x", (n, 3))
    ops.check(params, "params", (n, 4))
    new_state = torch.empty_like(state)
    out, energy, latency = (torch.empty(n, dtype=torch.float32, device=dev)
                            for _ in range(3))
    spiked = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        lib, fn = _kernel()
        code = fn(state.data_ptr(), x.data_ptr(), params.data_ptr(),
                  new_state.data_ptr(), out.data_ptr(), energy.data_ptr(),
                  latency.data_ptr(), spiked.data_ptr(), n,
                  circ.n_substeps, dev.index or 0, *_consts(circ),
                  torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on_error(lib, code, "lif_step")
        ops.count_launch("lif_step")
    return new_state, out, energy, latency, spiked


def lif_step(state, x, params, *, circ: LIFNeuron | None = None):
    """One clock period for N neurons. state (N,3), x (N,3), params (N,4)
    -> ``(new_state, {"output", "energy", "latency", "spiked"})``."""
    circ = circ or LIFNeuron()
    if ops.dry_route(state, x, params):
        res = _dry("lif_step", circ, state, ())
    elif all(t.device.type == "cpu" for t in (state, x, params)):
        res = _period_math(circ, state, x, params)
    else:
        res = _launch(circ, state, x, params)
    new_state, out, energy, latency, spiked = res
    return new_state, {"output": out, "energy": energy, "latency": latency,
                       "spiked": spiked}


def _launch_chunk(circ: LIFNeuron, state, x_seq, params, record_v=False):
    dev = ops.same_cuda_device(state, x_seq, params)
    n = state.shape[0]
    t_steps = x_seq.shape[0]
    ops.check(state, "state", (n, 3))
    ops.check(x_seq, "x_seq", (t_steps, n, 3))
    ops.check(params, "params", (n, 4))
    new_state = torch.empty_like(state)
    out, energy, latency = (torch.empty((t_steps, n), dtype=torch.float32,
                                        device=dev) for _ in range(3))
    spiked = torch.empty((t_steps, n), dtype=torch.bool, device=dev)
    v_seq = (torch.empty((t_steps, n), dtype=torch.float32, device=dev)
             if record_v else None)
    if n and t_steps:
        lib, fn = _kernel("lif_chunk")
        code = fn(state.data_ptr(), x_seq.data_ptr(), params.data_ptr(),
                  new_state.data_ptr(), out.data_ptr(), energy.data_ptr(),
                  latency.data_ptr(), spiked.data_ptr(),
                  None if v_seq is None else v_seq.data_ptr(), n, t_steps,
                  circ.n_substeps, dev.index or 0, *_consts(circ),
                  torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on_error(lib, code, "lif_chunk")
        ops.count_launch("lif_chunk")
    else:
        new_state.copy_(state)
    return (new_state, out, energy, latency, spiked,
            *(() if v_seq is None else (v_seq,)))


def lif_chunk(state, x_seq, params, *, circ: LIFNeuron | None = None,
              record_v: bool = False):
    """T clock periods in one launch. state (N, 3), x_seq (T, N, 3),
    params (N, 4) -> ``(new_state, {"output", "energy", "latency",
    "spiked"})`` with (T, N) observables (``spiked`` bool); ``record_v``
    adds ``"v_seq"``, each tick's end-of-period V_mem (T, N)."""
    circ = circ or LIFNeuron()
    if ops.dry_route(state, x_seq, params):
        res = _dry("lif_chunk", circ, state, (x_seq.shape[0],), record_v)
    elif all(t.device.type == "cpu" for t in (state, x_seq, params)):
        res = chunk_plain(circ, state, x_seq, params, record_v)
    else:
        res = _launch_chunk(circ, state, x_seq, params, record_v)
    new_state, out, energy, latency, spiked = res[:5]
    obs = {"output": out, "energy": energy, "latency": latency,
           "spiked": spiked}
    if record_v:
        obs["v_seq"] = res[5]
    return new_state, obs
