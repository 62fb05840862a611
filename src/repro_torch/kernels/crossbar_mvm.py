"""Golden crossbar rows: the differential-pair MVM with TIA saturation, and
the fused clock period that settles each row's output toward it.

:func:`target_plain` is the transcription of the reference's
``CrossbarRow._target`` (the math of its ``kernels/crossbar_mvm.py``
``crossbar_target``) and :func:`step_plain` of ``CrossbarRow.step``: the
64-substep settling loop with capacitor and resistive energy and the 90%
settling marker. Both sum each row in index order (``circuits.row_sum``),
as the reference's XLA reductions do. :func:`crossbar_target` and
:func:`crossbar_step` run them on CPU tensors and launch the two entry
points of ``csrc/crossbar_step.cu`` — a persistent grid walking row tiles
(:func:`plan`), one thread a row — on CUDA tensors; every launch counts as
one ``crossbar_target``. :func:`work` reckons a call's operations and
bytes from its shapes; in ``ops.dry_run`` both entry points take meta
tensors and record it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.circuits import CrossbarRow, row_sum
from repro_torch.kernels import _build, ops

MAX_IN = 32         # csrc/crossbar_step.cu kMaxIn: inputs per row
TILE_ROWS = 128     # csrc/crossbar_step.cu kMaxTile: rows per tile
SMALL_TILE_ROWS = 32
# resident blocks an SM holds at 128-row tiles (35 KB of shared memory each)
BLOCKS_PER_SM = 6
ALIGN = 16          # bytes: v and w arrive by 16-byte asynchronous copies


# one crossbar row (crossbar_step.cu): target 4 per input + 8, resistive
# power 6 per input, one exp and a division; each substep 14 (update 3,
# capacitor power 5, energy 4, settle test 2)
FLOPS_PER_INPUT = 10
FLOPS_SETUP = 20
FLOPS_PER_SUBSTEP = 14


def work(n: int, n_in: int, n_substeps: int, fused: bool = True) -> ops.Work:
    """``n`` rows of ``n_in`` inputs: the fused period (``crossbar_step``)
    or the target alone (``crossbar_target``), unfused fp32 operations;
    bytes of v, w (and the state) read and of the outputs written."""
    if fused:
        return ops.Work(
            n * (FLOPS_SETUP + n_in * FLOPS_PER_INPUT
                 + n_substeps * FLOPS_PER_SUBSTEP),
            n * (n_in + n_in + 1 + 1) * 4 + n * (3 * 4 + 1), "fp32_unfused")
    return ops.Work(n * (4 * n_in + 8), n * (n_in + n_in + 1) * 4 + n * 8,
                    "fp32_unfused")


def _dry(circ, v, fused, state=None):
    """The dry-run route: meta outputs of the kernel's shapes, its work
    recorded, nothing launched."""
    n, n_in = v.shape
    ops.record_work("crossbar_target", work(n, n_in, circ.n_substeps, fused))
    f32 = dict(dtype=torch.float32, device="meta")
    if not fused:
        return torch.empty(n, **f32), torch.empty(n, **f32)
    new_state = torch.empty_like(state, device="meta")
    return (new_state, new_state[:, 0], torch.empty(n, **f32),
            torch.empty(n, **f32), torch.empty(n, dtype=torch.bool,
                                               device="meta"))


def target_plain(circ: CrossbarRow, v, w):
    """``(v_tgt, tau)`` for rows ``v`` (N, n_in), ``w`` (N, n_in + 1)."""
    n = circ.n_inputs
    wr = w[:, :n]
    bias = w[:, n]
    i_sig = circ.g_unit * (row_sum(wr * v) + bias * circ.v_bias)
    v_lin = -circ.r_f * i_sig
    # weight-dependent pole: heavier rows are slower (more BL capacitance)
    load = ops.div(row_sum(torch.abs(wr)), float(n))
    tau = circ.tau_base_ns * (1.0 + 0.5 * load)
    return circ.v_sat * torch.tanh(ops.div(v_lin, circ.v_sat)), tau


def step_plain(circ: CrossbarRow, state, v_in, params):
    """One clock period: ``(new_state (N, 1), output, energy, latency,
    spiked)``; the per-row constants (target, decay, resistive power) are
    hoisted out of the substep loop."""
    v_out0 = state[:, 0]
    v_tgt, tau = target_plain(circ, v_in, params)
    dt = circ.clock_ns / circ.n_substeps
    w = params[:, :circ.n_inputs]
    # resistive power: signal path + parasitic leak (W)
    g_row = torch.abs(w) * circ.g_unit + circ.g_leak
    p_res = row_sum(torch.square(v_in) * g_row)
    a = torch.exp(tau.new_full((), -dt) / tau)
    v = v_out0
    energy = torch.zeros_like(v_out0)
    t90 = torch.full_like(v_out0, -1.0)
    band = 0.1 * torch.abs(v_tgt - v_out0) + 1e-6
    for i in range(circ.n_substeps):
        v_new = v_tgt + (v - v_tgt) * a
        # capacitor charging power + resistive
        p_cap = ops.div(circ.c_load * torch.abs(v_new - v),
                        dt * 1e-9) * torch.abs(v_new)
        energy = energy + (p_cap + p_res) * dt * 1e-9
        # 90% settling marker (first substep within 10% of the swing)
        settled = torch.abs(v_new - v_tgt) <= band
        t90 = torch.where((t90 < 0) & settled, (i + 1) * dt, t90)
        v = v_new
    latency = torch.where(t90 < 0, circ.clock_ns, t90)
    spiked = torch.abs(v - v_out0) > 0.02
    return v[:, None], v, energy, latency, spiked


def plan(n: int, sms: int) -> tuple[int, int]:
    """``(tile_rows, grid)`` of a launch over ``n`` rows on a card of
    ``sms`` SMs. Tiles are 128 rows when there are enough of them to give
    every SM one (large N: the bytes bound), else 32 (one warp a tile, so
    that small N spreads over every SM's warp schedulers). The grid is
    persistent: at most BLOCKS_PER_SM blocks of 128 rows an SM (as many
    warps in 32-row blocks), block ``b`` walking tiles ``b``, ``b + grid``,
    ..."""
    tile_rows = TILE_ROWS if n >= TILE_ROWS * sms else SMALL_TILE_ROWS
    n_tiles = -(-n // tile_rows)
    slots = sms * BLOCKS_PER_SM * (TILE_ROWS // tile_rows)
    return tile_rows, max(1, min(n_tiles, slots))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# csrc/crossbar_step.cu: the tensors' pointers, then (n, n_in, tile_rows,
# grid, device), the XbarConsts pointer and the stream
TARGET_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_void_p])
STEP_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p, ctypes.c_void_p])


@functools.cache
def _kernels():
    lib = _build.library("crossbar_step")
    tgt = lib.crossbar_target_launch
    tgt.restype = ctypes.c_int
    tgt.argtypes = TARGET_ARGTYPES
    step = lib.crossbar_step_launch
    step.restype = ctypes.c_int
    step.argtypes = STEP_ARGTYPES
    return lib, tgt, step


class _XbarConsts(ctypes.Structure):
    """csrc/crossbar_step.cu XbarConsts, field for field (all 4 bytes)."""

    _fields_ = [("n_substeps", ctypes.c_int), ("g_unit", ctypes.c_float),
                ("g_leak", ctypes.c_float), ("neg_r_f", ctypes.c_float),
                ("v_sat", ctypes.c_float), ("c_load", ctypes.c_float),
                ("tau_base", ctypes.c_float), ("v_bias", ctypes.c_float),
                ("neg_dt", ctypes.c_float), ("dt", ctypes.c_float),
                ("dt_s", ctypes.c_float), ("clock_ns", ctypes.c_float)]


def _consts(circ: CrossbarRow) -> _XbarConsts:
    dt = circ.clock_ns / circ.n_substeps
    return _XbarConsts(
        n_substeps=circ.n_substeps, g_unit=circ.g_unit, g_leak=circ.g_leak,
        neg_r_f=-circ.r_f, v_sat=circ.v_sat, c_load=circ.c_load,
        tau_base=circ.tau_base_ns, v_bias=circ.v_bias, neg_dt=-dt, dt=dt,
        dt_s=dt * 1e-9, clock_ns=circ.clock_ns)


def _check_rows(circ: CrossbarRow, v, w):
    n_in = circ.n_inputs
    if n_in > MAX_IN:
        raise ValueError(f"crossbar_target kernel takes n_in <= {MAX_IN}, "
                         f"got {n_in}")
    n = v.shape[0]
    ops.check(v, "v", (n, n_in))
    ops.check(w, "w", (n, n_in + 1))
    for t, name in ((v, "v"), (w, "w")):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: the crossbar kernels take a "
                             f"{ALIGN}-byte-aligned tensor, got one at "
                             f"{t.data_ptr() % ALIGN} bytes past a boundary")
    return n, n_in


def _launch_target(circ, v, w):
    dev = ops.same_cuda_device(v, w)
    n, n_in = _check_rows(circ, v, w)
    v_tgt = torch.empty(n, dtype=torch.float32, device=dev)
    tau = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        lib, fn, _ = _kernels()
        consts = _consts(circ)
        index = dev.index or 0
        code = fn(v.data_ptr(), w.data_ptr(), v_tgt.data_ptr(),
                  tau.data_ptr(), n, n_in, *plan(n, _sms(index)),
                  index, ctypes.addressof(consts),
                  torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on_error(lib, code, "crossbar_target")
        ops.count_launch("crossbar_target")
    return v_tgt, tau


def _launch_step(circ, state, v_in, params):
    dev = ops.same_cuda_device(state, v_in, params)
    n, n_in = _check_rows(circ, v_in, params)
    ops.check(state, "state", (n, 1))
    new_state = torch.empty_like(state)
    energy, latency = (torch.empty(n, dtype=torch.float32, device=dev)
                       for _ in range(2))
    spiked = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        lib, _, fn = _kernels()
        consts = _consts(circ)
        index = dev.index or 0
        code = fn(state.data_ptr(), v_in.data_ptr(), params.data_ptr(),
                  new_state.data_ptr(), energy.data_ptr(),
                  latency.data_ptr(), spiked.data_ptr(), n, n_in,
                  *plan(n, _sms(index)), index,
                  ctypes.addressof(consts),
                  torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on_error(lib, code, "crossbar_target")
        ops.count_launch("crossbar_target")
    return new_state, new_state[:, 0], energy, latency, spiked


def crossbar_target(v, w, *, circ: CrossbarRow | None = None):
    """v (N, n_in) volts, w (N, n_in + 1) row weights and bias -> (v_tgt
    (N,), tau (N,) ns)."""
    circ = circ or CrossbarRow()
    if ops.dry_route(v, w):
        return _dry(circ, v, False)
    if v.device.type == "cpu" and w.device.type == "cpu":
        return target_plain(circ, v, w)
    return _launch_target(circ, v, w)


def crossbar_step(state, v_in, params, *, circ: CrossbarRow | None = None):
    """One clock period for N rows. state (N, 1), v_in (N, n_in), params
    (N, n_in + 1) -> ``(new_state, {"output", "energy", "latency",
    "spiked"})``."""
    circ = circ or CrossbarRow()
    if ops.dry_route(state, v_in, params):
        res = _dry(circ, v_in, True, state)
    elif all(t.device.type == "cpu" for t in (state, v_in, params)):
        res = step_plain(circ, state, v_in, params)
    else:
        res = _launch_step(circ, state, v_in, params)
    new_state, out, energy, latency, spiked = res
    return new_state, {"output": out, "energy": energy, "latency": latency,
                       "spiked": spiked}
